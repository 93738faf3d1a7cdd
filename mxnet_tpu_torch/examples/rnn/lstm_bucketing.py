"""LSTM language model with bucketing (the port's copy of
``examples/rnn/lstm_bucketing.py``; reference
example/rnn/bucketing/lstm_bucketing.py): ``BucketingModule.fit`` over
``BucketSentenceIter``, an embedding, a stack of LSTM cells unrolled per
bucket, a softmax over the vocabulary, Adam, ``Perplexity`` and
``Speedometer``.

Without ``--data-train`` it trains on a synthetic corpus of Zipfian
unigrams with bigram structure, which the model can learn.  The options of
the JAX example are kept, with one more: ``--ctx cpu`` runs on the CPU (the
default is the card, which it needs otherwise).  ``chip_smoke.py``'s
``lstm_bucketing`` phase runs this model at the reference's PTB width, with
both ``lstm_stack``s, through ``make_sym_gen``::

    python -m mxnet_tpu_torch.examples.rnn.lstm_bucketing --ctx cpu
    python -m mxnet_tpu_torch.examples.rnn.lstm_bucketing --num-epochs 1
"""
from __future__ import annotations

import argparse
import contextlib
import logging
import os

import numpy as np

import mxnet_tpu_torch as mx


def make_parser():
    p = argparse.ArgumentParser(description="Train an LSTM LM with bucketing",
                                formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--data-train", type=str, default=None,
                   help="PTB-style text file; synthetic corpus when absent")
    p.add_argument("--num-layers", type=int, default=2)
    p.add_argument("--num-hidden", type=int, default=128)
    p.add_argument("--num-embed", type=int, default=64)
    p.add_argument("--kv-store", type=str, default="device")
    p.add_argument("--num-epochs", type=int, default=5)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--optimizer", type=str, default="adam")
    p.add_argument("--mom", type=float, default=0.0)
    p.add_argument("--wd", type=float, default=0.00001)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--disp-batches", type=int, default=50)
    p.add_argument("--num-sentences", type=int, default=2000,
                   help="synthetic corpus size")
    p.add_argument("--ctx", choices=("gpu", "cpu"), default="gpu")
    return p


def tokenize_text(fname, vocab=None, invalid_label=-1, start_label=0):
    if not os.path.isfile(fname):
        raise IOError("file %s not found (pass a local PTB-format file or omit "
                      "--data-train)" % fname)
    with open(fname) as f:
        lines = [list(filter(None, line.split(" "))) for line in f]
    return mx.rnn.encode_sentences(lines, vocab=vocab, invalid_label=invalid_label,
                                   start_label=start_label)


def synthetic_corpus(n, vocab_size=60, seed=0):
    """Zipfian unigrams + deterministic bigram successor structure."""
    rng = np.random.RandomState(seed)
    succ = rng.randint(1, vocab_size, size=vocab_size)
    sents = []
    for _ in range(n):
        length = rng.randint(4, 24)
        w = rng.zipf(1.5) % vocab_size or 1
        sent = [int(w)]
        for _ in range(length - 1):
            w = succ[w] if rng.rand() < 0.8 else (rng.zipf(1.5) % vocab_size or 1)
            sent.append(int(w))
        sents.append(sent)
    return sents, vocab_size


def lstm_stack(num_layers, num_hidden, fused=False):
    """The example's ``SequentialRNNCell`` of ``LSTMCell``s named
    ``lstm_l<i>_``, or one ``FusedRNNCell`` of the same layers (prefix
    ``lstm_``, whose ``unfuse()`` is that stack)."""
    if fused:
        return mx.rnn.FusedRNNCell(num_hidden, num_layers=num_layers, mode="lstm",
                                   prefix="lstm_")
    stack = mx.rnn.SequentialRNNCell()
    for i in range(num_layers):
        stack.add(mx.rnn.LSTMCell(num_hidden=num_hidden, prefix="lstm_l%d_" % i))
    return stack


def make_sym_gen(stack, vocab_size, num_embed, num_hidden):
    """-> ``sym_gen(seq_len) -> (symbol, data names, label names)`` of the
    example's model over ``stack``."""
    sym = mx.sym

    def sym_gen(seq_len):
        data = sym.Variable("data")
        label = sym.Variable("softmax_label")
        embed = sym.Embedding(data=data, input_dim=vocab_size, output_dim=num_embed,
                              name="embed")
        stack.reset()
        outputs, _ = stack.unroll(seq_len, inputs=embed, merge_outputs=True)
        pred = sym.Reshape(outputs, shape=(-1, num_hidden))
        pred = sym.FullyConnected(pred, num_hidden=vocab_size, name="pred")
        label = sym.Reshape(label, shape=(-1,))
        pred = sym.SoftmaxOutput(pred, label=label, name="softmax")
        return pred, ("data",), ("softmax_label",)

    return sym_gen


def optimizer_params(args):
    if args.optimizer in ("sgd", "nag", "signum"):
        return {"learning_rate": args.lr, "wd": args.wd, "momentum": args.mom}
    return {"learning_rate": args.lr, "wd": args.wd}


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(asctime)-15s %(message)s")
    args = make_parser().parse_args(argv)
    buckets = [10, 20, 30]
    start_label = 1
    invalid_label = 0

    if args.data_train:
        train_sent, vocab = tokenize_text(args.data_train, start_label=start_label,
                                          invalid_label=invalid_label)
        vocab_size = len(vocab) + start_label
    else:
        train_sent, vocab_size = synthetic_corpus(args.num_sentences)

    data_train = mx.rnn.BucketSentenceIter(train_sent, args.batch_size, buckets=buckets,
                                           invalid_label=invalid_label)
    stack = lstm_stack(args.num_layers, args.num_hidden)
    ctx = mx.gpu(0) if args.ctx == "gpu" else mx.cpu()
    ctx.device  # raises here without a card, unless --ctx cpu
    with mx.full_fp32() if args.ctx == "gpu" else contextlib.nullcontext():
        model = mx.mod.BucketingModule(
            sym_gen=make_sym_gen(stack, vocab_size, args.num_embed, args.num_hidden),
            default_bucket_key=data_train.default_bucket_key, context=ctx)
        model.fit(
            train_data=data_train,
            eval_metric=mx.metric.Perplexity(invalid_label),
            kvstore=args.kv_store,
            optimizer=args.optimizer,
            optimizer_params=optimizer_params(args),
            initializer=mx.init.Xavier(factor_type="in", magnitude=2.34),
            num_epoch=args.num_epochs,
            batch_end_callback=mx.callback.Speedometer(args.batch_size, args.disp_batches))
    return model


if __name__ == "__main__":
    main()

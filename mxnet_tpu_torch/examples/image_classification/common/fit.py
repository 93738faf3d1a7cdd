"""The classification examples' training harness (the port's copy of
``examples/image-classification/common/fit.py``; reference
example/image-classification/common/fit.py): the kvstore, the learning-rate
schedule, the initializer and optimizer from the command line, and
``Module.fit`` with a Speedometer and checkpoints."""
import logging
import time

import mxnet_tpu_torch as mx


def _get_lr_scheduler(args, kv):
    if "lr_factor" not in args or args.lr_factor >= 1:
        return (args.lr, None)
    epoch_size = _get_epoch_size(args, kv)
    begin_epoch = args.load_epoch if args.load_epoch else 0
    step_epochs = [int(x) for x in args.lr_step_epochs.split(",")] if args.lr_step_epochs \
        else []
    lr = args.lr
    for s in step_epochs:
        if begin_epoch >= s:
            lr *= args.lr_factor
    if lr != args.lr:
        logging.info("Adjust learning rate to %e for epoch %d", lr, begin_epoch)
    steps = [epoch_size * (x - begin_epoch) for x in step_epochs if x - begin_epoch > 0]
    if steps:
        return (lr, mx.lr_scheduler.MultiFactorScheduler(step=steps, factor=args.lr_factor))
    return (lr, None)


def _get_epoch_size(args, kv):
    return int(args.num_examples / args.batch_size / kv.num_workers)


def _load_model(args, rank=0):
    if getattr(args, "load_epoch", None) is None:
        return (None, None, None)
    if args.model_prefix is None:
        raise ValueError("--load-epoch needs --model-prefix")
    model_prefix = args.model_prefix
    if rank > 0:
        model_prefix += "-%d" % rank
    sym, arg_params, aux_params = mx.model.load_checkpoint(model_prefix, args.load_epoch)
    logging.info("Loaded model %s_%04d.params", model_prefix, args.load_epoch)
    return (sym, arg_params, aux_params)


def _save_model(args, rank=0):
    if args.model_prefix is None:
        return None
    return mx.callback.do_checkpoint(
        args.model_prefix if rank == 0 else "%s-%d" % (args.model_prefix, rank),
        period=args.save_period)


def add_fit_args(parser):
    train = parser.add_argument_group("Training", "model training")
    train.add_argument("--network", type=str, help="the neural network to use")
    train.add_argument("--num-layers", type=int, help="number of layers in the neural network")
    train.add_argument("--gpus", type=str, help="unused: one card (--ctx); kept for CLI parity")
    train.add_argument("--kv-store", type=str, default="device", help="key-value store type")
    train.add_argument("--num-epochs", type=int, default=100, help="max num of epochs")
    train.add_argument("--lr", type=float, default=0.1, help="initial learning rate")
    train.add_argument("--lr-factor", type=float, default=0.1,
                       help="the ratio to reduce lr on each step")
    train.add_argument("--lr-step-epochs", type=str,
                       help="the epochs to reduce the lr, e.g. 30,60")
    train.add_argument("--initializer", type=str, default="default",
                       help="the initializer type")
    train.add_argument("--optimizer", type=str, default="sgd", help="the optimizer type")
    train.add_argument("--mom", type=float, default=0.9, help="momentum for sgd")
    train.add_argument("--wd", type=float, default=0.0001, help="weight decay for sgd")
    train.add_argument("--batch-size", type=int, default=128, help="the batch size")
    train.add_argument("--disp-batches", type=int, default=20,
                       help="show progress for every n batches")
    train.add_argument("--model-prefix", type=str, help="model prefix")
    train.add_argument("--save-period", type=int, default=1, help="params saving period")
    train.add_argument("--load-epoch", type=int,
                       help="load the model on an epoch using the model-load-prefix")
    train.add_argument("--top-k", type=int, default=0,
                       help="report the top-k accuracy. 0 means no report.")
    train.add_argument("--dtype", type=str, default="float32",
                       help="precision: float32 or float16")
    train.add_argument("--monitor", dest="monitor", type=int, default=0,
                       help="log network parameters every N iters if larger than 0")
    train.add_argument("--test-io", type=int, default=0,
                       help="1 means test reading speed without training")
    train.add_argument("--ctx", choices=("gpu", "cpu"), default="gpu",
                       help="the device: the card, or the CPU")
    return train


def make_initializer(name):
    """The ``--initializer`` choice."""
    if name == "default":
        return mx.init.Xavier(rnd_type="gaussian", factor_type="in", magnitude=2)
    makers = {"xavier": mx.init.Xavier, "msra": mx.init.MSRAPrelu,
              "orthogonal": mx.init.Orthogonal, "normal": mx.init.Normal,
              "uniform": mx.init.Uniform, "one": mx.init.One, "zero": mx.init.Zero}
    if name not in makers:
        raise ValueError("unknown initializer %r" % name)
    return makers[name]()


def fit(args, network, data_loader, **kwargs):
    """Train ``network`` (a Symbol) on ``data_loader(args, kv)`` -> (train,
    val), as the reference's fit: args from argparse; ``arg_params`` /
    ``aux_params`` in ``kwargs`` start from those values.  Runs on the
    current context (``with mx.cpu():`` for the CPU).  Returns the Module."""
    kv = mx.kvstore.create(args.kv_store)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)-15s Node[" + str(kv.rank) + "] %(message)s")
    logging.info("start with arguments %s", args)
    if args.monitor > 0:
        raise NotImplementedError("--monitor needs mx.mon, which is not ported (ROADMAP A10)")

    (train, val) = data_loader(args, kv)

    if args.test_io:
        tic = time.time()
        for i, batch in enumerate(train):
            for j in batch.data:
                j.cpu()
            if (i + 1) % args.disp_batches == 0:
                logging.info("Batch [%d]\tSpeed: %.2f samples/sec", i,
                             args.disp_batches * args.batch_size / (time.time() - tic))
                tic = time.time()
        return None

    if "arg_params" in kwargs and "aux_params" in kwargs:
        arg_params = kwargs["arg_params"]
        aux_params = kwargs["aux_params"]
    else:
        _sym, arg_params, aux_params = _load_model(args, kv.rank)

    checkpoint = _save_model(args, kv.rank)
    lr, lr_scheduler = _get_lr_scheduler(args, kv)
    model = mx.mod.Module(symbol=network, context=mx.current_context())

    optimizer_params = {"learning_rate": lr, "wd": args.wd, "lr_scheduler": lr_scheduler}
    if args.optimizer in {"sgd", "dcasgd", "nag", "signum", "lbsgd"}:
        optimizer_params["momentum"] = args.mom
    if args.dtype == "float16":
        optimizer_params["multi_precision"] = True

    initializer = make_initializer(args.initializer)
    eval_metrics = ["accuracy"]
    if args.top_k > 0:
        eval_metrics.append(mx.metric.create("top_k_accuracy", top_k=args.top_k))
    batch_end_callbacks = [mx.callback.Speedometer(args.batch_size, args.disp_batches)]

    model.fit(train,
              begin_epoch=args.load_epoch if args.load_epoch else 0,
              num_epoch=args.num_epochs,
              eval_data=val,
              eval_metric=eval_metrics,
              kvstore=kv,
              optimizer=args.optimizer,
              optimizer_params=optimizer_params,
              initializer=initializer,
              arg_params=arg_params,
              aux_params=aux_params,
              batch_end_callback=batch_end_callbacks,
              epoch_end_callback=checkpoint,
              allow_missing=True)
    return model


def run(args, network, data_loader, **kwargs):
    """``fit`` on ``--ctx``: the card (full fp32: no TF32), or the CPU."""
    ctx = mx.gpu(0) if args.ctx == "gpu" else mx.cpu()
    ctx.device  # raises here without a card, unless --ctx cpu
    with ctx, mx.full_fp32():
        return fit(args, network, data_loader, **kwargs)

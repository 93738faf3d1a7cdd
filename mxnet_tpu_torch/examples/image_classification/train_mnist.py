"""Train on MNIST (the port's copy of
``examples/image-classification/train_mnist.py``; reference
example/image-classification/train_mnist.py): mlp or lenet over an
NDArrayIter of a local ``mnist.npz`` (``--data-path``), else of
class-conditioned Gaussian stand-ins; the JAX script's arguments, and
``--ctx cpu`` to run on the CPU::

    python -m mxnet_tpu_torch.examples.image_classification.train_mnist \\
        --network lenet --num-epochs 1 --ctx cpu
"""
import argparse
import os
from importlib import import_module

import numpy as np

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.examples.image_classification.common import fit

SYMBOLS = "mxnet_tpu_torch.examples.image_classification.symbols."


def get_mnist_iter(args, kv):
    if args.data_path and os.path.exists(args.data_path):
        with np.load(args.data_path) as f:
            x_train, y_train = f["x_train"], f["y_train"]
            x_test, y_test = f["x_test"], f["y_test"]
        x_train = x_train.reshape(-1, 1, 28, 28).astype(np.float32) / 255
        x_test = x_test.reshape(-1, 1, 28, 28).astype(np.float32) / 255
    else:  # class-conditioned gaussians, learnable
        rng = np.random.RandomState(7)
        n = args.num_examples
        y_train = rng.randint(0, 10, n)
        protos = rng.randn(10, 1, 28, 28).astype(np.float32)
        x_train = protos[y_train] + 0.3 * rng.randn(n, 1, 28, 28).astype(np.float32)
        y_test = rng.randint(0, 10, n // 5)
        x_test = protos[y_test] + 0.3 * rng.randn(n // 5, 1, 28, 28).astype(np.float32)
    train = mx.io.NDArrayIter(x_train, y_train.astype(np.float32), args.batch_size,
                              shuffle=True)
    val = mx.io.NDArrayIter(x_test, y_test.astype(np.float32), args.batch_size)
    return train, val


def make_parser():
    parser = argparse.ArgumentParser(description="train mnist",
                                     formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--num-classes", type=int, default=10)
    parser.add_argument("--num-examples", type=int, default=60000)
    parser.add_argument("--data-path", type=str, default="data/mnist.npz")
    fit.add_fit_args(parser)
    parser.set_defaults(network="mlp", batch_size=64, num_epochs=20, lr=0.05,
                        lr_step_epochs="10")
    return parser


def main(argv=None):
    args = make_parser().parse_args(argv)
    sym = import_module(SYMBOLS + args.network).get_symbol(**vars(args))
    return fit.run(args, sym, get_mnist_iter)


if __name__ == "__main__":
    main()

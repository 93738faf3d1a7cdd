"""Train on ImageNet-1K (the port's copy of
``examples/image-classification/train_imagenet.py``; reference
example/image-classification/train_imagenet.py): the JAX script's
arguments, and ``--ctx cpu`` to run on the CPU.  ``.rec`` files are ROADMAP
A11; ``--benchmark 1`` trains on synthetic batches::

    python -m mxnet_tpu_torch.examples.image_classification.train_imagenet \\
        --network alexnet --benchmark 1 --num-epochs 1
"""
import argparse
from importlib import import_module

from mxnet_tpu_torch.examples.image_classification.common import data, fit

SYMBOLS = "mxnet_tpu_torch.examples.image_classification.symbols."


def make_parser():
    parser = argparse.ArgumentParser(description="train imagenet-1k",
                                     formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    fit.add_fit_args(parser)
    data.add_data_args(parser)
    data.add_data_aug_args(parser)
    data.set_data_aug_level(parser, 3)
    parser.set_defaults(network="resnet", num_layers=50, num_classes=1000,
                        num_examples=1281167, image_shape="3,224,224", min_random_scale=1,
                        batch_size=128, num_epochs=80, lr=0.1, lr_step_epochs="30,60")
    return parser


def main(argv=None):
    args = make_parser().parse_args(argv)
    sym = import_module(SYMBOLS + args.network).get_symbol(**vars(args))
    return fit.run(args, sym, data.get_rec_iter)


if __name__ == "__main__":
    main()

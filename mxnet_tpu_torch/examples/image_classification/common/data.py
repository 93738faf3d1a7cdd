"""Data iterators of the classification examples (the port's copy of
``examples/image-classification/common/data.py``; reference
example/image-classification/common/data.py): the data arguments and the
``--benchmark 1`` synthetic batches.  ``.rec`` files need ``recordio`` /
``image``, which are ROADMAP A11."""
import numpy as np
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.io import DataBatch, DataDesc, DataIter


def add_data_args(parser):
    data = parser.add_argument_group("Data", "the input images")
    data.add_argument("--data-train", type=str, help="the training data (.rec)")
    data.add_argument("--data-val", type=str, help="the validation data (.rec)")
    data.add_argument("--rgb-mean", type=str, default="123.68,116.779,103.939",
                      help="a tuple of size 3 for the mean rgb")
    data.add_argument("--pad-size", type=int, default=0, help="padding the input image")
    data.add_argument("--image-shape", type=str,
                      help="the image shape feed into the network, e.g. (3,224,224)")
    data.add_argument("--num-classes", type=int, help="the number of classes")
    data.add_argument("--num-examples", type=int, help="the number of training examples")
    data.add_argument("--data-nthreads", type=int, default=4,
                      help="number of threads for data decoding")
    data.add_argument("--benchmark", type=int, default=0,
                      help="if 1, run synthetic random batches (no data files needed)")
    return data


def add_data_aug_args(parser):
    aug = parser.add_argument_group(
        "Image augmentations",
        "crop/mirror/pad/scale run in the data plane; rotate/shear/aspect "
        "are accepted for CLI parity")
    aug.add_argument("--random-crop", type=int, default=1,
                     help="if or not randomly crop the image")
    aug.add_argument("--random-mirror", type=int, default=1,
                     help="if or not randomly flip horizontally")
    aug.add_argument("--max-random-aspect-ratio", type=float, default=0)
    aug.add_argument("--max-random-rotate-angle", type=int, default=0)
    aug.add_argument("--max-random-shear-ratio", type=float, default=0)
    aug.add_argument("--max-random-scale", type=float, default=1)
    aug.add_argument("--min-random-scale", type=float, default=1)
    return aug


def set_data_aug_level(parser, level):
    if level >= 1:
        parser.set_defaults(random_crop=1, random_mirror=1)
    if level >= 2:
        parser.set_defaults(max_random_scale=1.25, min_random_scale=0.533)
    if level >= 3:
        parser.set_defaults(max_random_rotate_angle=10, max_random_shear_ratio=0.1,
                            max_random_aspect_ratio=0.25)


class SyntheticDataIter(DataIter):
    """``max_iter`` copies of one batch of U(−1, 1) images and random labels
    from ``RandomState(0)`` (the reference's ``--benchmark 1`` path), on the
    current context's device."""

    def __init__(self, num_classes, data_shape, max_iter, dtype="float32"):
        super().__init__(data_shape[0])
        self.batch_size = data_shape[0]
        self.cur_iter = 0
        self.max_iter = max_iter
        self.dtype = dtype
        rng = np.random.RandomState(0)
        label = rng.randint(0, num_classes, (self.batch_size,)).astype(np.float32)
        data = rng.uniform(-1, 1, data_shape).astype(dtype)
        device = mx.context.as_device()
        self.data = torch.as_tensor(data, device=device)
        self.label = torch.as_tensor(label, device=device)
        self.provide_data = [DataDesc("data", data_shape, self.data.dtype)]
        self.provide_label = [DataDesc("softmax_label", (self.batch_size,), torch.float32)]

    def next(self):
        self.cur_iter += 1
        if self.cur_iter > self.max_iter:
            raise StopIteration
        return DataBatch([self.data], [self.label], pad=0, provide_data=self.provide_data,
                         provide_label=self.provide_label)

    def __next__(self):
        return self.next()

    def reset(self):
        self.cur_iter = 0


def get_rec_iter(args, kv=None):
    """(train, val): synthetic with ``--benchmark 1``; ``.rec`` files need
    ``recordio`` / ``image``, not ported (ROADMAP A11)."""
    image_shape = tuple(int(x) for x in args.image_shape.split(","))
    if args.benchmark:
        data_shape = (args.batch_size,) + image_shape
        return SyntheticDataIter(args.num_classes, data_shape, 50, "float32"), None
    raise NotImplementedError("reading .rec files needs recordio and image (ROADMAP A11); "
                              "pass --benchmark 1 for synthetic batches")

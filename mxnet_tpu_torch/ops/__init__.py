"""Operators of the port (counterpart of ``mxnet_tpu/ops``): plain functions
on tensors, NCHW, with the JAX package's layouts at every public function.
Importing ``_load_all`` registers every ported group."""
from . import registry  # noqa: F401

from . import elemwise  # noqa: F401
from . import matrix  # noqa: F401
from . import reduce  # noqa: F401
from . import init_ops  # noqa: F401
from . import indexing  # noqa: F401
from . import nn  # noqa: F401
from . import random_ops  # noqa: F401
from . import quantization  # noqa: F401
from . import misc_ops  # noqa: F401
from . import detection  # noqa: F401
from . import rnn  # noqa: F401
from . import optimizer_ops  # noqa: F401
from . import linalg  # noqa: F401
from . import contrib_ops  # noqa: F401
from . import rcnn_targets  # noqa: F401
from . import custom  # noqa: F401

_load_all = True

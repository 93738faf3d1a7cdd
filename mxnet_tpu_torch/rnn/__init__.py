"""The symbol-based RNN API (counterpart of ``mxnet_tpu/rnn``; reference
python/mxnet/rnn): the cells, ``BucketSentenceIter`` and the checkpoint
helpers, as ``mx.rnn``."""
from .rnn_cell import *  # noqa: F401,F403
from .rnn import *  # noqa: F401,F403
from .io import *  # noqa: F401,F403

from . import rnn_cell
from . import rnn
from . import io

__all__ = rnn_cell.__all__ + rnn.__all__ + io.__all__

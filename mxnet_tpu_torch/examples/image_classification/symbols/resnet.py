"""Pre-activation ResNet (v2): the port's ``models/resnet_symbol.py``, the
copy of ``examples/image-classification/symbols/resnet.py``."""
from mxnet_tpu_torch.models.resnet_symbol import get_symbol, residual_unit, resnet  # noqa: F401

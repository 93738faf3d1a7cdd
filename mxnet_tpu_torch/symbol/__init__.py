"""``sym`` — the symbolic graph frontend of the port (counterpart of
``mxnet_tpu/symbol``).

Every op registered in ``mxnet_tpu_torch.ops.registry`` gets a builder here
(``sym.Convolution``, ``sym.BatchNorm``, ...), and every ``_contrib_<op>`` one
in ``sym.contrib`` (``sym.contrib.quantize``).  ``bind`` / ``simple_bind``
bind a graph on a device (see :mod:`mxnet_tpu_torch.executor`); ``load`` /
``load_json`` read the JSON that ``Symbol.save`` / ``tojson`` write.
"""
import sys
import types

from ..ops import detection, elemwise, matrix, nn, quantization, reduce  # noqa: F401  (register the ops)
from ..ops import registry as _registry
from .symbol import (Group, NameManager, Symbol, Variable, _make_sym_op_func, load,
                     load_json, var)

__all__ = ["Symbol", "Variable", "var", "Group", "NameManager", "load", "load_json",
           "contrib"]

_self = sys.modules[__name__]
contrib = types.ModuleType(__name__ + ".contrib")
contrib.__doc__ = "Contrib operators as Symbol builders (``_contrib_<op>``)."
for _name in _registry.list_ops():
    _f = _make_sym_op_func(_registry.get(_name), _name)
    if not hasattr(_self, _name):
        setattr(_self, _name, _f)
    if _name.startswith("_contrib_"):
        setattr(contrib, _name[len("_contrib_"):], _f)
sys.modules[contrib.__name__] = contrib
del _f, _name

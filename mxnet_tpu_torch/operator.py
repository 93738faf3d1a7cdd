"""Python custom operators (counterpart of ``mxnet_tpu/operator.py``; reference
python/mxnet/operator.py: CustomOp :426, CustomOpProp :472, register :692)::

    class Softmax(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0].asnumpy()
            ...
            self.assign(out_data[0], req[0], mx.nd.array(y))

    @mx.operator.register("softmax")
    class SoftmaxProp(mx.operator.CustomOpProp):
        ...

    out = mx.nd.Custom(x, label, op_type="softmax")

The op runs through the ``Custom`` operator (``ops/custom.py``): its body is
host Python on the port's NDArrays, and its gradient the op's
``backward``.
"""
from __future__ import annotations

import numpy as np
import torch

from .ops import custom as _custom

__all__ = ["CustomOp", "CustomOpProp", "register", "unregister",
           "get_all_registered_operators"]


class CustomOp:
    """Base class of a custom operator (reference operator.py:426)."""

    def forward(self, is_train, req, in_data, out_data, aux):
        raise NotImplementedError

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        raise NotImplementedError

    def assign(self, dst, req, src):
        """Write ``src`` (an NDArray, tensor or array) into the NDArray
        ``dst`` as ``req`` asks: "write" / "inplace" replace, "add" adds,
        "null" leaves it."""
        if req == "null":
            return
        value = dst._value(src)
        if not isinstance(value, torch.Tensor):
            value = torch.as_tensor(np.asarray(value), dtype=dst._data.dtype,
                                    device=dst._data.device)
        if req in ("write", "inplace"):
            dst._set_data(value)
        elif req == "add":
            dst._set_data(dst._data + value)
        else:
            raise ValueError("unknown req %r" % (req,))


class CustomOpProp:
    """A custom operator's properties: arguments, outputs, shapes and types
    (reference operator.py:472)."""

    def __init__(self, need_top_grad=True):
        self.need_top_grad_ = need_top_grad

    def infer_shape(self, in_shape):
        """Every output shaped as the first input."""
        return in_shape, [in_shape[0]] * len(self.list_outputs()), []

    def infer_type(self, in_type):
        return (in_type, [in_type[0]] * len(self.list_outputs()),
                [in_type[0]] * len(self.list_auxiliary_states()))

    def list_arguments(self):
        return ["data"]

    def list_outputs(self):
        return ["output"]

    def list_auxiliary_states(self):
        return []

    def declare_backward_dependency(self, out_grad, in_data, out_data):
        deps = list(out_grad) if self.need_top_grad_ else []
        return deps + list(in_data) + list(out_data)

    def create_operator(self, ctx, in_shapes, in_dtypes):
        return CustomOp()


def register(reg_name):
    """Class decorator: register a ``CustomOpProp`` as ``op_type=reg_name``
    (reference operator.py:692)."""

    def do_register(prop_cls):
        if not issubclass(prop_cls, CustomOpProp):
            raise TypeError("register expects a CustomOpProp subclass")
        _custom.register_prop(reg_name, prop_cls)
        return prop_cls

    return do_register


def unregister(reg_name):
    _custom.unregister_prop(reg_name)


def get_all_registered_operators():
    return list(_custom.PROP_REGISTRY)

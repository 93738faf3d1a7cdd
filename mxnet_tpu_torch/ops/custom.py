"""The ``Custom`` operator (counterpart of ``mxnet_tpu/ops/custom.py``;
reference src/operator/custom/custom.cc): runs a ``CustomOpProp`` registered
through ``mxnet_tpu_torch.operator``.

The prop's ``forward`` and ``backward`` run on the host's Python, on the
port's NDArrays over the op's tensors, inside a ``torch.autograd.Function``:
its forward calls ``CustomOp.forward`` with zero-filled output arrays, its
backward ``CustomOp.backward`` with the output gradients (zeros where a
head got none) and zero-filled input gradients.  Every request is
``"write"``, as in the JAX op.  The calls run with the inputs' device as
the current context, so an ``nd.array`` made inside lands beside them.
Shapes and dtypes come from the prop's ``infer_shape`` / ``infer_type``.
"""
from __future__ import annotations

import numpy as np
import torch

from .registry import register

__all__ = ["PROP_REGISTRY", "register_prop", "unregister_prop", "custom"]

PROP_REGISTRY = {}  # op_type -> CustomOpProp subclass
_META_PROP_CACHE = {}


def register_prop(op_type, prop_cls):
    PROP_REGISTRY[op_type] = prop_cls


def unregister_prop(op_type):
    """Remove a registration, and the props made for it."""
    PROP_REGISTRY.pop(op_type, None)
    for key in [k for k in _META_PROP_CACHE if k[0] == op_type]:
        _META_PROP_CACHE.pop(key, None)


def _make_prop(attrs, metadata_only=False):
    """The registered prop for these attributes, each passed as a string (the
    reference's contract).  Shape and output-count queries may share one
    prop; every execution gets a fresh one, as the reference makes one a
    node."""
    attrs = dict(attrs)
    attrs.pop("training", None)
    op_type = attrs.pop("op_type", None)
    if op_type is None:
        raise ValueError("Custom op requires op_type=")
    if op_type not in PROP_REGISTRY:
        raise ValueError("custom op type %r is not registered (use mx.operator.register)"
                         % (op_type,))
    str_attrs = {k: str(v) for k, v in attrs.items()}
    if not metadata_only:
        return PROP_REGISTRY[op_type](**str_attrs)
    key = (op_type, tuple(sorted(str_attrs.items())))
    prop = _META_PROP_CACHE.get(key)
    if prop is None or type(prop) is not PROP_REGISTRY[op_type]:
        prop = _META_PROP_CACHE[key] = PROP_REGISTRY[op_type](**str_attrs)
    return prop


def _num_outputs(attrs):
    return len(_make_prop(attrs, metadata_only=True).list_outputs())


def _torch_dtype(t):
    return getattr(torch, np.dtype(t).name)


class _Custom(torch.autograd.Function):
    """The prop's forward and backward as one autograd node."""

    @staticmethod
    def forward(ctx, op, is_train, out_specs, *inputs):
        from ..context import Context
        from ..ndarray.ndarray import NDArray

        device = inputs[0].device if inputs else torch.device("cpu")
        outs = [NDArray(torch.zeros(s, dtype=d, device=device)) for s, d in out_specs]
        with Context(device):
            op.forward(is_train=is_train, req=["write"] * len(outs),
                       in_data=[NDArray(x.detach()) for x in inputs], out_data=outs, aux=[])
        results = tuple(o._data.to(device) for o in outs)
        ctx.op = op
        ctx.device = device
        ctx.save_for_backward(*inputs, *results)
        ctx.n_in = len(inputs)
        return results

    @staticmethod
    def backward(ctx, *grads):
        from ..context import Context
        from ..ndarray.ndarray import NDArray

        saved = ctx.saved_tensors
        ins, outs = saved[:ctx.n_in], saved[ctx.n_in:]
        in_grads = [NDArray(torch.zeros_like(x)) for x in ins]
        out_grads = [NDArray(torch.zeros_like(o) if g is None else g.detach())
                     for g, o in zip(grads, outs)]
        with Context(ctx.device):
            ctx.op.backward(req=["write"] * len(ins), out_grad=out_grads,
                            in_data=[NDArray(x.detach()) for x in ins],
                            out_data=[NDArray(o) for o in outs], in_grad=in_grads, aux=[])
        return (None, None, None) + tuple(g._data.to(ctx.device) for g in in_grads)


@register("Custom", num_outputs=_num_outputs)
def custom(*data, training=False, **attrs):
    """A registered custom op (reference ``mx.nd.Custom``): ``op_type``
    selects the ``CustomOpProp``, the other attributes reach its
    constructor as strings, ``training`` is ``CustomOp.forward``'s
    ``is_train``.  Auxiliary states are not supported (as in the JAX op:
    keep state on the prop or the op)."""
    prop = _make_prop(attrs)
    in_shapes = [tuple(d.shape) for d in data]
    shape_res = prop.infer_shape(in_shapes)
    in_shapes, out_shapes = shape_res[0], shape_res[1]
    if len(shape_res) == 3 and shape_res[2]:
        raise NotImplementedError("auxiliary states in custom ops are not supported; keep "
                                  "state on the prop or the op instead")
    in_types = [np.dtype(str(d.dtype).replace("torch.", "")) for d in data]
    out_types = prop.infer_type(in_types)[1]
    out_specs = [(tuple(s), _torch_dtype(t)) for s, t in zip(out_shapes, out_types)]
    if data and data[0].device.type == "meta":
        outs = tuple(torch.empty(s, dtype=d, device="meta") for s, d in out_specs)
    else:
        op = prop.create_operator(None, in_shapes, in_types)
        outs = _Custom.apply(op, bool(training), out_specs, *data)
    return outs if len(outs) > 1 else outs[0]

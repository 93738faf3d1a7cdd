"""Operator registry of the port (counterpart of ``mxnet_tpu/ops/registry.py``).

An operator is a plain function on tensors whose positional parameters are
its tensor inputs and whose keyword-only parameters are its attributes::

    @register("Convolution", inputs_fn=_fc_inputs, infer_params=_conv_params)
    def convolution(data, weight, bias=None, *, kernel, num_filter, ...):

The symbolic frontend (``mxnet_tpu_torch.symbol``) builds its ``sym.*``
functions from these entries, reads the tensor-argument names for
``list_arguments``, and infers shapes by running the functions on ``meta``
tensors.  Only the operators of the ported paths are registered: those of
the ResNet symbol, the ``bench.py`` Module MLP, Dropout, int8
post-training quantization, and the SSD and proposal detection ops.  An
op's ``alias`` names (``MultiBoxPrior`` for ``_contrib_MultiBoxPrior``)
reach the same entry.
"""
from __future__ import annotations

import inspect

__all__ = ["OpDef", "register", "get", "list_ops"]

_REGISTRY = {}


class OpDef:
    """A registered operator.

    ``name`` is the MXNet op name, ``fn`` the function, ``hint`` the stem of
    its automatic node names, ``arg_names`` its tensor arguments in order,
    ``attr_names`` its attributes (keyword-only parameters) and
    ``defaults`` the defaults among the tensor arguments.  ``aux`` names
    the tensor arguments that are auxiliary states (BatchNorm's moving
    statistics); ``inputs_fn(attrs)`` lists the tensor arguments that these
    attributes need (no bias under ``no_bias``); ``infer_params(attrs,
    shapes)`` gives the shapes of parameter inputs from the known input
    shapes; ``aux_update(attrs, outputs, {aux name: tensor})`` gives the
    auxiliary states after a training forward from the op's outputs (the
    reference mutates them inside the kernel; the executor applies this).
    """

    def __init__(self, name, fn, aux=(), inputs_fn=None, infer_params=None,
                 aux_update=None):
        self.name = name
        self.fn = fn
        self.hint = name.lower().lstrip("_")
        self.aux = tuple(aux)
        self.inputs_fn = inputs_fn
        self.infer_params = infer_params
        self.aux_update = aux_update
        params = inspect.signature(fn).parameters.values()
        positional = [p for p in params if p.kind == inspect.Parameter.POSITIONAL_OR_KEYWORD]
        self.arg_names = [p.name for p in positional]
        self.attr_names = [p.name for p in params if p.kind == inspect.Parameter.KEYWORD_ONLY]
        self.defaults = {p.name: p.default for p in positional
                         if p.default is not inspect.Parameter.empty}
        self.__doc__ = fn.__doc__

    def __repr__(self):
        return "OpDef(%s)" % self.name


def register(name, alias=(), aux=(), inputs_fn=None, infer_params=None,
             aux_update=None):
    """Decorator: register ``fn`` as operator ``name``, also reached by the
    names in ``alias``.  The function itself is returned unchanged."""

    def _reg(fn):
        opdef = OpDef(name, fn, aux=aux, inputs_fn=inputs_fn,
                      infer_params=infer_params, aux_update=aux_update)
        for key in (name,) + tuple(alias):
            if key in _REGISTRY:
                raise ValueError("duplicate op registration: %s" % key)
            _REGISTRY[key] = opdef
        return fn

    return _reg


def get(name):
    """The OpDef of ``name``; KeyError for an op the port has not
    registered."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError("Operator %r is not registered in mxnet_tpu_torch "
                       "(only the ops of the ported paths are)" % name) from None


def list_ops():
    """Registered op names, sorted."""
    return sorted(_REGISTRY)

"""Operator registry of the port (counterpart of ``mxnet_tpu/ops/registry.py``).

An operator is a plain function on tensors whose positional parameters are
its tensor inputs and whose keyword-only parameters are its attributes::

    @register("Convolution", inputs_fn=_fc_inputs, infer_params=_conv_params)
    def convolution(data, weight, bias=None, *, kernel, num_filter, ...):

The symbolic frontend (``mxnet_tpu_torch.symbol``) builds its ``sym.*``
functions from these entries, reads the tensor-argument names for
``list_arguments``, and infers shapes by running the functions on ``meta``
tensors; the imperative frontend (``mxnet_tpu_torch.nd``) builds its
``nd.*`` functions from the same entries.  Registered: every operator of
the JAX package's registry, under its canonical name and its aliases.  An
op's ``alias`` names (``MultiBoxPrior`` for ``_contrib_MultiBoxPrior``, or
added later by :func:`alias`) reach the same entry.  An op whose tensor inputs are ``*args`` (``Concat``,
``add_n``) is ``variadic``.
"""
from __future__ import annotations

import inspect

__all__ = ["OpDef", "register", "alias", "get", "exists", "list_ops", "defs"]

_REGISTRY = {}


class OpDef:
    """A registered operator.

    ``name`` is the MXNet op name, ``fn`` the function, ``hint`` the stem of
    its automatic node names, ``arg_names`` its tensor arguments in order,
    ``attr_names`` its attributes (keyword-only parameters) and
    ``defaults`` the defaults of both.  ``aux`` names
    the tensor arguments that are auxiliary states (BatchNorm's moving
    statistics); ``inputs_fn(attrs)`` lists the tensor arguments that these
    attributes need (no bias under ``no_bias``); ``infer_params(attrs,
    shapes)`` gives the shapes of parameter inputs from the known input
    shapes; ``aux_update(attrs, outputs, {aux name: tensor})`` gives the
    auxiliary states after a training forward from the op's outputs (the
    reference mutates them inside the kernel; the executor applies this);
    ``num_outputs(attrs)`` the number of outputs of an op that returns a
    tuple (``SliceChannel``), for the symbolic frontend; ``mutates`` names
    the tensor arguments that an op updates in place in the reference (the
    optimizer updates): the op returns ``(out, *their new values)`` and
    ``mx.nd`` writes the new values back into those arguments.
    """

    def __init__(self, name, fn, aux=(), inputs_fn=None, infer_params=None,
                 aux_update=None, num_outputs=None, mutates=()):
        self.name = name
        self.fn = fn
        self.hint = name.lower().lstrip("_")
        self.aux = tuple(aux)
        self.inputs_fn = inputs_fn
        self.infer_params = infer_params
        self.aux_update = aux_update
        self.num_outputs = num_outputs
        self.mutates = tuple(mutates)
        params = inspect.signature(fn).parameters.values()
        self.variadic = any(p.kind == inspect.Parameter.VAR_POSITIONAL for p in params)
        positional = [p for p in params if p.kind == inspect.Parameter.POSITIONAL_OR_KEYWORD]
        self.arg_names = [p.name for p in positional]
        self.attr_names = [p.name for p in params if p.kind == inspect.Parameter.KEYWORD_ONLY]
        self.defaults = {p.name: p.default for p in params
                         if p.default is not inspect.Parameter.empty}
        self.__doc__ = fn.__doc__

    def __repr__(self):
        return "OpDef(%s)" % self.name


def register(name, alias=(), aux=(), inputs_fn=None, infer_params=None,
             aux_update=None, num_outputs=None, mutates=()):
    """Decorator: register ``fn`` as operator ``name``, also reached by the
    names in ``alias``.  The function itself is returned unchanged."""

    def _reg(fn):
        opdef = OpDef(name, fn, aux=aux, inputs_fn=inputs_fn,
                      infer_params=infer_params, aux_update=aux_update,
                      num_outputs=num_outputs, mutates=mutates)
        for key in (name,) + tuple(alias):
            if key in _REGISTRY:
                raise ValueError("duplicate op registration: %s" % key)
            _REGISTRY[key] = opdef
        return fn

    return _reg


def alias(name, *names):
    """Make each of ``names`` reach the op registered as ``name``."""
    opdef = get(name)
    for key in names:
        if key in _REGISTRY:
            raise ValueError("duplicate op registration: %s" % key)
        _REGISTRY[key] = opdef


def get(name):
    """The OpDef of ``name``; KeyError for an op the port has not
    registered."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError("Operator %r is not registered in mxnet_tpu_torch" % name) from None


def exists(name):
    return name in _REGISTRY


def list_ops():
    """Registered op names, aliases included, sorted."""
    return sorted(_REGISTRY)


def defs():
    """One OpDef per canonical name."""
    return list({id(op): op for op in _REGISTRY.values()}.values())

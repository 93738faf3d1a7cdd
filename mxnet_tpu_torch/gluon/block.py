"""Gluon-style blocks as ``torch.nn.Module``s (counterpart of
``mxnet_tpu/gluon/block.py``).

Only the naming is carried over: a block's ``prefix`` follows Gluon's
``_BlockScope`` rules, so that a parameter's Gluon name is the prefix of the
block that owns it plus the parameter's short name (``conv2d0_`` +
``weight``).  The weight converter (``model_zoo/convert.py``) matches the
JAX package's parameters by these names.

The rules: a block created inside ``parent.name_scope()`` gets
``parent.prefix + prefix``, and an unnamed block the next
``<alias><count>_`` of the parent's counters.  A block created with
``prefix=""`` has no scope of its own: children created inside its
``name_scope()`` are counted in the enclosing scope.  A block created
outside every scope is a root; its prefix is ``prefix`` or "", so that
names come out relative to it, as the JAX names are once the root's
prefix is stripped.
"""
from __future__ import annotations

import contextlib
import threading

import torch

__all__ = ["HybridBlock", "HybridSequential"]

_scope = threading.local()


def _create_prefix(prefix, hint):
    parent = getattr(_scope, "block", None)
    if parent is None:
        return "" if prefix is None else prefix
    if prefix is None:
        count = parent._counter.get(hint, 0)
        parent._counter[hint] = count + 1
        prefix = "%s%d_" % (hint, count)
    return parent.prefix + prefix


class HybridBlock(torch.nn.Module):
    """``torch.nn.Module`` with a Gluon ``prefix`` and ``name_scope()``.

    ``gluon_params`` names the block's own parameters and buffers by their
    Gluon short names (the attribute names here are the same).

    A block is built in eval mode (``training`` False), as a Gluon block
    runs in predict mode outside ``autograd.record()``: BatchNorm uses its
    running statistics until a train step (or the caller's ``train()``)
    turns training mode on."""

    gluon_params = ()

    def __init__(self, prefix=None):
        super().__init__()
        self.training = False
        self._empty_prefix = prefix == ""
        self.prefix = _create_prefix(prefix, self._alias())
        self._counter = {}

    def _alias(self):
        return type(self).__name__.lower()

    @contextlib.contextmanager
    def name_scope(self):
        if self._empty_prefix:
            yield
            return
        old = getattr(_scope, "block", None)
        _scope.block = self
        try:
            yield
        finally:
            _scope.block = old

    def cast(self, dtype):
        """Cast every floating parameter and buffer (BatchNorm's running
        statistics included) to ``dtype``, a ``torch.dtype`` or its name
        (``"bfloat16"``), in place; returns the block.  Counterpart of the
        JAX ``Block.cast``, whose ``Parameter.cast`` casts the running
        statistics too."""
        if isinstance(dtype, str):
            dtype = getattr(torch, dtype)
        if not (isinstance(dtype, torch.dtype) and dtype.is_floating_point):
            raise ValueError("cast: a floating dtype is needed, got %r" % (dtype,))
        return self.to(dtype=dtype)

    def gluon_named_tensors(self):
        """{Gluon name relative to this block: parameter or buffer}."""
        out = {}
        for m in self.modules():
            if isinstance(m, HybridBlock):
                for short in m.gluon_params:
                    name = m.prefix + short
                    if not name.startswith(self.prefix):
                        raise ValueError("%s is outside the prefix %r"
                                         % (name, self.prefix))
                    rel = name[len(self.prefix):]
                    if rel in out:
                        raise ValueError("two tensors share the name %r" % rel)
                    out[rel] = getattr(m, short)
        return out


class HybridSequential(HybridBlock):
    """Stack of blocks run in order (reference basic_layers.py:80)."""

    def add(self, *blocks):
        for block in blocks:
            self.add_module(str(len(self._modules)), block)

    def forward(self, x):
        for block in self._modules.values():
            x = block(x)
        return x

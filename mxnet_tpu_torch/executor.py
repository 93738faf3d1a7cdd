"""Executor — runs a bound Symbol graph (counterpart of ``mxnet_tpu/executor.py``).

The JAX executor hands the composed graph to ``jax.jit``; here the graph
runs eagerly, node by node in topological order, each node calling its
registered op on the outputs of its inputs.  Only the inference forward is
ported: ``forward(is_train=True)`` and ``backward`` (the symbolic training
path, ROADMAP A8) raise.
"""
from __future__ import annotations

import torch

from .context import full_fp32
from .symbol.symbol import _sym_out_name

__all__ = ["Executor"]


class Executor:
    """A Symbol bound to arrays on one device (reference
    include/mxnet/executor.h:53).  ``arg_dict`` / ``aux_dict`` map names to
    torch tensors on ``device``; ``outputs`` holds the last forward's
    results, in ``symbol.list_outputs()`` order."""

    def __init__(self, symbol, device, args, aux_states):
        self._symbol = symbol
        self.device = device
        self._arg_names = symbol.list_arguments()
        self._aux_names = symbol.list_auxiliary_states()
        self._out_names = symbol.list_outputs()
        self.arg_dict = dict(args)
        self.aux_dict = dict(aux_states)
        self.outputs = []
        self._plan = [(node, [_sym_out_name(i) for i in node.inputs])
                      for node in symbol._walk() if not node.is_var]

    @property
    def arg_arrays(self):
        return [self.arg_dict[n] for n in self._arg_names]

    @property
    def aux_arrays(self):
        return [self.aux_dict[n] for n in self._aux_names]

    def forward(self, is_train=False, **feeds):
        """Run the graph (reference GraphExecutor::Forward).  ``feeds`` rebind
        arguments by name; a tensor already on the device in the bound dtype
        is taken as it is, anything else is copied there.

        Runs under ``torch.inference_mode()`` and ``full_fp32()`` (no TF32 in
        cuDNN or matmuls, as the JAX reference computes), and makes no host
        synchronisation of its own: ranges stay on the device."""
        if is_train:
            raise NotImplementedError(
                "Executor.forward(is_train=True) is not ported: the symbolic "
                "training path (ROADMAP A8)")
        for k, v in feeds.items():
            if k not in self.arg_dict:
                raise ValueError("forward() got unknown argument %r; expected "
                                 "one of %s" % (k, self._arg_names))
            self.arg_dict[k] = torch.as_tensor(v, dtype=self.arg_dict[k].dtype,
                                               device=self.device)
        env = dict(self.arg_dict)
        env.update(self.aux_dict)
        with torch.inference_mode(), full_fp32():
            for node, in_names in self._plan:
                res = node.op.fn(*[env[n] for n in in_names], **node.attrs)
                outs = res if isinstance(res, tuple) else (res,)
                for i, o in enumerate(outs[: node.num_outputs]):
                    env[_sym_out_name(node[i] if node.num_outputs > 1 else node)] = o
        self.outputs = [env[n] for n in self._out_names]
        return self.outputs

    def backward(self, out_grads=None, is_train=None):
        raise NotImplementedError(
            "Executor.backward is not ported: the symbolic training path "
            "(ROADMAP A8)")

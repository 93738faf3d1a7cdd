"""Carry the JAX model's weights across to the port.

:func:`load_jax_params` fills a Gluon model; :func:`symbol_params_from_jax`
converts a Symbol's ``arg_params`` / ``aux_params``.

For a Gluon model, ``params`` is ``{name: numpy array}`` as the JAX model
gives it with the root prefix stripped::

    {k[len(jnet.prefix):]: p.data().asnumpy()
     for k, p in jnet.collect_params().items()}

Names such as ``res5_unit1_deformableconv2d0_offset_weight`` come from
Gluon's construction-order counters; the port builds its blocks in the same
order, so each block's ``prefix`` reproduces them
(``HybridBlock.gluon_named_tensors``).
"""
from __future__ import annotations

import numpy as np
import torch

from ...context import resolve_device

__all__ = ["load_jax_params", "symbol_params_from_jax"]


def load_jax_params(net, params):
    """Copy ``params`` into ``net``'s parameters and buffers, by Gluon name.

    Every name must map to exactly one tensor of ``net`` with the same shape,
    and every tensor must be given: a missing name, an extra name or a wrong
    shape raises before anything is copied.
    """
    targets = net.gluon_named_tensors()
    missing = sorted(set(targets) - set(params))
    extra = sorted(set(params) - set(targets))
    if missing or extra:
        raise KeyError("load_jax_params: names do not match (missing from "
                       "params: %s; not in the model: %s)" % (missing, extra))
    for name, value in params.items():
        if tuple(np.shape(value)) != tuple(targets[name].shape):
            raise ValueError("load_jax_params: %s has shape %s, the model "
                             "expects %s" % (name, tuple(np.shape(value)),
                                             tuple(targets[name].shape)))
    with torch.no_grad():
        for name, value in params.items():
            t = targets[name]
            t.copy_(torch.from_numpy(np.array(value, dtype=np.float32)))
    return net


def symbol_params_from_jax(sym, arg_params, aux_params, device=None, **input_shapes):
    """The JAX side's ``arg_params`` / ``aux_params`` of a Symbol, as
    ``{name: numpy array}`` (``{k: v.asnumpy()}`` of its NDArrays) -> the
    port's two dictionaries of tensors on ``device`` (None means CUDA, and
    raises without it unless ``device="cpu"``).

    ``input_shapes`` (``data=(N, C, H, W)``) let ``sym`` infer every
    parameter's shape: a name that ``sym`` does not take, or a wrong shape,
    raises before anything is copied.  Each tensor takes the dtype that
    ``simple_bind`` allocates for its variable, so the int8 ``*_quantize``
    weights of a quantized symbol stay int8.
    """
    dev = resolve_device(device)
    metas = sym._arg_metas(input_shapes)
    out = []
    for given, names, what in ((arg_params, sym.list_arguments(), "arg_params"),
                               (aux_params, sym.list_auxiliary_states(), "aux_params")):
        bound = {n: metas[n] for n in names}
        extra = sorted(set(given) - set(bound))
        if extra:
            raise KeyError("symbol_params_from_jax: %s not taken by the symbol: %s"
                           % (what, extra))
        for name, value in given.items():
            if tuple(np.shape(value)) != tuple(bound[name].shape):
                raise ValueError("symbol_params_from_jax: %s has shape %s, the "
                                 "symbol expects %s" % (name, tuple(np.shape(value)),
                                                        tuple(bound[name].shape)))
        out.append({name: torch.tensor(np.asarray(value), dtype=bound[name].dtype,
                                       device=dev) for name, value in given.items()})
    return tuple(out)

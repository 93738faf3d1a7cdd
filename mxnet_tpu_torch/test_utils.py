"""Checkpoints the tests, ``chip_smoke.py`` and benchmarks share
(counterpart of the parts of ``mxnet_tpu/test_utils.py`` the port needs)."""
from __future__ import annotations

import numpy as np
import torch

from . import symbol as sym

__all__ = ["deploy_twin_checkpoint", "tiny_mlp_checkpoint"]


def deploy_twin_checkpoint(batch=16, image=32, seed=0):
    """(symbol, params, input_shapes) of the two-head deploy graph of
    ``bench.py``'s ``MXNET_BENCH=predictor`` (``mxnet_tpu/test_utils.py
    deploy_twin_checkpoint``, the same symbol under the same names): a
    conv+BN trunk, then a classifier head and an embedding head that each
    derive the pooled trunk features anew (the duplicated chain the
    subexpression merge folds, and the eval Dropout the inference rewrite
    deletes).  Weights N(0, 0.05²) from a ``torch.Generator`` seeded with
    ``seed``, BN moving mean 0 and variance 1; ``params`` are CPU tensors
    keyed ``arg:<name>`` / ``aux:<name>``, as a ``.params`` file holds them.
    Build it under a fresh ``symbol.NameManager`` for the JAX package's
    automatic names."""
    data = sym.var("data")
    h = data
    for i, nf in enumerate((16, 32)):
        h = sym.Convolution(h, name="conv%d" % i, kernel=(3, 3), num_filter=nf, pad=(1, 1))
        h = sym.BatchNorm(h, name="bn%d" % i, fix_gamma=False)
        h = sym.Activation(h, name="act%d" % i, act_type="relu")
        h = sym.Pooling(h, name="pool%d" % i, kernel=(2, 2), stride=(2, 2), pool_type="max")

    def pooled_features(trunk):
        # auto-named: each call makes a fresh chain
        p = sym.Pooling(trunk, kernel=(1, 1), global_pool=True, pool_type="avg")
        return sym.L2Normalization(sym.Flatten(p))

    emb = pooled_features(h)  # the embedding head
    cls = sym.Dropout(pooled_features(h), p=0.5)
    prob = sym.softmax(sym.FullyConnected(cls, name="fc2", num_hidden=10), name="prob")
    net = sym.Group([prob, emb])

    gen = torch.Generator().manual_seed(seed)
    input_shapes = {"data": (batch, 3, image, image)}
    arg_shapes, _, aux_shapes = net.infer_shape(**input_shapes)
    params = {}
    for n, s in zip(net.list_arguments(), arg_shapes):
        if n != "data":
            params["arg:" + n] = torch.randn(s, generator=gen) * 0.05
    for n, s in zip(net.list_auxiliary_states(), aux_shapes):
        params["aux:" + n] = torch.ones(s) if n.endswith("_var") else torch.zeros(s)
    return net, params, input_shapes


def tiny_mlp_checkpoint(in_dim=8, num_hidden=16, num_classes=4, seed=0):
    """(symbol, params) of the tiny softmax MLP the serving tests share
    (``mxnet_tpu/test_utils.py tiny_mlp_checkpoint``: the same symbol under
    the same names, in_dim -> num_hidden -> relu -> num_classes,
    SoftmaxOutput).  Weights N(0, 1) from ``np.random.RandomState(seed)``
    drawn in argument order, as the JAX package draws them, so both
    packages hold the same values; CPU tensors keyed by argument name."""
    data = sym.Variable("data")
    fc1 = sym.FullyConnected(data, num_hidden=num_hidden, name="fc1")
    act = sym.Activation(fc1, act_type="relu", name="relu1")
    fc2 = sym.FullyConnected(act, num_hidden=num_classes, name="fc2")
    net = sym.SoftmaxOutput(fc2, name="softmax")
    arg_shapes, _, _ = net.infer_shape(data=(2, in_dim))
    rng = np.random.RandomState(seed)
    params = {n: torch.from_numpy(rng.randn(*s).astype(np.float32))
              for n, s in zip(net.list_arguments(), arg_shapes)
              if n not in ("data", "softmax_label")}
    return net, params

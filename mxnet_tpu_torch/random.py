"""The imperative frontend's random state (counterpart of
``mxnet_tpu/random.py``; reference python/mxnet/random.py).

One ``torch.Generator`` a device, made on first use and seeded from the
global seed (0 until ``seed`` is called; the device's ordinal is added, so
that two cards draw different streams, as the reference seeds each
device's resource).  Every sampler of ``nd.random``, the random ops of the
registry, Gluon's ``Dropout`` and ``Parameter.initialize`` draw from it;
nothing draws from PyTorch's global generator.  The bits differ from the
JAX package's; the distributions are the same.
"""
from __future__ import annotations

import threading

import torch

__all__ = ["seed", "current_seed", "generator", "uniform", "normal", "randn", "gamma",
           "exponential", "poisson", "negative_binomial", "generalized_negative_binomial",
           "randint", "multinomial", "shuffle"]

_LOCK = threading.Lock()
_state = {"seed": 0, "gens": {}}


def _key(device):
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def seed(seed_state, ctx="all"):
    """Seed every device's generator (``ctx`` is taken for the reference's
    signature, as the JAX package takes it)."""
    with _LOCK:
        _state["seed"] = int(seed_state)
        _state["gens"] = {}


def current_seed():
    return _state["seed"]


def _make(dev, base):
    g = torch.Generator(device=dev)
    g.manual_seed(base + (dev.index or 0))
    return g


def generator(device):
    """The generator of ``device`` (a ``torch.device`` or its name)."""
    dev = _key(device)
    with _LOCK:
        g = _state["gens"].get(dev)
        if g is None:
            g = _state["gens"][dev] = _make(dev, _state["seed"])
        return g


def _delegate(name):
    def f(*args, **kwargs):
        from .ndarray import random as _ndrandom

        return getattr(_ndrandom, name)(*args, **kwargs)

    f.__name__ = name
    f.__doc__ = "mx.random.%s: nd.random.%s." % (name, name)
    return f


uniform = _delegate("uniform")
normal = _delegate("normal")
gamma = _delegate("gamma")
exponential = _delegate("exponential")
poisson = _delegate("poisson")
negative_binomial = _delegate("negative_binomial")
generalized_negative_binomial = _delegate("generalized_negative_binomial")
randint = _delegate("randint")
multinomial = _delegate("multinomial")
shuffle = _delegate("shuffle")


def randn(*shape, loc=0.0, scale=1.0, dtype="float32", ctx=None):
    """Normal samples with the shape given positionally."""
    from .ndarray import random as _ndrandom

    return _ndrandom.normal(loc, scale, tuple(shape) or (1,), dtype, ctx=ctx)

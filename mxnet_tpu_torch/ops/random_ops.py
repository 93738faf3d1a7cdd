"""Random sampling operators (counterpart of ``mxnet_tpu/ops/random_ops.py``;
reference src/operator/random/sample_op.cc, multisample_op.cc,
sample_multinomial_op.cc, shuffle_op.cc).

Every op draws from the ``torch.Generator`` it is given as ``generator``,
on that generator's device: the nd frontend passes the per-device one of
``mxnet_tpu_torch.random`` (seeded by ``mx.random.seed``).  An op called
without one raises; no draw comes from PyTorch's global state.  The bits
differ from the JAX package's (a different generator); the distributions
are the same.

The ``_random_*`` ops take their parameters as numbers and a ``shape``;
the ``_sample_*`` ops take one tensor of parameters per distribution and
draw ``shape`` samples for each element of it."""
from __future__ import annotations

import torch

from .elemwise import to_dtype
from .registry import register

__all__ = []


def _gen(op, generator):
    if generator is None:
        raise ValueError("%s: needs a torch.Generator (nd.%s draws from "
                         "mxnet_tpu_torch.random's)" % (op, op))
    return generator


def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def _gamma(alpha, g):
    """Gamma(alpha, 1) samples of alpha's shape."""
    return torch._standard_gamma(alpha, generator=g)


def _poisson(lam, g):
    return torch.poisson(lam, generator=g)


@register("_random_uniform", alias=("uniform", "random_uniform"))
def random_uniform(*, low=0.0, high=1.0, shape=(1,), dtype="float32", generator=None):
    g = _gen("uniform", generator)
    u = torch.rand(_shape(shape), generator=g, device=g.device, dtype=to_dtype(dtype or "float32"))
    return low + u * (high - low)


@register("_random_normal", alias=("normal", "random_normal"))
def random_normal(*, loc=0.0, scale=1.0, shape=(1,), dtype="float32", generator=None):
    g = _gen("normal", generator)
    z = torch.randn(_shape(shape), generator=g, device=g.device, dtype=to_dtype(dtype or "float32"))
    return loc + scale * z


@register("_random_gamma", alias=("random_gamma",))
def random_gamma(*, alpha=1.0, beta=1.0, shape=(1,), dtype="float32", generator=None):
    g = _gen("gamma", generator)
    a = torch.full(_shape(shape), float(alpha), device=g.device, dtype=to_dtype(dtype or "float32"))
    return _gamma(a, g) * beta


@register("_random_exponential", alias=("random_exponential",))
def random_exponential(*, lam=1.0, shape=(1,), dtype="float32", generator=None):
    """Exponential of rate ``lam`` (mean 1 / lam)."""
    g = _gen("exponential", generator)
    out = torch.empty(_shape(shape), device=g.device, dtype=to_dtype(dtype or "float32"))
    return out.exponential_(1.0, generator=g) / lam


@register("_random_poisson", alias=("random_poisson",))
def random_poisson(*, lam=1.0, shape=(1,), dtype="float32", generator=None):
    g = _gen("poisson", generator)
    lam_t = torch.full(_shape(shape), float(lam), device=g.device)
    return _poisson(lam_t, g).to(to_dtype(dtype or "float32"))


def _neg_binomial(k, p, g):
    """Poisson(Gamma(k) · (1 − p) / p), the JAX op's construction."""
    return _poisson(_gamma(k, g) * ((1.0 - p) / p), g)


@register("_random_negative_binomial", alias=("random_negative_binomial",))
def random_negative_binomial(*, k=1, p=1.0, shape=(1,), dtype="float32", generator=None):
    g = _gen("negative_binomial", generator)
    kt = torch.full(_shape(shape), float(k), device=g.device)
    return _neg_binomial(kt, p, g).to(to_dtype(dtype or "float32"))


@register("_random_generalized_negative_binomial",
          alias=("random_generalized_negative_binomial",))
def random_generalized_negative_binomial(*, mu=1.0, alpha=1.0, shape=(1,), dtype="float32",
                                         generator=None):
    g = _gen("generalized_negative_binomial", generator)
    r = 1.0 / alpha
    rt = torch.full(_shape(shape), r, device=g.device)
    return _neg_binomial(rt, r / (r + mu), g).to(to_dtype(dtype or "float32"))


@register("_random_randint", alias=("random_randint", "randint"))
def random_randint(*, low, high, shape=(1,), dtype="int32", generator=None):
    """Integers uniform in [low, high)."""
    g = _gen("randint", generator)
    return torch.randint(int(low), int(high), _shape(shape), generator=g, device=g.device,
                         dtype=to_dtype(dtype or "int32"))


def _multinomial_outputs(attrs):
    return 2 if attrs.get("get_prob") else 1


@register("_sample_multinomial", alias=("sample_multinomial",),
          num_outputs=_multinomial_outputs)
def sample_multinomial(data, *, shape=(), get_prob=False, dtype="int32", generator=None):
    """Category ids drawn from each row of probabilities ``data`` (..., K):
    ``shape`` draws a row (none: one, without the axis); with
    ``get_prob`` also each draw's log-probability."""
    g = _gen("multinomial", generator)
    shape = _shape(shape) if shape else ()
    n = 1
    for s in shape:
        n *= s
    batch = tuple(data.shape[:-1])
    rows = data.reshape(-1, data.shape[-1]).to(torch.float32)
    draws = torch.multinomial(rows, n, replacement=True, generator=g)  # (rows, n)
    draws = draws.reshape(batch + (shape if shape else ()))
    out = draws.to(to_dtype(dtype or "int32"))
    if not get_prob:
        return out
    logp = torch.log_softmax(torch.log(torch.clamp_min(data, 1e-37)), dim=-1)
    picked = torch.gather(logp, -1, draws.reshape(batch + (-1,)))
    return out, picked.reshape(draws.shape)


@register("_shuffle", alias=("shuffle",))
def shuffle(data, *, generator=None):
    """Rows of ``data`` in a random order (reference shuffle_op.cc)."""
    g = _gen("shuffle", generator)
    return data[torch.randperm(data.shape[0], generator=g, device=g.device).to(data.device)]


def _expand(param, shape):
    """``param`` with ``len(shape)`` trailing axes, and the draw shape."""
    shape = _shape(shape) if shape else ()
    full = tuple(param.shape) + shape
    return param.reshape(tuple(param.shape) + (1,) * len(shape)), full


@register("_sample_uniform", alias=("sample_uniform",))
def sample_uniform(low, high, *, shape=(), dtype="float32", generator=None):
    g = _gen("sample_uniform", generator)
    lo, full = _expand(low, shape)
    hi, _ = _expand(high, shape)
    u = torch.rand(full, generator=g, device=g.device, dtype=to_dtype(dtype or "float32"))
    return (lo + u * (hi - lo)).to(u.dtype)


@register("_sample_normal", alias=("sample_normal",))
def sample_normal(mu, sigma, *, shape=(), dtype="float32", generator=None):
    g = _gen("sample_normal", generator)
    m, full = _expand(mu, shape)
    s, _ = _expand(sigma, shape)
    z = torch.randn(full, generator=g, device=g.device, dtype=to_dtype(dtype or "float32"))
    return (m + z * s).to(z.dtype)


@register("_sample_gamma", alias=("sample_gamma",))
def sample_gamma(alpha, beta, *, shape=(), dtype="float32", generator=None):
    g = _gen("sample_gamma", generator)
    a, full = _expand(alpha, shape)
    b, _ = _expand(beta, shape)
    return (_gamma(a.expand(full).to(torch.float32).contiguous(), g) * b).to(
        to_dtype(dtype or "float32"))


@register("_sample_exponential", alias=("sample_exponential",))
def sample_exponential(lam, *, shape=(), dtype="float32", generator=None):
    g = _gen("sample_exponential", generator)
    lt, full = _expand(lam, shape)
    e = torch.empty(full, device=g.device, dtype=to_dtype(dtype or "float32"))
    return (e.exponential_(1.0, generator=g) / lt).to(e.dtype)


@register("_sample_poisson", alias=("sample_poisson",))
def sample_poisson(lam, *, shape=(), dtype="float32", generator=None):
    g = _gen("sample_poisson", generator)
    lt, full = _expand(lam, shape)
    return _poisson(lt.expand(full).to(torch.float32).contiguous(), g).to(
        to_dtype(dtype or "float32"))


@register("_sample_negative_binomial", alias=("sample_negative_binomial",))
def sample_negative_binomial(k, p, *, shape=(), dtype="float32", generator=None):
    g = _gen("sample_negative_binomial", generator)
    kk, full = _expand(k, shape)
    pp, _ = _expand(p, shape)
    kf = kk.expand(full).to(torch.float32).contiguous()
    return _neg_binomial(kf, pp.to(torch.float32), g).to(to_dtype(dtype or "float32"))


@register("_sample_generalized_negative_binomial",
          alias=("sample_generalized_negative_binomial",))
def sample_generalized_negative_binomial(mu, alpha, *, shape=(), dtype="float32",
                                         generator=None):
    g = _gen("sample_generalized_negative_binomial", generator)
    m, full = _expand(mu, shape)
    a, _ = _expand(alpha, shape)
    r = 1.0 / torch.clamp_min(a.to(torch.float32), 1e-6)
    p = r / (r + m)
    return _neg_binomial(r.expand(full).contiguous(), p, g).to(to_dtype(dtype or "float32"))

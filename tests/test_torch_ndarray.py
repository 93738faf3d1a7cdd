"""The imperative frontend's operator groups (mxnet_tpu_torch.ops: elemwise,
reduce, matrix, indexing, init_ops, random_ops, rnn, optimizer_ops, misc,
the sequence ops, the detection registrations) against mxnet_tpu.ops, name
by name, on the same numpy inputs on the CPU; the optimizer updates' write
back of the states they update (``mutates``) through ``mx.nd``; then
NDArray's methods and operators and the Reshape codes against
mxnet_tpu.nd.

Tolerances: shape, index, comparison, logic and integer results must be
equal; fp32 math within rtol 1e-6, atol 1e-6 (another library's
approximations of the same functions).  The random ops cannot repeat JAX's
bits: each is checked for its shape and dtype against the JAX op's
(``jax.eval_shape``), for
determinism under ``mx.random.seed``, and for its moments within 4σ over
10⁴ draws.  Every JAX op runs eagerly (op by op, no ``jit``).
"""
import functools
import math
import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as jmx
from mxnet_tpu.ops import registry as jreg
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.ops import registry as treg

GROUPS = ("elemwise", "reduce", "matrix", "indexing", "init_ops", "random_ops", "rnn",
          "optimizer_ops")
MISC = ("reshape_like", "_copyto", "SequenceMask", "SequenceLast", "SequenceReverse")
DETECTION = ("_contrib_DeformableConvolution", "_contrib_DeformablePSROIPooling",
             "_contrib_PSROIPooling", "ROIPooling")


def _jax_group_names():
    by = {}
    for d in jreg.defs():
        by.setdefault(d.fn.__module__.rsplit(".", 1)[-1], []).append(d.name)
    return sorted(n for g in GROUPS for n in by[g])


JAX_NAMES = _jax_group_names()
NEW_NAMES = JAX_NAMES + list(MISC) + list(DETECTION)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


R = np.random.RandomState(0)


def U(*shape, lo=-2.0, hi=2.0):
    return R.uniform(lo, hi, shape).astype(np.float32)


def I(*shape, lo=-3, hi=4):
    """Integer-valued floats: comparisons meet ties."""
    return R.randint(lo, hi, shape).astype(np.float32)


POS = dict(lo=0.2, hi=3.0)
UNIT = dict(lo=-0.9, hi=0.9)
A, B = U(3, 4), U(1, 4)

UNARY_DOMAIN = {"sqrt": POS, "rsqrt": POS, "log": POS, "log10": POS, "log2": POS,
                "log1p": POS, "gamma": POS, "gammaln": dict(lo=2.2, hi=5.0), "reciprocal": POS,
                "rcbrt": POS, "arcsin": UNIT, "arccos": UNIT, "arctanh": UNIT,
                "erfinv": UNIT, "arccosh": dict(lo=1.1, hi=3.0), "tan": dict(lo=-1.2, hi=1.2)}
EXACT_UNARY = {"sign", "round", "rint", "ceil", "floor", "trunc", "fix", "logical_not", "abs",
               "negative", "relu", "_copy", "BlockGrad", "_zeros_like", "_ones_like", "square"}
CMP = ("equal", "not_equal", "greater", "greater_equal", "lesser", "lesser_equal",
       "logical_and", "logical_or", "logical_xor")


def _case(name):
    """-> (inputs, attrs, exact) of op ``name``, its inputs drawn from a
    seed of its own."""
    R.seed(zlib.crc32(name.encode()))
    op = jreg.get(name)
    base = name.lstrip("_")
    if name.endswith("_scalar"):
        stem = base[: -len("_scalar")]
        if stem in ("power", "rpower", "rdiv", "rmod", "mod", "hypot"):
            return [U(3, 4, **POS)], dict(scalar=1.5), False
        if any(stem.endswith(c) for c in CMP) or stem == "maximum_mask":
            return [I(3, 4)], dict(scalar=1.0), True
        return [I(3, 4) if stem in ("maximum", "minimum") else U(3, 4)], dict(scalar=1.5), \
            stem in ("maximum", "minimum")
    if op.arg_names == ["lhs", "rhs"] and name not in SPECIAL:
        stem = base.replace("broadcast_", "").replace("elemwise_", "")
        if any(stem.endswith(c) for c in CMP):
            return [I(3, 4), I(1, 4)], {}, True
        if stem in ("power", "mod", "hypot", "div", "scatter_elemwise_div"):
            return [U(3, 4, **POS), U(1, 4, **POS)], {}, False
        return [A, B], {}, stem in ("maximum", "minimum")
    if op.arg_names == ["data"] and not op.attr_names:
        return [U(3, 4, **UNARY_DOMAIN.get(base, {}))], {}, base in EXACT_UNARY or \
            name in EXACT_UNARY
    return SPECIAL[name]()


def _idx(*vals):
    return np.asarray(vals, np.float32)


SPECIAL = {
    "clip": lambda: ([U(3, 4)], dict(a_min=-0.5, a_max=0.7), True),
    "smooth_l1": lambda: ([U(3, 4)], dict(scalar=2.0), False),
    "add_n": lambda: ([U(3, 4), U(3, 4), U(3, 4)], {}, False),
    "cast": lambda: ([U(3, 4) * 10], dict(dtype="int32"), True),
    # reduce
    "sum": lambda: ([U(2, 3, 4)], dict(axis=(0, 2), keepdims=True), False),
    "mean": lambda: ([U(2, 3, 4)], dict(axis=1, exclude=True), False),
    "prod": lambda: ([U(2, 3, 4, lo=0.5, hi=1.5)], dict(axis=(1, 2)), False),
    "nansum": lambda: ([np.where(U(2, 3) > 1, np.nan, U(2, 3)).astype(np.float32)],
                       dict(axis=1), False),
    "nanprod": lambda: ([np.where(U(2, 3) > 1, np.nan, U(2, 3)).astype(np.float32)],
                        dict(axis=0), False),
    "max": lambda: ([U(2, 3, 4)], dict(axis=-1, keepdims=True), True),
    "min": lambda: ([U(2, 3, 4)], {}, True),
    "norm": lambda: ([U(2, 3, 4)], dict(axis=(1,)), False),
    "argmax": lambda: ([I(3, 5)], dict(axis=1, keepdims=True), True),
    "argmin": lambda: ([I(3, 5)], dict(axis=0), True),
    "argmax_channel": lambda: ([I(3, 5)], {}, True),
    "pick": lambda: ([U(3, 5), _idx(0, 7, -2)], dict(axis=1), True),
    "L2Normalization": lambda: ([U(2, 3, 4)], dict(mode="channel"), False),
    "moments": lambda: ([U(2, 3, 4)], dict(axes=(0, 2)), False),
    "softmax_cross_entropy": lambda: ([U(4, 5), _idx(0, 4, 2, 1)], {}, False),
    # matrix
    "Reshape": lambda: ([U(2, 3, 4)], dict(shape=(-4, 1, 2, -3)), True),
    "Flatten": lambda: ([U(2, 3, 4)], {}, True),
    "transpose": lambda: ([U(2, 3, 4)], dict(axes=(2, 0, 1)), True),
    "expand_dims": lambda: ([U(2, 3)], dict(axis=1), True),
    "squeeze": lambda: ([U(2, 1, 3, 1)], dict(axis=(1, 3)), True),
    "slice": lambda: ([U(4, 5, 6)], dict(begin=(1, None, 5), end=(3, None, 0),
                                         step=(1, None, -2)), True),
    "slice_axis": lambda: ([U(4, 5)], dict(axis=1, begin=1, end=None), True),
    "slice_like": lambda: ([U(4, 5), U(2, 3)], dict(axes=(1,)), True),
    "Concat": lambda: ([U(2, 3), U(2, 2)], dict(dim=1), True),
    "stack": lambda: ([U(2, 3), U(2, 3)], dict(axis=1), True),
    "SliceChannel": lambda: ([U(2, 6)], dict(num_outputs=3, axis=1), True),
    "repeat": lambda: ([U(2, 3)], dict(repeats=2, axis=0), True),
    "tile": lambda: ([U(2, 3)], dict(reps=(2, 1, 2)), True),
    "reverse": lambda: ([U(2, 3, 4)], dict(axis=(0, 2)), True),
    "SwapAxis": lambda: ([U(2, 3, 4)], dict(dim1=0, dim2=2), True),
    "dot": lambda: ([U(4, 3), U(4, 5)], dict(transpose_a=True), False),
    "batch_dot": lambda: ([U(2, 3, 4), U(2, 5, 4)], dict(transpose_b=True), False),
    "where": lambda: ([I(3, lo=0, hi=2), U(3, 4), U(3, 4)], {}, True),
    "broadcast_to": lambda: ([U(1, 3)], dict(shape=(4, 0)), True),
    "broadcast_axis": lambda: ([U(1, 3, 1)], dict(axis=(0, 2), size=(2, 4)), True),
    "broadcast_like": lambda: ([U(1, 3), U(4, 3)], {}, True),
    "Pad": lambda: ([U(1, 2, 3, 4)], dict(mode="edge", pad_width=(0, 0, 0, 0, 1, 2, 2, 1)),
                    True),
    "space_to_depth": lambda: ([U(1, 2, 4, 6)], dict(block_size=2), True),
    "depth_to_space": lambda: ([U(1, 8, 2, 3)], dict(block_size=2), True),
    "diag": lambda: ([U(4, 4)], dict(k=1), True),
    "shape_array": lambda: ([U(2, 3, 4)], {}, True),
    "size_array": lambda: ([U(2, 3, 4)], {}, True),
    # indexing
    "take": lambda: ([U(4, 3), _idx(0, 5, -1, 2)], dict(axis=0, mode="clip"), True),
    "batch_take": lambda: ([U(3, 4), _idx(1, 0, 3)], {}, True),
    "Embedding": lambda: ([_idx(0, 4, 9), U(5, 3)], dict(input_dim=5, output_dim=3), True),
    "one_hot": lambda: ([_idx(0, 3, 7, -1)], dict(depth=5, on_value=2.0, off_value=-1.0),
                        True),
    "gather_nd": lambda: ([U(3, 4, 2), _idx([0, 2, 1], [3, 0, 3])], {}, True),
    "scatter_nd": lambda: ([U(3), _idx([0, 2, 1], [3, 0, 2])], dict(shape=(3, 4)), True),
    "_scatter_set_nd": lambda: ([U(3, 4), _idx([0, 2], [1, 3]), U(2)], dict(shape=(3, 4)),
                                True),
    "sort": lambda: ([I(3, 6)], dict(axis=1, is_ascend=False), True),
    "argsort": lambda: ([I(3, 6)], dict(axis=-1, is_ascend=False), True),
    "topk": lambda: ([U(3, 6)], dict(axis=1, k=3, ret_typ="both"), True),
    # init
    "_zeros": lambda: ([], dict(shape=(2, 3)), True),
    "_ones": lambda: ([], dict(shape=(2, 3), dtype="int32"), True),
    "_full": lambda: ([], dict(shape=(2, 3), value=2.5), True),
    "_arange": lambda: ([], dict(start=1.0, stop=4.0, step=0.5, repeat=2), True),
    "_eye": lambda: ([], dict(N=3, M=4, k=1), True),
    "_linspace": lambda: ([], dict(start=-1.0, stop=2.0, num=7), False),
    "_zeros_rows": lambda: ([U(3, 2)], dict(tail=(4,)), True),
    # misc
    "reshape_like": lambda: ([U(2, 6), U(3, 4)], {}, True),
    "_copyto": lambda: ([U(2, 3)], {}, True),
    # rnn and the sequence ops: data (seq, batch, ...), lengths per batch row
    "RNN": lambda: ([U(3, 2, 3), U(144, lo=-0.5, hi=0.5), U(1, 2, 4), U(1, 2, 4)],
                    dict(state_size=4, num_layers=1, mode="lstm", state_outputs=True), False),
    "split_v2": lambda: ([U(4, 6)], dict(indices_or_sections=(1, 3), axis=1), True),
    "SequenceMask": lambda: ([U(4, 3, 2), _idx(2, 4, 1)],
                             dict(use_sequence_length=True, value=-1.0), True),
    "SequenceLast": lambda: ([U(4, 3, 2), _idx(2, 4, 1)], dict(use_sequence_length=True), True),
    "SequenceReverse": lambda: ([U(4, 3, 2), _idx(2, 4, 1)], dict(use_sequence_length=True),
                                True),
    # optimizer updates: (weight, grad, *states); second moments positive
    "sgd_update": lambda: ([U(3, 4), U(3, 4)],
                           dict(lr=0.1, wd=0.01, rescale_grad=0.5, clip_gradient=0.8), False),
    "sgd_mom_update": lambda: ([U(3, 4), U(3, 4), U(3, 4)],
                               dict(lr=0.1, momentum=0.9, wd=0.01, clip_gradient=0.8), False),
    "mp_sgd_update": lambda: ([U(3, 4), U(3, 4), U(3, 4)], dict(lr=0.1, wd=0.01), False),
    "mp_sgd_mom_update": lambda: ([U(3, 4), U(3, 4), U(3, 4), U(3, 4)],
                                  dict(lr=0.1, momentum=0.9, wd=0.01), False),
    "adam_update": lambda: ([U(3, 4), U(3, 4), U(3, 4), U(3, 4, **POS)],
                            dict(lr=0.01, wd=0.01, rescale_grad=2.0, clip_gradient=0.5), False),
    "ftml_update": lambda: ([U(3, 4), U(3, 4), U(3, 4, **POS), U(3, 4, **POS), U(3, 4)],
                            dict(lr=0.1, t=3, wd=0.01, clip_grad=1.0), False),
    "rmsprop_update": lambda: ([U(3, 4), U(3, 4), U(3, 4, **POS)],
                               dict(lr=0.01, clip_gradient=1.0, clip_weights=1.0), False),
    "rmspropalex_update": lambda: ([U(3, 4), U(3, 4), U(3, 4, lo=2.0, hi=4.0), U(3, 4, **UNIT),
                                    U(3, 4)], dict(lr=0.01, clip_weights=1.5), False),
    "ftrl_update": lambda: ([U(3, 4), U(3, 4), U(3, 4), U(3, 4, **POS)],
                            dict(lr=0.1, lamda1=0.5, wd=0.01), False),
    "signsgd_update": lambda: ([U(3, 4), U(3, 4)], dict(lr=0.1, wd=0.01), False),
    "signum_update": lambda: ([U(3, 4), U(3, 4), U(3, 4)],
                              dict(lr=0.1, momentum=0.9, wd=0.01, wd_lh=0.01), False),
}

INIT = {"_zeros", "_ones", "_full", "_arange", "_eye", "_linspace"}

# name -> (attrs, parameter tensors or None, mean, variance) of each draw;
# the _sample_ ops draw 5,000 per parameter for two parameters
_N = (10_000,)
_S = (5_000,)
RANDOM = {
    "_random_uniform": (dict(low=-1.0, high=3.0, shape=_N), None, 1.0, 16 / 12),
    "_random_normal": (dict(loc=1.0, scale=2.0, shape=_N), None, 1.0, 4.0),
    "_random_gamma": (dict(alpha=2.0, beta=3.0, shape=_N), None, 6.0, 18.0),
    "_random_exponential": (dict(lam=2.0, shape=_N), None, 0.5, 0.25),
    "_random_poisson": (dict(lam=3.0, shape=_N), None, 3.0, 3.0),
    "_random_negative_binomial": (dict(k=3, p=0.4, shape=_N), None, 4.5, 11.25),
    "_random_generalized_negative_binomial": (dict(mu=2.0, alpha=0.5, shape=_N), None,
                                              2.0, 4.0),
    "_random_randint": (dict(low=0, high=10, shape=_N), None, 4.5, 8.25),
    "_sample_multinomial": (dict(shape=_N), [np.array([0.2, 0.3, 0.5], np.float32)], 1.3,
                            0.61),
    "_sample_uniform": (dict(shape=_S), [_idx(0, -2), _idx(1, 2)], [0.5, 0.0],
                        [1 / 12, 16 / 12]),
    "_sample_normal": (dict(shape=_S), [_idx(0, 3), _idx(1, 2)], [0.0, 3.0], [1.0, 4.0]),
    "_sample_gamma": (dict(shape=_S), [_idx(2, 5), _idx(1, 0.5)], [2.0, 2.5], [2.0, 1.25]),
    "_sample_exponential": (dict(shape=_S), [_idx(1, 4)], [1.0, 0.25], [1.0, 1 / 16]),
    "_sample_poisson": (dict(shape=_S), [_idx(1, 6)], [1.0, 6.0], [1.0, 6.0]),
    "_sample_negative_binomial": (dict(shape=_S), [_idx(2, 5), _idx(0.5, 0.25)],
                                  [2.0, 15.0], [4.0, 60.0]),
    "_sample_generalized_negative_binomial": (dict(shape=_S), [_idx(2, 1), _idx(0.5, 1.0)],
                                              [2.0, 1.0], [4.0, 2.0]),
    "_shuffle": (dict(), [np.arange(10_000, dtype=np.float32)], None, None),
}


def test_every_name_of_the_groups_is_registered_with_its_aliases():
    """The port's registry holds each name of the JAX groups (and the misc
    and detection names), each alias reaching the same op as in JAX."""
    have = set(treg.list_ops())
    assert not sorted(set(NEW_NAMES) - have)
    for alias in jreg.list_ops(include_aliases=True):
        canon = jreg.get(alias).name
        if canon in NEW_NAMES and alias in have:
            assert treg.get(alias) is treg.get(canon), alias
    assert len(have) > 270


def _np(x):
    return np.asarray(x, dtype=np.float32) if x.dtype == jnp.bfloat16 else np.asarray(x)


def _compare(got, ref, exact, name):
    got = got if isinstance(got, (tuple, list)) else (got,)
    ref = ref if isinstance(ref, (tuple, list)) else (ref,)
    assert len(got) == len(ref), name
    for g, r in zip(got, ref):
        g, r = g.numpy(), _np(r)
        assert g.shape == r.shape, (name, g.shape, r.shape)
        if exact:
            np.testing.assert_array_equal(g.astype(r.dtype), r, err_msg=name)
        else:
            np.testing.assert_allclose(g, r, rtol=1e-6, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("name", sorted(set(NEW_NAMES) - set(RANDOM) - set(DETECTION)))
def test_op_against_jax(name):
    inputs, attrs, exact = _case(name)
    ref = jreg.get(name).fn(*[jnp.asarray(a) for a in inputs], **attrs)
    tattrs = dict(attrs, device="cpu") if name in INIT else attrs
    got = treg.get(name).fn(*[torch.from_numpy(a) for a in inputs], **tattrs)
    _compare(got, ref, exact, name)


UPDATES = sorted(n for n in JAX_NAMES if n.endswith("_update"))


@pytest.mark.parametrize("name", UPDATES)
def test_update_op_writes_back_what_it_mutates(name):
    """``nd.<update>(w, g, *states, out=w)`` through each frontend: the
    weight and every state it names in ``mutates`` hold the new values, as
    the JAX eager frontend writes them back."""
    assert treg.get(name).mutates == jreg.get(name).mutates
    inputs, attrs, _ = _case(name)
    jargs = [jmx.nd.array(a) for a in inputs]
    with tmx.cpu():
        targs = [tmx.nd.array(a) for a in inputs]
        got = getattr(tmx.nd, name)(*targs, out=targs[0], **attrs)
    getattr(jmx.nd, name)(*jargs, out=jargs[0], **attrs)
    assert got is targs[0]
    for i, (t, j) in enumerate(zip(targs, jargs)):
        np.testing.assert_allclose(t.asnumpy(), j.asnumpy(), rtol=1e-6, atol=1e-6,
                                   err_msg="%s input %d" % (name, i))
    moved = {0} | {jreg.get(name).arg_names.index(m) for m in jreg.get(name).mutates}
    for i, (t, a) in enumerate(zip(targs, inputs)):
        assert (i in moved) != np.array_equal(t.asnumpy(), a), (name, i)


def _draw(name, seed, attrs, params):
    with tmx.cpu():
        tmx.random.seed(seed)
        args = [tmx.nd.array(p) for p in params or []]
        out = getattr(tmx.nd, name)(*args, **attrs)
    return out.asnumpy()


@pytest.mark.parametrize("name", sorted(RANDOM))
def test_random_op(name):
    attrs, params, mean, var = RANDOM[name]
    # the JAX op's shape and dtype, traced without running it (the
    # multinomial op reads a concrete size: it runs)
    jf = lambda *p: jreg.get(name).fn(*p, key=jax.random.PRNGKey(0), **attrs)  # noqa: E731
    jargs = [jnp.asarray(p) for p in params or []]
    ref = jf(*jargs) if name == "_sample_multinomial" else jax.eval_shape(jf, *jargs)
    a = _draw(name, 7, attrs, params)
    assert a.shape == tuple(ref.shape) and a.dtype == np.dtype(ref.dtype), name
    np.testing.assert_array_equal(a, _draw(name, 7, attrs, params))   # same seed, same draws
    assert not np.array_equal(a, _draw(name, 8, attrs, params))       # another seed, others
    if mean is None:  # shuffle: a permutation of the rows
        np.testing.assert_array_equal(np.sort(a), params[0])
        return
    rows = a.reshape(len(np.atleast_1d(mean)), -1).astype(np.float64)
    for row, m, v in zip(rows, np.atleast_1d(mean), np.atleast_1d(var)):
        assert abs(row.mean() - m) <= 4 * math.sqrt(v / row.size), (name, row.mean(), m)
        # the variance's own spread, bounded loosely by its fourth moment
        assert abs(row.var() - v) <= 4 * math.sqrt(2 * v * v / row.size) + \
            4 * row.var() * math.sqrt(6.0 / row.size), (name, row.var(), v)


def _jit(name, **attrs):
    f = jreg.get(name).fn
    return jax.jit(lambda *a: f(*a, **attrs))


def test_detection_registrations_against_jax():
    """The deformable ops, PSROIPooling and ROIPooling reached by their
    registered names, against the JAX ops each under one ``jit`` (as the
    JAX steps run them; eagerly each is hundreds of dispatches, and
    ROIPooling bins its divisions as the port does only when jitted)."""
    rng = np.random.RandomState(3)
    x = rng.randn(1, 4, 6, 6).astype(np.float32)
    off = (rng.randn(1, 18, 6, 6) * 0.5).astype(np.float32)
    w = rng.randn(5, 4, 3, 3).astype(np.float32)
    b = rng.randn(5).astype(np.float32)
    kw = dict(kernel=(3, 3), num_filter=5, pad=(1, 1), num_deformable_group=1)
    ref = _jit("_contrib_DeformableConvolution", **kw)(*map(jnp.asarray, (x, off, w, b)))
    got = treg.get("DeformableConvolution").fn(*map(torch.from_numpy, (x, off, w, b)), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    rois = np.array([[0, 0, 0, 40, 30], [0, 8, 4, 20, 44]], np.float32)
    maps = rng.randn(1, 2 * 9, 6, 6).astype(np.float32)
    trans = (rng.randn(2, 2, 3, 3) * 0.1).astype(np.float32)
    for name, args, attrs in [
            ("_contrib_DeformablePSROIPooling", (maps, rois, trans),
             dict(spatial_scale=0.125, output_dim=2, group_size=3, pooled_size=3,
                  trans_std=0.1)),
            ("_contrib_PSROIPooling", (maps, rois),
             dict(spatial_scale=0.125, output_dim=2, pooled_size=3)),
            ("ROIPooling", (np.round(x * 4), rois), dict(pooled_size=(3, 3),
                                                          spatial_scale=0.125))]:
        ref = _jit(name, **attrs)(*map(jnp.asarray, args))
        got = treg.get(name).fn(*map(torch.from_numpy, args), **attrs)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6,
                                   err_msg=name)


# -- NDArray ---------------------------------------------------------------------------


def _pair(a):
    with tmx.cpu():
        return jmx.nd.array(a), tmx.nd.array(a)


def _eq(t, j, exact=False):
    if exact:
        np.testing.assert_array_equal(t.asnumpy(), j.asnumpy())
    else:
        np.testing.assert_allclose(t.asnumpy(), j.asnumpy(), rtol=1e-6, atol=1e-6)


def test_ndarray_operators_and_methods():
    x = U(3, 4)
    (ja, ta), (jb, tb) = _pair(x), _pair(U(1, 4))
    for f in (lambda a, b: a + b, lambda a, b: a - b, lambda a, b: a * b,
              lambda a, b: a / b, lambda a, b: 2.0 - a, lambda a, b: 1.5 / (a * a + 1),
              lambda a, b: a ** 2, lambda a, b: -a + 0.5 * b,
              lambda a, b: a.sum(axis=1), lambda a, b: a.mean(), lambda a, b: a.max(axis=0),
              lambda a, b: a.reshape((2, -1)), lambda a, b: a.T, lambda a, b: a[1],
              lambda a, b: a[1:3, ::2], lambda a, b: a.expand_dims(0).squeeze(0),
              lambda a, b: a.clip(-0.5, 0.5), lambda a, b: a.exp().log(),
              lambda a, b: a.transpose((1, 0)).flatten(), lambda a, b: a.astype("int32"),
              lambda a, b: a.argmax(axis=1), lambda a, b: a.square()):
        _eq(f(ta, tb), f(ja, jb))
    for f in (lambda a, b: a > 0, lambda a, b: a <= b, lambda a, b: a == a,
              lambda a, b: a != 0.5, lambda a, b: (a > 0).sum()):
        t, j = f(ta, tb), f(ja, jb)
        assert t.dtype == j.dtype == np.float32  # 1.0 / 0.0, not bool
        _eq(t, j, exact=True)
    assert ta.shape == ja.shape and ta.size == ja.size and ta.ndim == ja.ndim
    assert float(ta.sum()) == pytest.approx(float(ja.sum()), rel=1e-6)
    assert len(ta) == 3 and ta.context == tmx.cpu() and str(ta.context) == "cpu(0)"
    assert [r.shape for r in ta] == [(4,)] * 3
    # in place: rebinding, as JAX's
    for t, j in ((ta, ja),):
        t += 1.0
        j += 1.0
        t[0] = 5.0
        j[0] = 5.0
        t[1:, 2] = tmx.nd.array(np.array([7.0, 8.0], np.float32), ctx=tmx.cpu())
        j[1:, 2] = jmx.nd.array(np.array([7.0, 8.0], np.float32))
        _eq(t, j, exact=True)
    c = ta.copy()
    c[:] = 0
    assert float(ta.sum()) != 0.0
    with tmx.cpu():
        assert tmx.nd.zeros((2, 3)).asnumpy().sum() == 0
        np.testing.assert_array_equal(tmx.nd.arange(0, 5, 2).asnumpy(),
                                      jmx.nd.arange(0, 5, 2).asnumpy())
        np.testing.assert_array_equal(tmx.nd.full((2,), 3.0).asnumpy(), [3.0, 3.0])
        np.testing.assert_array_equal(tmx.nd.maximum(tb, 0.0).asnumpy(),
                                      jmx.nd.maximum(jb, 0.0).asnumpy())
        np.testing.assert_array_equal(tmx.nd.minimum(ta, tb).asnumpy(),
                                      jmx.nd.minimum(ja, jb).asnumpy())
        assert tmx.nd.array(np.arange(3)).dtype == np.int32  # int64 -> int32
        assert tmx.nd.array(np.ones(2)).dtype == np.float32   # float64 -> float32
        np.testing.assert_array_equal(tmx.nd.clip(ta, 0, 1).asnumpy(),
                                      jmx.nd.clip(ja, 0, 1).asnumpy())  # positional attrs
        np.testing.assert_array_equal(tmx.nd.ones_like(ta).asnumpy(), np.ones((3, 4)))
        parts = tmx.nd.split(ta, num_outputs=2, axis=1)
        assert [p.shape for p in parts] == [(3, 2), (3, 2)]
        out = tmx.nd.zeros((3, 4))
        tmx.nd.abs(ta, out=out)
        np.testing.assert_array_equal(out.asnumpy(), np.abs(ta.asnumpy()))
        assert tmx.nd.contrib.MultiProposal is not None and tmx.nd.contrib.box_nms


@pytest.mark.parametrize("src,target,reverse", [
    ((2, 3, 4), (0, -1), False), ((2, 3, 4), (-2,), False), ((2, 3, 4), (-3, 0), False),
    ((2, 3, 4), (0, -4, 1, -1, 0), False), ((2, 3, 4, 5), (-3, -2), False),
    ((2, 3, 4), (0, -1), True), ((2, 3, 4), (-1, 0), True), ((6, 4), (0, 2, -1), False)])
def test_reshape_codes(src, target, reverse):
    x = np.arange(np.prod(src), dtype=np.float32).reshape(src)
    ja, ta = _pair(x)
    ref = ja.reshape(target, reverse=reverse)
    got = ta.reshape(target, reverse=reverse)
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got.asnumpy(), ref.asnumpy())
    with tmx.cpu():
        np.testing.assert_array_equal(
            tmx.nd.Reshape(ta, shape=target, reverse=reverse).asnumpy(), ref.asnumpy())


def test_nd_array_without_a_context_needs_the_card():
    """No silent CPU path: the default context is the card."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmx.nd.array([1.0])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmx.Context().device  # the default context type is the card
    with pytest.raises(ValueError, match="tpu"):
        tmx.Context("tpu")
    assert tmx.current_context() == tmx.gpu(0)
    with tmx.cpu():
        assert tmx.current_context() == tmx.cpu()
        assert tmx.nd.array([1.0]).context == tmx.cpu()


def test_symbol_frontend_builds_the_new_groups():
    """The symbolic frontend picks the new ops up from the registry, the
    variadic ``Concat`` and the multi-output ``SliceChannel`` included: the
    same graph binds and runs in both packages."""
    from mxnet_tpu_torch import symbol as tsym

    x, y = U(2, 3), U(2, 5)
    outs = []
    for S, bind in ((jmx.sym, lambda s: s.simple_bind(jmx.cpu(), grad_req="null",
                                                      a=(2, 3), b=(2, 5))),
                    (tsym, lambda s: s.simple_bind(device="cpu", grad_req="null",
                                                   a=(2, 3), b=(2, 5)))):
        a, b = S.var("a"), S.var("b")
        parts = S.SliceChannel(S.Concat(a, b, dim=1), num_outputs=2, axis=1)
        net = S.Group([S.sum(parts[1], axis=1), S.transpose(S.tanh(parts[0])),
                       S.broadcast_mul(S.expand_dims(S.argmax(a, axis=1), axis=1), b)])
        exe = bind(net)
        outs.append([np.asarray(o.asnumpy() if hasattr(o, "asnumpy") else o)
                     for o in exe.forward(a=x, b=y)])
    for t, j in zip(outs[1], outs[0]):
        np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-6)


# -- the rest of the registry: nn, linalg, contrib, misc, ROIAlign, the R-CNN
# targets and Custom, forward and gradients (mxnet_tpu_torch.test_utils
# registry_cases: their inputs, attributes and tolerances, shared with
# chip_smoke.py's registry_ops phase).  The JAX side runs under jax.jit, one
# compile a case: eager dispatch of these composites costs seconds a case.

from mxnet_tpu_torch.test_utils import register_numpy_softmax, registry_cases  # noqa: E402

CASES = registry_cases()
register_numpy_softmax(jmx)
register_numpy_softmax(tmx)
# its general bins are read to the host (int()), which a trace cannot do
_EAGER = {"_contrib_AdaptiveAvgPooling2D"}


def test_the_registry_is_whole():
    """Every canonical name of the JAX registry, and every alias, reaches
    the port's op of the same canonical name; every canonical name of the
    groups ported here has a case."""
    for name in jreg.list_ops(include_aliases=True):
        assert treg.exists(name), name
        assert treg.get(name).name == jreg.get(name).name, name
    assert len(treg.defs()) == len(jreg.defs()) == 288
    assert {c.op for c in CASES.values()} >= {
        d.name for d in jreg.defs()
        if d.fn.__module__.rsplit(".", 1)[-1] in ("linalg", "contrib_ops", "custom")}


def _outs(res):
    return list(res) if isinstance(res, (tuple, list)) else [res]


@pytest.mark.parametrize("case", sorted(CASES))
def test_registry_op_and_gradient_against_jax(case):
    """Each op's outputs, then the gradient of Σ outputs·cotangents (the
    cotangents N(0, 1) from the case's seed) with respect to its
    differentiable inputs, on the same inputs in both packages.  Outputs
    at the case's rtol / atol; a gradient at its rtol and at atol times its
    largest magnitude (at least 1): an entry that sums terms of that size
    carries their rounding."""
    c = CASES[case]
    jfn = functools.partial(jreg.get(c.op).fn, **c.attrs)
    jin = [jnp.asarray(a) for a in c.inputs]
    tin = [torch.from_numpy(a.copy()) for a in c.inputs]
    rng = np.random.RandomState(zlib.crc32(("ct" + case).encode()))
    grads = c.grad and c.op != "MakeLoss"

    def jf(*diff):
        args = list(jin)
        for i, d in zip(c.grad, diff):
            args[i] = d
        return tuple(_outs(jfn(*args)))

    def both(diff, cts):  # outputs and their vjp in one trace (one compile)
        out, vjp = jax.vjp(jf, *diff)
        return out, vjp(cts)

    if grads:
        shapes = (jf if c.op in _EAGER else functools.partial(jax.eval_shape, jf))(
            *[jin[i] for i in c.grad])
        cts = [rng.standard_normal(tuple(sd.shape)).astype(np.float32) for sd in shapes]
        run = both if c.op in _EAGER else jax.jit(both)
        ref, jgrads = run([jin[i] for i in c.grad], tuple(jnp.asarray(t) for t in cts))
    else:
        ref = jf() if c.op in _EAGER else jax.jit(jf)()
        cts = [rng.standard_normal(np.shape(r)).astype(np.float32) for r in ref]
    with tmx.cpu():
        got = _outs(treg.get(c.op).fn(*tin, **c.attrs))
    assert len(got) == len(ref), case
    for g, r in zip(got, ref):
        g, r = g.detach().numpy(), _np(r)
        assert g.shape == r.shape, (case, g.shape, r.shape)
        if c.exact:
            np.testing.assert_array_equal(g.astype(r.dtype), r, err_msg=case)
        else:
            np.testing.assert_allclose(g, r, rtol=c.rtol, atol=c.atol, err_msg=case)
    if not c.grad:
        return
    if c.op == "MakeLoss":
        # the JAX op's custom_vjp keeps a dtype among its residuals, which
        # jax.vjp rejects: hold the port against the JAX backward rule itself
        from mxnet_tpu.ops import nn as jnn
        jgrads = jnn._make_loss_bwd(c.attrs["grad_scale"], c.attrs["normalization"],
                                    (jin[0].shape, jin[0].dtype), cts[0])
    for i in c.grad:
        tin[i].requires_grad_()
    with tmx.cpu():
        outs = _outs(treg.get(c.op).fn(*tin, **c.attrs))
    tgrads = torch.autograd.grad(outs, [tin[i] for i in c.grad],
                                 [torch.from_numpy(t) for t in cts], allow_unused=True)
    for i, tg, jg in zip(c.grad, tgrads, jgrads):
        tg = np.zeros(c.inputs[i].shape, np.float32) if tg is None else tg.numpy()
        jg = _np(jg)
        scale = max(1.0, float(np.abs(jg).max()))
        np.testing.assert_allclose(tg, jg, rtol=c.rtol, atol=c.atol * scale,
                                   err_msg="%s d/d input %d" % (case, i))


def test_frontends_reach_the_new_ops():
    """``mx.nd.Custom`` under autograd (the prop's backward, whatever the
    head gradient), rrelu's training draw from ``mx.random``, and an
    executor that updates ``IdentityAttachKLSparseReg``'s moving average
    after a training forward, as the JAX executor does."""
    rng = np.random.RandomState(3)
    x = rng.uniform(-2, 2, (4, 5)).astype(np.float32)
    label = np.array([0, 3, 4, 1], np.float32)
    with tmx.cpu():
        data = tmx.nd.array(x)
        data.attach_grad()
        with tmx.autograd.record():
            out = tmx.nd.Custom(data, tmx.nd.array(label), op_type="numpy_softmax")
        out.backward(tmx.nd.array(np.full((4, 5), 3.0, np.float32)))
        p = np.exp(x - x.max(1, keepdims=True))
        p /= p.sum(1, keepdims=True)
        np.testing.assert_allclose(out.asnumpy(), p, rtol=1e-6)
        p[np.arange(4), label.astype(int)] -= 1
        np.testing.assert_allclose(data.grad.asnumpy(), p, rtol=1e-6)
        draws = []
        for _ in range(2):
            tmx.random.seed(7)
            with tmx.autograd.record():
                draws.append(tmx.nd.LeakyReLU(tmx.nd.array(-np.ones(1000, np.float32)),
                                              act_type="rrelu").asnumpy())
        assert np.array_equal(draws[0], draws[1])
        assert 0.125 <= -draws[0].max() and -draws[0].min() <= 0.334
        assert draws[0].std() > 0.01
    sym = tmx.sym.IdentityAttachKLSparseReg(tmx.sym.Variable("data"), name="kl", momentum=0.5)
    exe = sym.simple_bind(device="cpu", data=(4, 3))
    assert exe.aux_dict["kl_moving_avg"].shape == (3,)
    exe.aux_dict["kl_moving_avg"].fill_(0.2)
    act = rng.uniform(0.1, 0.9, (4, 3)).astype(np.float32)
    exe.forward(is_train=True, data=act)
    np.testing.assert_allclose(exe.aux_dict["kl_moving_avg"].numpy(),
                               0.5 * 0.2 + 0.5 * act.mean(0), rtol=1e-6)


def test_deconvolution_target_shape_sets_pad_and_adj():
    """``target_shape`` sets pad and adj by the reference's rule (the surplus
    over the target halved up for pad, its parity for adj), where the JAX op
    ignores it and keeps the natural size (ROADMAP §C)."""
    rng = np.random.RandomState(9)
    x, w = rng.randn(1, 2, 5, 5).astype(np.float32), rng.randn(2, 3, 3, 3).astype(np.float32)
    attrs = dict(kernel=(3, 3), num_filter=3, stride=(2, 2))
    deconv = treg.get("Deconvolution").fn
    for target, pad, adj in (((10, 11), (1, 0), (1, 0)), ((9, 8), (1, 2), (0, 1))):
        got = deconv(torch.from_numpy(x), torch.from_numpy(w), target_shape=target, **attrs)
        assert tuple(got.shape[2:]) == target
        want = deconv(torch.from_numpy(x), torch.from_numpy(w), pad=pad, adj=adj, **attrs)
        assert torch.equal(got, want)
        ref = jreg.get("Deconvolution").fn(jnp.asarray(x), jnp.asarray(w), target_shape=target,
                                           **attrs)
        assert ref.shape[2:] == (11, 11)

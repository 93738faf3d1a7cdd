"""The bf16 kernels and ops of the port (mxnet_tpu_torch) against the JAX
package's, on the CPU: the four bf16 kernel contracts (plain versions here)
against the Pallas kernels in interpret mode, and the deformable ops and
BatchNorm in bf16 against the JAX ops.  The tiny model in bf16 is
tests/test_torch_bf16_rfcn.py.

bf16 values cross between the two sides as float32 numpy arrays holding
bf16-representable values, cast to bf16 on each side (exactly).

Tolerances: a kernel's bf16 output within 1 bf16 ulp of the TPU kernel's
(fp32 sums of the same products in another order, rounded once), its fp32
outputs at the fp32 tolerances of tests/test_torch_kernels.py; ops rtol
1e-2 (bf16 rounding at other places in the two frameworks).
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.ops import detection as jdet
from mxnet_tpu.ops import nn as jnn
from mxnet_tpu.ops.pallas_kernels import dconv_col_pallas, psroi_abuild_pallas
from mxnet_tpu_torch.ops import detection as tdet
from mxnet_tpu_torch.ops import kernels
from mxnet_tpu_torch.ops import nn as tnn

BF = torch.bfloat16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread keeps this file off
    the cores that the suite's parallel workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf(a):
    """float32 numpy -> the same values rounded to bf16, as float32 numpy."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(BF).float().numpy()


def _tb(a):
    """float32 numpy holding bf16 values -> a bf16 tensor (exact)."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(BF)


def _jb(a):
    return jnp.asarray(np.asarray(a, np.float32), jnp.bfloat16)


def _np(a):
    """a torch tensor or JAX array of any float dtype -> float32 numpy."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def bf16_ulp(x):
    """The spacing of bf16 values at |x| (8 significand bits)."""
    _, e = np.frexp(np.maximum(np.abs(x), np.float32(2.0 ** -126)))
    return np.ldexp(np.float32(1.0), e - 8)


def assert_within_ulp(got, ref, ulps=1, what=""):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, what
    bad = np.abs(got - ref) > ulps * bf16_ulp(ref)
    assert not bad.any(), "%s: %d of %d values more than %d bf16 ulp apart, e.g. %s vs %s" % (
        what, bad.sum(), bad.size, ulps, got[bad][:4], ref[bad][:4])


# -- the four kernel contracts ----------------------------------------------


def _dconv_inputs(rng, BG=3, N=70, H=9, W=11, C=16):
    y0 = rng.randint(0, H, (BG, N)).astype(np.int32)
    x0 = rng.randint(0, W, (BG, N)).astype(np.int32)
    y0[:, :7] = H - 1   # clamped rows: y1 == y0
    x0[:, 3:10] = W - 1  # clamped columns: x1 == x0
    y1 = np.minimum(y0 + 1, H - 1).astype(np.int32)
    x1 = np.minimum(x0 + 1, W - 1).astype(np.int32)
    ly = rng.rand(BG, N).astype(np.float32)
    lx = rng.rand(BG, N).astype(np.float32)
    lf = (rng.rand(BG, N) > 0.2).astype(np.float32)
    ft = _bf(rng.randn(BG, H * W, C))
    return (y0, y1, x0, x1, ly, lx, lf, ft), (H, W)


def _jax_dconv_args(args):
    return [*map(jnp.asarray, args[:7]), _jb(args[7])]


def _torch_dconv_args(args):
    return [*map(torch.from_numpy, args[:7]), _tb(args[7])]


def test_dconv_col_bf16_plain_matches_pallas_interpret():
    """A rounded to bf16, times bf16 ft, summed in fp32, rounded once."""
    args, hw = _dconv_inputs(np.random.RandomState(20))
    ref = dconv_col_pallas(*_jax_dconv_args(args), hw, True)
    assert ref.dtype == jnp.bfloat16
    got = kernels.dconv_col(*_torch_dconv_args(args), hw)
    assert got.dtype == BF and got.stride() == (16 * 70, 1, 70)
    assert_within_ulp(got, ref, what="col")


@functools.lru_cache(maxsize=None)
def _dconv_bwd_case():
    """Inputs, cotangent and the Pallas kernel's VJP in interpret mode,
    computed once for the four ways the port is called."""
    rng = np.random.RandomState(21)
    args, hw = _dconv_inputs(rng)
    g = _bf(rng.randn(*args[0].shape, args[7].shape[2]))
    ja = _jax_dconv_args(args)
    _, vjp = jax.vjp(lambda ly, lx, lf, ft: dconv_col_pallas(*ja[:4], ly, lx, lf, ft,
                                                             hw, True), *ja[4:])
    return args, hw, g, vjp(_jb(g))


@pytest.mark.parametrize("g_layout", ["contiguous", "channel_major"])
@pytest.mark.parametrize("via", ["wrapper", "function"])
def test_dconv_col_bwd_bf16_plain_matches_pallas_vjp(via, g_layout):
    """d_ly, d_lx, d_lf fp32 from fp32 factor planes; d_ft = bf16(A)ᵀ·g
    summed in fp32 and rounded once, in bf16."""
    args, hw, g, ref = _dconv_bwd_case()
    gt = _tb(g)
    if g_layout == "channel_major":
        gt = gt.transpose(1, 2).contiguous().transpose(1, 2)
    t = _torch_dconv_args(args)
    if via == "wrapper":
        got = kernels.dconv_col_bwd(*t, gt, hw)
    else:
        leaves = [a.requires_grad_() for a in t[4:]]
        got = torch.autograd.grad(kernels.DConvCol.apply(*t[:4], *leaves, hw),
                                  leaves, gt)
    assert [a.dtype for a in got] == [torch.float32] * 3 + [BF]
    assert ref[3].dtype == jnp.bfloat16
    # fp32 sums over C (the row gradients) in another order
    for name, r, a in zip(("d_ly", "d_lx", "d_lf"), ref, got):
        np.testing.assert_allclose(_np(a), _np(r), rtol=1e-5, atol=1e-5, err_msg=name)
    assert_within_ulp(got[3], ref[3], what="d_ft")


def _dconv_path_inputs(rng, DG, H, W, C, px, k):
    """Factors as deformable_convolution builds them (k x k taps at dilation
    2, the output the map's size, rows laid out (tap, ho, wo)) for offsets
    uniform in +-px pixels, with another tenth of the rows dead (lf = 0),
    and a bf16 ft: the inputs of the card's bf16 designs at their edges."""
    off = rng.uniform(-px, px, (1, 2 * DG * k * k, H, W)).astype(np.float32)
    fac = [f.numpy() for f in tdet.dconv_sample_factors(
        torch.from_numpy(off), (H, W), (k, k), (1, 1), (2, 2), (k - 1, k - 1))]
    fac[6] = np.where(rng.rand(*fac[6].shape) < 0.1, 0, fac[6]).astype(np.float32)
    return (*fac, _bf(rng.randn(DG, H * W, C))), (H, W)


# (DG, H, W, C, offset px, taps): C = 4, 8 and 12 (a tensor-core n-tile of
# the card's backward in part, whole, and one and a half); maps whose Ho, Wo
# are no multiples of its 4 x 8 tile; +-3 px offsets (windows that overflow
# its shared memory at full size); 25 taps (its row design)
DCONV_EDGE_SHAPES = [(2, 5, 7, 4, 1.0, 3), (2, 5, 7, 8, 1.0, 3), (1, 6, 9, 12, 3.0, 3),
                     (1, 5, 6, 8, 1.0, 5)]


@pytest.mark.parametrize("shape", DCONV_EDGE_SHAPES)
def test_dconv_bf16_plain_matches_pallas_at_the_card_designs_edges(shape):
    """The card tests' oracle (the plain versions) against the Pallas
    kernel and its VJP in interpret mode, on factors with dead rows and
    clamped corners at the last row and column, and a channel-major g with
    the rows' layout, as the backward's tiled design takes them."""
    DG, H, W, C, px, k = shape
    rng = np.random.RandomState(40 + C + k)
    args, hw = _dconv_path_inputs(rng, DG, H, W, C, px, k)
    y0, y1, x0, x1, _, _, lf = args[:7]
    live = lf != 0
    assert (~live).any() and (live & (y0 == H - 1) & (y1 == y0)).any()
    assert (live & (x0 == W - 1) & (x1 == x0)).any()
    N = y0.shape[1]
    g = _bf(rng.randn(DG, N, C))
    ja = _jax_dconv_args(args)
    col, vjp = jax.vjp(lambda ly, lx, lf, ft: dconv_col_pallas(*ja[:4], ly, lx, lf, ft, hw,
                                                               True), *ja[4:])
    ref = vjp(_jb(g))
    t = _torch_dconv_args(args)
    assert_within_ulp(kernels.dconv_col(*t, hw), col, what="col")
    gt = _tb(g).transpose(1, 2).contiguous().transpose(1, 2)  # channel-major
    got = kernels.dconv_col_bwd(*t, gt, hw, (k * k, H, W))
    for name, r, a in zip(("d_ly", "d_lx", "d_lf"), ref, got):
        np.testing.assert_allclose(_np(a), _np(r), rtol=1e-5, atol=1e-5, err_msg=name)
    assert_within_ulp(got[3], ref[3], what="d_ft")


@pytest.mark.parametrize("shape", [(70, 16, 13, 21), (20, 1, 38, 64), (33, 16, 38, 61)])
def test_psroi_abuild_bf16_plain_matches_pallas_interpret(shape):
    """yv, xv fp32, the sum over s fp32, only the store rounds to bf16."""
    n, s, h, w = shape
    rng = np.random.RandomState(22)
    yv = rng.rand(n, s, h).astype(np.float32)
    xv = rng.rand(n, s, w).astype(np.float32)
    ref = psroi_abuild_pallas(jnp.asarray(yv), jnp.asarray(xv), jnp.bfloat16, True)
    got = kernels.psroi_abuild(torch.from_numpy(yv), torch.from_numpy(xv), BF)
    assert got.dtype == BF and ref.dtype == jnp.bfloat16
    assert_within_ulp(got, ref, what="A")


@functools.lru_cache(maxsize=None)
def _abuild_bwd_case(shape):
    """Inputs, a bf16 cotangent and the Pallas kernel's VJP in interpret
    mode, computed once per shape for both ways the port is called."""
    n, s, h, w = shape
    rng = np.random.RandomState(23)
    yv = rng.rand(n, s, h).astype(np.float32)
    xv = rng.rand(n, s, w).astype(np.float32)
    g = _bf(rng.randn(n, h, w))
    _, vjp = jax.vjp(lambda y, x: psroi_abuild_pallas(y, x, jnp.bfloat16, True),
                     jnp.asarray(yv), jnp.asarray(xv))
    return yv, xv, g, vjp(_jb(g))


@pytest.mark.parametrize("shape", [(70, 16, 13, 21), (33, 16, 38, 61)])
@pytest.mark.parametrize("via", ["wrapper", "function"])
def test_psroi_abuild_bwd_bf16_plain_matches_pallas_vjp(shape, via):
    """A bf16 cotangent, upcast to fp32; dyv and dxv in fp32."""
    yv, xv, g, ref = _abuild_bwd_case(shape)
    if via == "wrapper":
        got = kernels.psroi_abuild_bwd(torch.from_numpy(yv), torch.from_numpy(xv), _tb(g))
    else:
        leaves = [torch.from_numpy(yv).requires_grad_(), torch.from_numpy(xv).requires_grad_()]
        got = torch.autograd.grad(kernels.PSROIABuild.apply(*leaves, BF), leaves, _tb(g))
    # fp32 sums of up to 64 products, in another order
    for r, a in zip(ref, got):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(_np(a), _np(r), rtol=1e-5, atol=1e-5)


def test_bf16_cpu_calls_take_the_plain_versions_and_count_no_launch():
    rng = np.random.RandomState(24)
    kernels.reset_launches()
    args, hw = _dconv_inputs(rng, BG=1, N=10, H=4, W=5, C=3)
    t = _torch_dconv_args(args)
    kernels.dconv_col(*t, hw)
    kernels.dconv_col_bwd(*t, torch.rand(1, 10, 3).to(BF), hw)
    kernels.psroi_abuild(torch.rand(4, 2, 3), torch.rand(4, 2, 5), BF)
    kernels.psroi_abuild_bwd(torch.rand(4, 2, 3), torch.rand(4, 2, 5),
                             torch.rand(4, 3, 5).to(BF))
    assert all(k.wrapper.launches == 0 for k in kernels.KERNELS.values())
    for name in ("dconv_col", "dconv_col_bwd", "psroi_abuild", "psroi_abuild_bwd"):
        bf = kernels.KERNELS[name + "[bf16]"]
        assert bf.wrapper.__name__ == name + "_bf16"
        assert bf.source == kernels.KERNELS[name].source


@pytest.mark.parametrize("call", ["dconv_col", "dconv_col_bwd", "psroi_abuild",
                                  "psroi_abuild_bwd", "dconv_col_bf16",
                                  "psroi_abuild_bwd_bf16", "deformable_convolution",
                                  "deformable_psroi_pooling"])
def test_float16_is_rejected(call):
    rng = np.random.RandomState(25)
    args, hw = _dconv_inputs(rng, BG=1, N=10, H=4, W=5, C=3)
    t = list(map(torch.from_numpy, args))
    h = torch.float16
    with pytest.raises(ValueError, match="float16|bfloat16"):
        if call == "dconv_col":
            kernels.dconv_col(*t[:7], t[7].to(h), hw)
        elif call == "dconv_col_bf16":
            kernels.dconv_col_bf16(*t, hw)  # fp32 ft: the bf16 instance refuses it
        elif call == "dconv_col_bwd":
            kernels.dconv_col_bwd(*t[:7], t[7].to(h), torch.rand(1, 10, 3).to(h), hw)
        elif call == "psroi_abuild":
            kernels.psroi_abuild(torch.rand(4, 2, 3), torch.rand(4, 2, 5), h)
        elif call == "psroi_abuild_bwd":
            kernels.psroi_abuild_bwd(torch.rand(4, 2, 3), torch.rand(4, 2, 5),
                                     torch.rand(4, 3, 5).to(h))
        elif call == "psroi_abuild_bwd_bf16":
            kernels.psroi_abuild_bwd_bf16(torch.rand(4, 2, 3), torch.rand(4, 2, 5),
                                          torch.rand(4, 3, 5))
        elif call == "deformable_convolution":
            tdet.deformable_convolution(torch.rand(1, 2, 5, 5, dtype=h),
                                        torch.zeros(1, 18, 5, 5, dtype=h),
                                        torch.rand(2, 2, 3, 3, dtype=h), kernel=3,
                                        num_filter=2, pad=1)
        else:
            tdet.deformable_psroi_pooling(
                torch.rand(1, 8, 6, 6, dtype=h), torch.tensor([[0, 1.0, 1, 8, 8]]),
                spatial_scale=0.5, output_dim=2, group_size=2, pooled_size=2,
                no_trans=True)


# -- the ops in bf16 ---------------------------------------------------------


def _dconv_op_inputs(seed):
    """32×32 map, 3×3 taps at dilation 2: N·H·W = 9·32⁴ ≥ 2²², the JAX op's
    separable one-hot path."""
    rng = np.random.RandomState(seed)
    B, C, F, K, S = 1, 4, 4, 3, 32
    x = _bf(rng.randn(B, C, S, S))
    off = _bf(rng.randn(B, 2 * K * K, S, S) * 1.5)
    w = _bf(rng.randn(F, C, K, K) * 0.3)
    ct = _bf(rng.randn(B, F, S, S))
    kw = dict(kernel=(K, K), num_filter=F, stride=(1, 1), dilate=(2, 2),
              pad=(2, 2), num_deformable_group=1, no_bias=True)
    assert K * K * S ** 4 >= (1 << 22)
    return x, off, w, ct, kw


def test_deformable_convolution_bf16_matches_jax():
    x, off, w, _, kw = _dconv_op_inputs(30)
    ref = jdet.deformable_convolution(_jb(x), _jb(off), _jb(w), **kw)
    got = tdet.deformable_convolution(_tb(x), _tb(off), _tb(w), **kw)
    assert got.dtype == BF and ref.dtype == jnp.bfloat16
    # bf16 columns (the same bits but for one-ulp sums) and a 36-term bf16
    # product, rounded at other places
    np.testing.assert_allclose(_np(got), _np(ref), rtol=1e-2,
                               atol=1e-2 * np.abs(_np(ref)).max())


def test_deformable_sample_positions_are_bf16_for_a_bf16_offset():
    """The live test sees bf16 positions, as the JAX op's int + bf16 sum
    promotes to bf16: an offset that is live in fp32 may be dead in bf16."""
    H = W = 40
    off = torch.zeros(1, 18, H, W)
    off[0, 0] = -0.0001  # tap 0's Δy at (ho, wo): the base row is ho − 2
    off[0, 0, 2] = 0.001  # base row 0 + 0.001: fp32 and bf16 both live
    facs = [tdet.dconv_sample_factors(off.to(dt), (H, W), (3, 3), (1, 1), (2, 2),
                                      (2, 2)) for dt in (torch.float32, BF)]
    # base row 35 - 0.0001 is 34.9999 in fp32 (y0 = 34) and rounds to 35 in
    # bf16 (y0 = 35), as JAX computes it
    row = 37 * W + 5
    assert int(facs[0][0][0, row]) == 34 and int(facs[1][0][0, row]) == 35
    ref = np.asarray(((jnp.arange(2) - 1)[:, None] + jnp.asarray([0.3, 1.7], jnp.bfloat16))
                     .astype(jnp.float32))
    got = ((torch.arange(2) - 1)[:, None].to(BF) + torch.tensor([0.3, 1.7], dtype=BF)).float()
    np.testing.assert_array_equal(got.numpy(), ref)


def test_deformable_convolution_bf16_gradients_match_jax(monkeypatch):
    """Gradients of data, offset and weight, the JAX side through the
    Pallas kernel's custom VJP in interpret mode.  Eager, not jitted: under
    ``jax.jit`` XLA:CPU keeps the int + bf16 sample positions in fp32
    (excess precision), while the op as written, and run op by op, rounds
    them to bf16."""
    monkeypatch.setenv("MXNET_DCONV_IMPL", "pallas")
    x, off, w, ct, kw = _dconv_op_inputs(31)
    ref = jax.grad(
        lambda *a: (jdet.deformable_convolution(*a, **kw).astype(jnp.float32)
                    * jnp.asarray(ct)).sum(), argnums=(0, 1, 2))(_jb(x), _jb(off), _jb(w))
    leaves = [_tb(a).requires_grad_() for a in (x, off, w)]
    (tdet.deformable_convolution(*leaves, **kw).float() * torch.from_numpy(ct)).sum().backward()
    for name, r, leaf in zip(("data", "offset", "weight"), ref, leaves):
        assert leaf.grad.dtype == BF and r.dtype == jnp.bfloat16
        r = _np(r)
        np.testing.assert_allclose(_np(leaf.grad), r, rtol=1e-2,
                                   atol=1e-2 * np.abs(r).max(), err_msg=name)


def _psroi_op_inputs(seed, B=2, H=10, W=12, k=3, spp=4, Rb=32, OD=8, ncls=2):
    """R·K·PH·PW·spp²·cpc ≥ 2¹⁶ (64·2·9·16·4 at the defaults): the JAX op's
    one-hot path."""
    rng = np.random.RandomState(seed)
    data = _bf(rng.randn(B, OD * k * k, H, W))
    x1 = rng.uniform(-10, 2 * W - 10, (B * Rb,))
    y1 = rng.uniform(-10, 2 * H - 10, (B * Rb,))
    rois = np.stack([np.arange(B * Rb) // Rb, x1, y1, x1 + rng.uniform(2, W, x1.shape),
                     y1 + rng.uniform(2, H, y1.shape)], 1).astype(np.float32)
    trans = _bf(rng.randn(B * Rb, 2 * ncls, k, k) * 0.5)
    ct = _bf(rng.randn(B * Rb, OD, k, k))
    kw = dict(spatial_scale=0.5, output_dim=OD, group_size=k, pooled_size=k,
              part_size=k, sample_per_part=spp, trans_std=0.1, rois_per_image=Rb)
    assert B * Rb * ncls * k * k * spp * spp * (OD // ncls) >= (1 << 16)
    return data, rois, trans, ct, kw


def test_deformable_psroi_pooling_bf16_matches_jax():
    data, rois, trans, _, kw = _psroi_op_inputs(32)
    ref = jdet.deformable_psroi_pooling(_jb(data), jnp.asarray(rois), _jb(trans), **kw)
    got = tdet.deformable_psroi_pooling(_tb(data), torch.from_numpy(rois), _tb(trans), **kw)
    assert got.dtype == BF and ref.dtype == jnp.bfloat16
    # bf16 A and a bf16 plane product, rounded at other places
    np.testing.assert_allclose(_np(got), _np(ref), rtol=1e-2,
                               atol=1e-2 * np.abs(_np(ref)).max())


def test_deformable_psroi_pooling_bf16_gradients_match_jax(monkeypatch):
    """Gradients of the score maps and the offsets, the JAX side through the
    Pallas A-build's custom VJP in interpret mode; eager, as the dconv
    gradients (under ``jax.jit`` the bf16 ``trans·trans_std`` keeps fp32
    precision)."""
    monkeypatch.setenv("MXNET_ABUILD_IMPL", "pallas")
    # 2×2 bins, 8 channels a class: at the one-hot threshold with fewer
    # interpreted kernel calls
    data, rois, trans, ct, kw = _psroi_op_inputs(33, k=2, OD=16)
    ref = jax.grad(
        lambda d, t: (jdet.deformable_psroi_pooling(d, jnp.asarray(rois), t, **kw)
                      .astype(jnp.float32) * jnp.asarray(ct)).sum(),
        argnums=(0, 1))(_jb(data), _jb(trans))
    leaves = [_tb(data).requires_grad_(), _tb(trans).requires_grad_()]
    (tdet.deformable_psroi_pooling(leaves[0], torch.from_numpy(rois), leaves[1], **kw)
     .float() * torch.from_numpy(ct)).sum().backward()
    for name, r, leaf in zip(("data", "trans"), ref, leaves):
        assert leaf.grad.dtype == BF
        r = _np(r)
        np.testing.assert_allclose(_np(leaf.grad), r, rtol=1e-2,
                                   atol=1e-2 * np.abs(r).max(), err_msg=name)


@pytest.mark.parametrize("stats", ["fp32", "bf16"])
def test_batch_norm_bf16_data(stats):
    """bf16 data and γ, β with fp32 running statistics (the bf16 train
    step: scale and shift in fp32, cast to bf16), or with bf16 statistics
    (a model after ``cast``)."""
    rng = np.random.RandomState(34)
    x = _bf(rng.randn(2, 5, 4, 3))
    g, b = _bf(rng.randn(5)), _bf(rng.randn(5))
    m, v = rng.randn(5).astype(np.float32), rng.rand(5).astype(np.float32) + 0.1
    if stats == "bf16":
        m, v = _bf(m), _bf(v)
    conv = (lambda a: _jb(a)) if stats == "bf16" else jnp.asarray
    ref = jnn.batch_norm(_jb(x), _jb(g), _jb(b), conv(m), conv(v), eps=1e-5,
                         fix_gamma=False, use_global_stats=True)[0]
    tconv = _tb if stats == "bf16" else torch.from_numpy
    got = tnn.batch_norm(_tb(x), _tb(g), _tb(b), tconv(m), tconv(v), eps=1e-5,
                         fix_gamma=False)
    assert got.dtype == BF and ref.dtype == jnp.bfloat16
    np.testing.assert_allclose(_np(got), _np(ref), rtol=1e-2, atol=1e-2)

"""The port's kernels (mxnet_tpu_torch/ops/kernels.py) against the JAX package.

On the CPU each wrapper runs its plain PyTorch version; those are held here
against the JAX formulations on the same numpy inputs (Pallas kernels in
interpret mode).  tests/test_torch_cuda.py holds the CUDA kernels against
these plain versions on the card.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.ops.detection import _nms_alive_blocked_xla
from mxnet_tpu.ops.pallas_kernels import (dconv_col_pallas, nms_alive_pallas,
                                          psroi_abuild_pallas)
from mxnet_tpu_torch.ops import kernels


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread keeps this file off
    the cores that the suite's parallel workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _clustered_boxes(rng, B, n, extent=600.0, clusters=12):
    """Score-ordered boxes jittered around a few centres, so that many are
    suppressed; about 3% are inverted (degenerate, zero area)."""
    ctr = rng.uniform(0, extent, (B, clusters, 2))
    pick = rng.randint(0, clusters, (B, n))
    c = np.take_along_axis(ctr, pick[..., None], axis=1) + rng.normal(0, 6, (B, n, 2))
    wh = rng.uniform(20, 120, (B, n, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], -1)
    inv = rng.rand(B, n) < 0.03
    boxes[inv] = boxes[inv][:, [2, 3, 0, 1]]
    return boxes.astype(np.float32)


_jnms = jax.jit(_nms_alive_blocked_xla, static_argnums=(1, 2, 3, 6))


def _jax_nms(boxes, thresh, plus_one, valid, ids=None):
    """The JAX reference, image by image (it takes one (N, 4) set)."""
    return np.stack([np.asarray(_jnms(
        jnp.asarray(boxes[b]), thresh, 256, plus_one, jnp.asarray(valid[b]),
        None if ids is None else jnp.asarray(ids[b]), ids is None))
        for b in range(boxes.shape[0])])


# exact equality: the survivor mask is the greedy scan's, computed with the
# same IoU operation order on both sides
@pytest.mark.parametrize("n", [100, 700, 1500])
@pytest.mark.parametrize("plus_one", [0.0, 1.0])
def test_nms_plain_matches_jax_blocked(n, plus_one):
    rng = np.random.RandomState(n + int(plus_one))
    boxes = _clustered_boxes(rng, 2, n)
    valid = rng.rand(2, n) > 0.1
    ref = _jax_nms(boxes, 0.5, plus_one, valid)
    got = kernels.nms_alive_plain(torch.from_numpy(boxes), torch.from_numpy(valid),
                                  thresh=0.5, plus_one=plus_one).numpy()
    assert 0 < ref.sum() < valid.sum()  # many suppressed, some survive
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("n", [100, 700])
def test_nms_plain_per_class_ids(n):
    rng = np.random.RandomState(7 + n)
    boxes = _clustered_boxes(rng, 2, n)
    valid = rng.rand(2, n) > 0.05
    ids = rng.randint(0, 4, (2, n)).astype(np.int32)
    ref = _jax_nms(boxes, 0.5, 0.0, valid, ids)
    got = kernels.nms_alive_plain(
        torch.from_numpy(boxes), torch.from_numpy(valid), torch.from_numpy(ids),
        thresh=0.5, plus_one=0.0).numpy()
    np.testing.assert_array_equal(got, ref)


def test_nms_plain_matches_pallas_interpret():
    rng = np.random.RandomState(11)
    n = 300
    boxes = _clustered_boxes(rng, 1, n)
    valid = rng.rand(1, n) > 0.1
    ref = np.asarray(nms_alive_pallas(jnp.asarray(boxes[0]), jnp.asarray(valid[0]),
                                      None, thresh=0.7, plus_one=1.0,
                                      interpret=True))
    got = kernels.nms_alive(torch.from_numpy(boxes), torch.from_numpy(valid),
                            thresh=0.7, plus_one=1.0).numpy()[0]
    np.testing.assert_array_equal(got, ref)


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
    ft = rng.randn(BG, H * W, C).astype(np.float32)
    return (y0, y1, x0, x1, ly, lx, lf, ft), (H, W)


def test_dconv_plain_matches_pallas_interpret():
    rng = np.random.RandomState(0)
    args, hw = _dconv_inputs(rng)
    ref = np.asarray(dconv_col_pallas(*map(jnp.asarray, args), hw, True))
    got = kernels.dconv_col(*map(torch.from_numpy, args), hw).numpy()
    # at most four non-zero fp32 products per output, summed in another order
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


# (N, S, H, W): a small R-FCN-like shape, then the card kernels' edge shapes
# S = 1 and W not a multiple of 4
ABUILD_SHAPES = [(70, 16, 13, 21), (20, 1, 38, 64), (33, 16, 38, 61)]


@pytest.mark.parametrize("shape", ABUILD_SHAPES)
def test_abuild_plain_matches_pallas_interpret(shape):
    n, s, h, w = shape
    rng = np.random.RandomState(3)
    yv = rng.rand(n, s, h).astype(np.float32)
    xv = rng.rand(n, s, w).astype(np.float32)
    ref = np.asarray(psroi_abuild_pallas(jnp.asarray(yv), jnp.asarray(xv),
                                         jnp.float32, True))
    got = kernels.psroi_abuild(torch.from_numpy(yv), torch.from_numpy(xv)).numpy()
    # an S-term fp32 sum (S <= 16) of values in [0, 1) in another order
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


# how the backward is reached: the wrapper, or DConvCol's autograd; g
# contiguous or channel-major
@pytest.mark.parametrize("g_layout", ["contiguous", "channel_major"])
@pytest.mark.parametrize("via", ["wrapper", "function"])
def test_dconv_bwd_plain_matches_pallas_vjp(via, g_layout):
    """All four cotangents of the TPU kernel's custom VJP, clamped rows and
    columns and dead rows included."""
    _check_dconv_bwd_against_pallas_vjp(via, g_layout, None)


# the rows' layout (K2, Ho, Wo) given, as deformable_convolution gives it
@pytest.mark.parametrize("g_layout", ["contiguous", "channel_major"])
@pytest.mark.parametrize("via", ["wrapper", "function"])
def test_dconv_bwd_with_a_row_layout_matches_pallas_vjp(via, g_layout):
    _check_dconv_bwd_against_pallas_vjp(via, g_layout, (2, 5, 7))


def _check_dconv_bwd_against_pallas_vjp(via, g_layout, layout):
    rng = np.random.RandomState(1)
    args, hw = _dconv_inputs(rng)
    ints, flts = args[:4], args[4:]
    g = rng.randn(*args[0].shape, args[7].shape[2]).astype(np.float32)
    col, vjp = jax.vjp(
        lambda ly, lx, lf, ft: dconv_col_pallas(*map(jnp.asarray, ints), ly, lx,
                                                lf, ft, hw, True),
        *map(jnp.asarray, flts))
    ref = vjp(jnp.asarray(g))
    gt = torch.from_numpy(g)
    if g_layout == "channel_major":
        gt = gt.transpose(1, 2).contiguous().transpose(1, 2)
    t = list(map(torch.from_numpy, args))
    extra = () if layout is None else (layout,)
    if via == "wrapper":
        got = kernels.dconv_col_bwd(*t, gt, hw, *extra)
    else:
        leaves = [a.requires_grad_() for a in t[4:]]
        got = torch.autograd.grad(kernels.DConvCol.apply(*t[:4], *leaves, hw, *extra),
                                  leaves, gt)
    # fp32 sums over C (row gradients) and over the rows hitting one pixel
    # (d_ft), in another order
    for name, r, t in zip(("d_ly", "d_lx", "d_lf", "d_ft"), ref, got):
        np.testing.assert_allclose(t.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    d_ly, d_lx = got[0].numpy(), got[1].numpy()
    y0, y1, x0, x1 = ints
    assert (d_ly[y0 == y1] == 0).all() and (d_lx[x0 == x1] == 0).all()
    assert (d_ly[y0 != y1] != 0).any() and (d_lx[x0 != x1] != 0).any()


@pytest.mark.parametrize("shape", ABUILD_SHAPES)
def test_abuild_bwd_plain_matches_pallas_vjp(shape):
    n, s, h, w = shape
    rng = np.random.RandomState(4)
    yv = rng.rand(n, s, h).astype(np.float32)
    xv = rng.rand(n, s, w).astype(np.float32)
    g = rng.randn(n, h, w).astype(np.float32)
    _, vjp = jax.vjp(lambda y, x: psroi_abuild_pallas(y, x, jnp.float32, True),
                     jnp.asarray(yv), jnp.asarray(xv))
    ref = vjp(jnp.asarray(g))
    got = kernels.psroi_abuild_bwd(*map(torch.from_numpy, (yv, xv, g)))
    # fp32 sums of products over up to 64 terms, in another order
    for r, t in zip(ref, got):
        np.testing.assert_allclose(t.numpy(), np.asarray(r), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("which", ["dconv", "abuild"])
def test_autograd_function_matches_autograd_through_plain(which):
    """Each Function's backward (the plain backward on the CPU) against
    autograd through the plain forward on the same cotangent."""
    rng = np.random.RandomState(8)
    if which == "dconv":
        args, hw = _dconv_inputs(rng, BG=2, N=40, H=6, W=7, C=5)
        t = [torch.from_numpy(a) for a in args]
        leaves = [a.clone().requires_grad_() for a in t[4:]]
        out_f = kernels.DConvCol.apply(*t[:4], *leaves, hw)
        leaves_p = [a.clone().requires_grad_() for a in t[4:]]
        out_p = kernels.dconv_col_plain(*t[:4], *leaves_p, hw)
    else:
        leaves = [torch.rand(9, 4, 6, requires_grad=True),
                  torch.rand(9, 4, 11, requires_grad=True)]
        out_f = kernels.PSROIABuild.apply(*leaves)
        leaves_p = [a.detach().clone().requires_grad_() for a in leaves]
        out_p = kernels.psroi_abuild_plain(*leaves_p)
    g = torch.from_numpy(rng.randn(*out_f.shape).astype(np.float32))
    got = torch.autograd.grad(out_f, leaves, g)
    ref = torch.autograd.grad(out_p, leaves_p, g)
    # the same sums, grouped differently by the two formulations
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_dconv_function_skips_the_backward_when_nothing_needs_it():
    rng = np.random.RandomState(9)
    args, hw = _dconv_inputs(rng, BG=1, N=10, H=4, W=5, C=3)
    t = [torch.from_numpy(a) for a in args]
    t[6] = t[6].requires_grad_()  # only lf: the backward runs, ft gets none
    (kernels.DConvCol.apply(*t, hw).sum()).backward()
    assert t[6].grad is not None and t[7].grad is None


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    rng = np.random.RandomState(5)
    kernels.reset_launches()
    args, hw = _dconv_inputs(rng, BG=1, N=10, H=4, W=5, C=3)
    t = list(map(torch.from_numpy, args))
    kernels.dconv_col(*t, hw)
    kernels.dconv_col_bwd(*t, torch.rand(1, 10, 3), hw)
    kernels.psroi_abuild(torch.rand(4, 2, 3), torch.rand(4, 2, 5))
    kernels.psroi_abuild_bwd(torch.rand(4, 2, 3), torch.rand(4, 2, 5),
                             torch.rand(4, 3, 5))
    kernels.nms_alive(torch.from_numpy(_clustered_boxes(rng, 1, 20)),
                      torch.ones(1, 20, dtype=torch.bool), thresh=0.5)
    q = kernels.quantize_int8(torch.rand(7), torch.tensor(1.0))
    kernels.dequantize_int8(q, torch.tensor(1.0))
    assert len(kernels.KERNELS) == 7
    assert [k.wrapper.launches for k in kernels.KERNELS.values()] == [0] * 7


@pytest.mark.parametrize("bad", ["ft_dtype", "idx_dtype", "shape"])
def test_dconv_wrapper_rejects_what_the_kernel_does_not_take(bad):
    rng = np.random.RandomState(6)
    args, hw = _dconv_inputs(rng, BG=1, N=10, H=4, W=5, C=3)
    t = list(map(torch.from_numpy, args))
    if bad == "ft_dtype":
        t[7] = t[7].double()
    elif bad == "idx_dtype":
        t[0] = t[0].long()
    else:
        t[4] = t[4][:, :5]
    with pytest.raises(ValueError):
        kernels.dconv_col(*t, hw)


@pytest.mark.parametrize("bad", ["g_dtype", "g_shape", "abuild_g_shape",
                                 "abuild_dtype", "g_strides", "g_batch_strides"])
def test_backward_wrappers_reject_what_the_kernels_do_not_take(bad):
    rng = np.random.RandomState(6)
    args, hw = _dconv_inputs(rng, BG=2, N=10, H=4, W=5, C=3)
    t = list(map(torch.from_numpy, args))
    yv, xv, ga = torch.rand(4, 2, 3), torch.rand(4, 2, 5), torch.rand(4, 3, 5)
    with pytest.raises(ValueError):
        if bad == "g_strides":  # neither contiguous nor channel-major
            kernels.dconv_col_bwd(*t, torch.rand(2, 10, 6)[:, :, ::2], hw)
        elif bad == "g_batch_strides":  # channel-major rows, batches interleaved
            kernels.dconv_col_bwd(*t, torch.rand(3, 2, 10).permute(1, 2, 0), hw)
        elif bad == "g_dtype":
            kernels.dconv_col_bwd(*t, torch.rand(2, 10, 3, dtype=torch.float64), hw)
        elif bad == "g_shape":
            kernels.dconv_col_bwd(*t, torch.rand(2, 10, 4), hw)
        elif bad == "abuild_g_shape":
            kernels.psroi_abuild_bwd(yv, xv, ga[:, :2])
        else:
            kernels.psroi_abuild_bwd(yv.double(), xv.double(), ga.double())


@pytest.mark.parametrize("layout", [(5, 2, 2), (2, 5, 2), (0, 5, 2), (1, 10, 1.5)])
def test_dconv_bwd_wrapper_rejects_a_row_layout_that_is_not_n(layout):
    """K2·Ho·Wo must be N, every part positive and whole."""
    rng = np.random.RandomState(7)
    args, hw = _dconv_inputs(rng, BG=2, N=10, H=4, W=5, C=3)
    t = list(map(torch.from_numpy, args))
    with pytest.raises(ValueError, match="layout"):
        kernels.dconv_col_bwd(*t, torch.rand(2, 10, 3), hw, layout)


def test_dconv_bwd_plain_takes_either_g_layout():
    """The wrapper (the plain version here) gives the same gradients for a
    channel-major g as for the same values laid out contiguously."""
    rng = np.random.RandomState(12)
    args, hw = _dconv_inputs(rng, BG=2, N=36, H=5, W=6, C=7)
    t = list(map(torch.from_numpy, args))
    g = torch.from_numpy(rng.randn(2, 7, 36).astype(np.float32)).transpose(1, 2)
    assert kernels.channel_major(g) and not kernels.channel_major(g.contiguous())
    got = kernels.dconv_col_bwd(*t, g, hw)
    ref = kernels.dconv_col_bwd(*t, g.contiguous(), hw)
    for a, b in zip(got, ref):
        # the same products; a strided bmm may group its sums otherwise
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_build_hash_tracks_the_sources(monkeypatch, tmp_path):
    from mxnet_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "a.cu").write_text("// one\n")
    h1 = _build.source_hash()
    assert _build.source_hash() == h1
    (tmp_path / "a.cu").write_text("// two\n")
    assert _build.source_hash() != h1


def test_build_failure_raises_with_the_compiler_output():
    import sys

    from mxnet_tpu_torch.ops import _build

    ok = [sys.executable, "-c", "print('fine')"]
    bad = [sys.executable, "-c", "import sys; print('boom'); sys.exit(3)"]
    assert _build._run_all([ok]) == ["fine\n"]
    with pytest.raises(RuntimeError, match="boom"):
        _build._run_all([ok, bad])

"""The port's CUDA kernels against their plain PyTorch versions, on the card,
and their autograd Functions.

Every test here needs an NVIDIA GPU and skips without one.  The file imports
no JAX, so that it runs on a machine without it; the repository's conftest
imports JAX, so on such a machine run it as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from mxnet_tpu_torch.ops import kernels

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain dconv's bmm
    return torch.device("cuda")


def _boxes(rng, B, n):
    ctr = rng.uniform(0, 600, (B, 12, 2))
    pick = rng.randint(0, 12, (B, n))
    c = np.take_along_axis(ctr, pick[..., None], axis=1) + rng.normal(0, 6, (B, n, 2))
    wh = rng.uniform(20, 120, (B, n, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], -1)
    inv = rng.rand(B, n) < 0.03
    boxes[inv] = boxes[inv][:, [2, 3, 0, 1]]  # degenerate boxes
    return torch.from_numpy(boxes.astype(np.float32))


@pytest.mark.parametrize("n", [64, 1000, 6000])
@pytest.mark.parametrize("plus_one", [0.0, 1.0])
def test_nms_kernel_bit_identical_to_plain(cuda, n, plus_one):
    rng = np.random.RandomState(n)
    boxes = _boxes(rng, 3, n).to(cuda)
    valid = torch.from_numpy(rng.rand(3, n) > 0.05).to(cuda)
    ids = torch.from_numpy(rng.randint(0, 3, (3, n))).to(cuda)
    for idv in (None, ids):
        before = kernels.nms_alive.launches
        got = kernels.nms_alive(boxes, valid, idv, thresh=0.7, plus_one=plus_one)
        ref = kernels.nms_alive_plain(boxes, valid, idv, thresh=0.7, plus_one=plus_one)
        assert kernels.nms_alive.launches == before + 1
        assert torch.equal(got, ref)  # survivor masks are bit-identical


# N: ROADMAP B2's acceptance sizes (two-stage scan), then one above the
# two-stage scan's shared-memory limit (~14,000: the first scan, by shape)
@pytest.mark.parametrize("n", [100, 300, 700, 6000, 12000, 16000])
def test_nms_kernel_batch_with_ids_and_valid_masks(cuda, n):
    rng = np.random.RandomState(n + 1)
    boxes = _boxes(rng, 2, n).to(cuda)
    valid = torch.from_numpy(np.stack([rng.rand(n) > 0.1, rng.rand(n) > 0.5])).to(cuda)
    ids = torch.from_numpy(rng.randint(0, 4, (2, n))).to(cuda)
    for idv in (None, ids):
        got = kernels.nms_alive(boxes, valid, idv, thresh=0.5, plus_one=1.0)
        ref = kernels.nms_alive_plain(boxes, valid, idv, thresh=0.5, plus_one=1.0)
        assert torch.equal(got, ref)


@pytest.mark.parametrize("case", ["all_survive", "first_kills_all"])
@pytest.mark.parametrize("n", [700, 6000])
def test_nms_kernel_extreme_survivor_counts(cuda, case, n):
    rng = np.random.RandomState(7)
    if case == "all_survive":  # an IoU never exceeds 1
        boxes, thresh = _boxes(rng, 1, n), 1.0
    else:  # one box, repeated with jitter: the first kills every other
        base = np.array([100.0, 100.0, 300.0, 300.0])
        boxes = torch.from_numpy((base + rng.uniform(0, 1, (1, n, 4))).astype(np.float32))
        thresh = 0.7
    boxes = boxes.to(cuda)
    valid = torch.ones((1, n), dtype=torch.bool, device=cuda)
    got = kernels.nms_alive(boxes, valid, thresh=thresh, plus_one=1.0)
    assert torch.equal(got, kernels.nms_alive_plain(boxes, valid, thresh=thresh,
                                                    plus_one=1.0))
    want = n if case == "all_survive" else 1
    assert int(got.sum()) == want


# (BG, N, H, W, C): the serve call at batch 1 and 2; C of one channel, 72
# (a part of one 128-channel pass), 128, 130 (not a multiple of 4), 132 (a
# second pass of four) and 256; N = 500 is no multiple of the tile's 64 rows,
# N = 501 and 22 no multiple of 4
@pytest.mark.parametrize("shape", [(4, 21888, 38, 64, 128), (8, 21888, 38, 64, 128),
                                   (4, 500, 19, 23, 1), (4, 500, 19, 23, 72),
                                   (4, 500, 19, 23, 128), (4, 500, 19, 23, 130),
                                   (3, 500, 19, 23, 132), (2, 500, 19, 23, 256),
                                   (4, 501, 19, 23, 128), (2, 22, 5, 6, 8)])
def test_dconv_kernel_matches_plain(cuda, shape):
    """Clamped corners and dead rows; the column channel-major, strides
    (C·N, 1, N).  Where the tiled design runs, a copy of ft one float off
    16-byte alignment takes the one-thread-per-output kernel, which must
    give the same bits."""
    BG, N, H, W, C = shape
    rng = np.random.RandomState(C + N)
    t = _dconv_args(rng, BG, N, H, W, C, cuda)
    before = kernels.dconv_col.launches
    got = kernels.dconv_col(*t, (H, W))
    assert kernels.dconv_col.launches == before + 1
    assert got.stride() == (C * N, 1, N)
    # at most four fp32 products per output, in another order than the bmm
    torch.testing.assert_close(got, kernels.dconv_col_plain(*t, (H, W)),
                               rtol=1e-5, atol=1e-5)
    if C % 4 == 0 and N % 4 == 0:
        ft = torch.empty(t[7].numel() + 1, device=cuda)[1:].view(t[7].shape).copy_(t[7])
        assert ft.data_ptr() % 16 != 0
        assert torch.equal(kernels.dconv_col(*t[:7], ft, (H, W)), got)


# (N, S, H, W): the serve path's rows; S = 3; more than 48 KB of shared memory
# per roi; W not a multiple of 4; S = 1; H = 1; N = 1; the general path's
# 76 rows; an N that is not a multiple of the rois per block; 200 columns
# (several column groups per lane)
ABUILD_SHAPES = [(300, 16, 38, 64), (7, 3, 5, 200), (20, 16, 800, 64),
                 (33, 16, 38, 61), (20, 1, 38, 64), (20, 16, 1, 64),
                 (1, 16, 38, 64), (300, 16, 76, 64), (6271, 16, 38, 64),
                 (21, 16, 38, 200)]


@pytest.mark.parametrize("shape", ABUILD_SHAPES)
def test_abuild_kernel_matches_plain(cuda, shape):
    n, s, h, w = shape
    rng = np.random.RandomState(n)
    yv = torch.from_numpy(rng.rand(n, s, h).astype(np.float32)).to(cuda)
    xv = torch.from_numpy(rng.rand(n, s, w).astype(np.float32)).to(cuda)
    # a 16-term fp32 sum, fused multiply-adds against separate ones
    torch.testing.assert_close(kernels.psroi_abuild(yv, xv),
                               kernels.psroi_abuild_plain(yv, xv),
                               rtol=1e-5, atol=1e-5)


def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    with pytest.raises(ValueError, match="float32"):
        kernels.psroi_abuild(torch.rand(2, 3, 4, device=cuda, dtype=torch.float64),
                             torch.rand(2, 3, 5, device=cuda, dtype=torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        kernels.psroi_abuild(torch.rand(2, 4, 3, device=cuda).transpose(1, 2),
                             torch.rand(2, 3, 5, device=cuda))
    with pytest.raises(ValueError, match="one device"):
        kernels.nms_alive(torch.rand(1, 5, 4, device=cuda),
                          torch.ones(1, 5, dtype=torch.bool), thresh=0.5)


def _dconv_args(rng, BG, N, H, W, C, dev):
    """Factors with clamped rows and columns and dead rows (lf = 0)."""
    y0 = rng.randint(0, H, (BG, N))
    x0 = rng.randint(0, W, (BG, N))
    y0[:, :20] = H - 1  # clamped corners: y1 == y0
    x0[:, 10:30] = W - 1
    ints = [y0, np.minimum(y0 + 1, H - 1), x0, np.minimum(x0 + 1, W - 1)]
    t = [torch.from_numpy(a.astype(np.int32)).to(dev) for a in ints]
    t += [torch.from_numpy(a.astype(np.float32)).to(dev) for a in (
        rng.rand(BG, N), rng.rand(BG, N), rng.rand(BG, N) > 0.2,
        rng.randn(BG, H * W, C))]
    return t


def _dconv_bwd_check(got, ref, t):
    # sums over C in another order; d_ft sums by atomics in an order that
    # changes from run to run: a tolerance, never bitwise
    for name, a, b in zip(("d_ly", "d_lx", "d_lf", "d_ft"), got, ref):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5 * float(b.abs().max()),
                                   msg=lambda m, n=name: "%s: %s" % (n, m))
    y0, y1, x0, x1, _, _, lf = t[:7]
    assert bool((got[0][y0 == y1] == 0).all()) and bool((got[1][x0 == x1] == 0).all())
    assert bool((got[0][lf == 0] == 0).all()) and bool((got[1][lf == 0] == 0).all())


# (BG, N, H, W, C): the res5 shapes of the train path at batch 1, then small
# ones with C not a multiple of 32, more than 128 channels, and many channels
# (C = 1900), each with g in both layouts the kernel reads
@pytest.mark.parametrize("shape", [(4, 21888, 38, 64, 128), (3, 500, 19, 23, 1),
                                   (3, 500, 19, 23, 72), (3, 500, 19, 23, 200),
                                   (1, 70, 5, 6, 1900)])
@pytest.mark.parametrize("g_layout", ["contiguous", "channel_major"])
def test_dconv_bwd_kernel_matches_plain(cuda, shape, g_layout):
    BG, N, H, W, C = shape
    rng = np.random.RandomState(C)
    t = _dconv_args(rng, BG, N, H, W, C, cuda)
    g = torch.from_numpy(rng.randn(BG, N, C).astype(np.float32)).to(cuda)
    if g_layout == "channel_major":
        g = g.transpose(1, 2).contiguous().transpose(1, 2)
    before = kernels.dconv_col_bwd.launches
    got = kernels.dconv_col_bwd(*t, g, (H, W))
    assert kernels.dconv_col_bwd.launches == before + 1
    _dconv_bwd_check(got, kernels.dconv_col_bwd_plain(*t, g, (H, W)), t)


def _dconv_path_args(rng, B, DG, H, W, C, offset_px, dev, k=3):
    """Factors built as deformable_convolution builds them (res5's k x k taps
    with k = 3, dilation 2, the output the input's size, rows laid out (tap,
    ho, wo)) for offsets uniform in +-offset_px pixels, and ft."""
    from mxnet_tpu_torch.ops.detection import dconv_sample_factors

    off = rng.uniform(-offset_px, offset_px, (B, 2 * DG * k * k, H, W)).astype(np.float32)
    factors = dconv_sample_factors(torch.from_numpy(off).to(dev), (H, W), (k, k),
                                   (1, 1), (2, 2), (k - 1, k - 1))
    ft = torch.from_numpy(rng.randn(B * DG, H * W, C).astype(np.float32)).to(dev)
    return list(factors) + [ft]


# (B, DG, H, W, C, offset px): the train path's res5 call at batch 1 with
# small offsets, with +-3 pixels (some tiles' windows too large for shared
# memory) and with +-20 pixels (all of them); small maps whose tiles pass
# the map's edge, with C not a multiple of 32 (the last chunk of channels in
# part; C = 33: a chunk of one), more than 128 channels and C not a multiple
# of 4.  Offsets of a pixel or more make neighbouring rows' corners meet on
# a pixel.
@pytest.mark.parametrize("shape", [(1, 4, 38, 64, 128, 1.5), (1, 4, 38, 64, 128, 3.0),
                                   (1, 4, 38, 64, 128, 20.0), (2, 1, 9, 11, 40, 2.0),
                                   (1, 2, 19, 23, 16, 0.7), (1, 1, 9, 11, 200, 1.0),
                                   (1, 1, 9, 11, 6, 1.0), (1, 1, 10, 13, 33, 2.0)])
@pytest.mark.parametrize("g_layout", ["contiguous", "channel_major"])
@pytest.mark.parametrize("with_layout", [True, False])
def test_dconv_bwd_kernel_on_deformable_rows_matches_plain(cuda, shape, g_layout,
                                                           with_layout):
    """With the layout, a channel-major g and C a multiple of 4 the tiled
    design runs; every other call takes the row kernel."""
    B, DG, H, W, C, px = shape
    rng = np.random.RandomState(H + C)
    t = _dconv_path_args(rng, B, DG, H, W, C, px, cuda)
    N = t[0].shape[1]
    g = torch.from_numpy(rng.randn(B * DG, C, N).astype(np.float32)).to(cuda)
    g = g.transpose(1, 2)
    if g_layout == "contiguous":
        g = g.contiguous()
    layout = (9, H, W) if with_layout else None
    before = kernels.dconv_col_bwd.launches
    got = kernels.dconv_col_bwd(*t, g, (H, W), layout)
    assert kernels.dconv_col_bwd.launches == before + 1
    _dconv_bwd_check(got, kernels.dconv_col_bwd_plain(*t, g, (H, W)), t)


# a 5 x 5 kernel: more taps than the tiled design holds, the row kernel
# takes the call whatever its layout
@pytest.mark.parametrize("with_layout", [True, False])
def test_dconv_bwd_kernel_with_25_taps_matches_plain(cuda, with_layout):
    rng = np.random.RandomState(25)
    H, W, C = 12, 14, 24
    t = _dconv_path_args(rng, 1, 2, H, W, C, 1.0, cuda, k=5)
    N = t[0].shape[1]
    g = torch.from_numpy(rng.randn(2, C, N).astype(np.float32)).to(cuda).transpose(1, 2)
    got = kernels.dconv_col_bwd(*t, g, (H, W), (25, H, W) if with_layout else None)
    _dconv_bwd_check(got, kernels.dconv_col_bwd_plain(*t, g, (H, W)), t)


def test_dconv_function_hands_the_backward_g_as_it_comes(cuda, monkeypatch):
    """deformable_convolution's column gradient reaches dconv_col_bwd as the
    channel-major view the autograd makes, not as a copy, with the rows'
    layout."""
    from mxnet_tpu_torch.ops.detection import deformable_convolution

    seen = []
    wrapper = kernels.dconv_col_bwd

    def record(*args, **kw):
        seen.append((args, kw))
        return wrapper(*args, **kw)

    monkeypatch.setattr(kernels, "dconv_col_bwd", record)
    rng = np.random.RandomState(2)
    data = torch.from_numpy(rng.randn(1, 32, 12, 16).astype(np.float32)).to(cuda)
    off = torch.from_numpy(rng.randn(1, 2 * 2 * 9, 12, 16).astype(np.float32)).to(cuda)
    w = torch.from_numpy(rng.randn(8, 32, 3, 3).astype(np.float32) * 0.1).to(cuda)
    data.requires_grad_()
    out = deformable_convolution(data, off, w, kernel=3, num_filter=8, dilate=2,
                                 pad=2, num_deformable_group=2, no_bias=True)
    out.square().sum().backward()
    (args, kw), = seen
    g = args[8]
    assert kernels.channel_major(g) and g.stride() == (16 * 9 * 12 * 16, 1, 9 * 12 * 16)
    assert args[10] == (9, 12, 16) and not kw


def test_dconv_function_hands_bmm_the_kernels_column(cuda, monkeypatch):
    """In deformable_convolution the weight product reads the kernel's own
    storage: the reshapes of the channel-major column are views."""
    from mxnet_tpu_torch.ops.detection import deformable_convolution

    cols, operands = [], []
    wrapper, bmm = kernels.dconv_col, torch.bmm

    def record_col(*args, **kw):
        cols.append(wrapper(*args, **kw))
        return cols[-1]

    def record_bmm(a, b):
        operands.append(b)
        return bmm(a, b)

    monkeypatch.setattr(kernels, "dconv_col", record_col)
    monkeypatch.setattr(torch, "bmm", record_bmm)
    rng = np.random.RandomState(2)
    data = torch.from_numpy(rng.randn(1, 32, 12, 16).astype(np.float32)).to(cuda)
    off = torch.from_numpy(rng.randn(1, 2 * 2 * 9, 12, 16).astype(np.float32)).to(cuda)
    w = torch.from_numpy(rng.randn(8, 32, 3, 3).astype(np.float32) * 0.1).to(cuda)
    deformable_convolution(data, off, w, kernel=3, num_filter=8, dilate=2, pad=2,
                           num_deformable_group=2, no_bias=True)
    (col,), (operand,) = cols, operands
    assert col.stride() == (16 * 9 * 12 * 16, 1, 9 * 12 * 16)
    assert operand.untyped_storage().data_ptr() == col.untyped_storage().data_ptr()


# the train path's call, S = 3, 300 rows (more than 48 KB of shared memory
# per roi), then the forward's edge shapes
@pytest.mark.parametrize("shape", [(6272, 16, 38, 64), (7, 3, 5, 200),
                                   (20, 16, 300, 64)] + ABUILD_SHAPES[3:])
def test_abuild_bwd_kernel_matches_plain(cuda, shape):
    n, s, h, w = shape
    rng = np.random.RandomState(n)
    yv = torch.from_numpy(rng.rand(n, s, h).astype(np.float32)).to(cuda)
    xv = torch.from_numpy(rng.rand(n, s, w).astype(np.float32)).to(cuda)
    g = torch.from_numpy(rng.randn(n, h, w).astype(np.float32)).to(cuda)
    got = kernels.psroi_abuild_bwd(yv, xv, g)
    ref = kernels.psroi_abuild_bwd_plain(yv, xv, g)
    # sums of up to 300 fp32 products, fused multiply-adds in a fixed order
    # against torch's reduction order
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5 * float(b.abs().max()))


@pytest.mark.parametrize("shape", [(6272, 16, 38, 64), (33, 16, 38, 61)])
def test_abuild_kernels_are_deterministic(cuda, shape):
    """No atomics: two launches on the same input give the same bits."""
    n, s, h, w = shape
    rng = np.random.RandomState(5)
    yv, xv, g = (torch.from_numpy(rng.randn(*d).astype(np.float32)).to(cuda)
                 for d in ((n, s, h), (n, s, w), (n, h, w)))
    assert torch.equal(kernels.psroi_abuild(yv, xv), kernels.psroi_abuild(yv, xv))
    first = kernels.psroi_abuild_bwd(yv, xv, g)
    second = kernels.psroi_abuild_bwd(yv, xv, g)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_backward_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    rng = np.random.RandomState(3)
    t = _dconv_args(rng, 1, 40, 5, 6, 8, cuda)
    with pytest.raises(ValueError, match="g must be float32"):
        kernels.dconv_col_bwd(*t, torch.rand(1, 40, 8, device=cuda).double(), (5, 6))
    with pytest.raises(ValueError, match="contiguous"):  # every other stride
        kernels.dconv_col_bwd(*t, torch.rand(1, 40, 16, device=cuda)[:, :, ::2], (5, 6))
    yv, xv = torch.rand(4, 2, 3, device=cuda), torch.rand(4, 2, 5, device=cuda)
    with pytest.raises(ValueError, match="g must be"):
        kernels.psroi_abuild_bwd(yv, xv, torch.rand(4, 5, 3, device=cuda))
    with pytest.raises(ValueError, match="float32"):
        kernels.psroi_abuild_bwd(yv.double(), xv.double(),
                                 torch.rand(4, 3, 5, device=cuda).double())


def test_autograd_functions_launch_the_kernels_and_never_the_plain(cuda, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a plain version ran on CUDA tensors")

    for name in {n.split("[")[0] for n in kernels.KERNELS}:  # the bf16 rows share them
        monkeypatch.setattr(kernels, name + "_plain", refuse)
    rng = np.random.RandomState(4)
    t = _dconv_args(rng, 2, 300, 9, 11, 40, cuda)
    leaves = [a.requires_grad_() for a in t[4:]]
    yv = torch.rand(50, 16, 9, device=cuda, requires_grad=True)
    xv = torch.rand(50, 16, 11, device=cuda, requires_grad=True)
    kernels.reset_launches()
    col = kernels.DConvCol.apply(*t[:4], *leaves, (9, 11))
    a = kernels.PSROIABuild.apply(yv, xv)
    (col.square().sum() + a.square().sum()).backward()
    torch.cuda.synchronize()
    fp32 = ("dconv_col", "psroi_abuild", "dconv_col_bwd", "psroi_abuild_bwd")
    assert {n: k.wrapper.launches for n, k in kernels.KERNELS.items()} == {
        n: int(n in fp32) for n in kernels.KERNELS}
    assert all(bool(torch.isfinite(x.grad).all()) for x in leaves + [yv, xv])


def _edge_tensor(n, dev):
    x = torch.randn(n, generator=torch.Generator().manual_seed(n)) * 3
    edge = torch.tensor([0.0, -0.0, float("nan"), float("inf"), -float("inf"), 1e-30])
    k = min(n, edge.numel())
    x[:k] = edge[:k]
    return x.to(dev)


# bit for bit: odd sizes (scalar tail only, vectors and tail), a misaligned
# start (scalar path), +-0, NaN, infinities, a saturating and a zero range
@pytest.mark.parametrize("n", [1, 7, 4099, 1_000_003])
def test_int8_pair_bit_identical_to_plain(cuda, n):
    x = _edge_tensor(n + 1, cuda)
    for t in (x[:n], x[1:]):
        finite = t[torch.isfinite(t)]
        for real in (finite.abs().max() if finite.numel() else torch.ones((), device=cuda),
                     torch.tensor(0.5, device=cuda), torch.zeros((), device=cuda)):
            q = kernels.quantize_int8(t, real)
            assert torch.equal(q, kernels.quantize_int8_plain(t, real))
            d = kernels.dequantize_int8(q, real)
            assert torch.equal(d, kernels.dequantize_int8_plain(q, real))
    zeros = torch.zeros(n, device=cuda)
    assert not bool(kernels.quantize_int8(zeros, torch.zeros((), device=cuda)).any())


def test_int8_pair_raises_on_what_the_kernels_do_not_take(cuda):
    x = torch.rand(4, 6, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.quantize_int8(x.t(), x.max())
    with pytest.raises(ValueError, match="one device"):
        kernels.quantize_int8(x, torch.tensor(1.0))
    with pytest.raises(ValueError, match="int8"):
        kernels.dequantize_int8(x, x.max())


# bit for bit: the int32 accumulators of the im2col + _int_mm route on the
# card against the CPU's int32 convolution and product
@pytest.mark.parametrize("geom", [((2, 64, 56, 56), (64, 64, 3, 3), (2, 2), (1, 1)),
                                  ((3, 3, 30, 30), (64, 3, 7, 7), (2, 2), (3, 3)),
                                  ((1, 512, 7, 7), (2048, 512, 1, 1), (1, 1), (0, 0))])
def test_int_conv_on_the_card_equals_the_cpu(cuda, geom):
    import torch.nn.functional as F

    from mxnet_tpu_torch.ops import quantization

    xs, ws, stride, pad = geom
    g = torch.Generator().manual_seed(sum(xs))
    x = torch.randint(-127, 128, xs, generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, ws, generator=g, dtype=torch.int8)
    ref = F.conv2d(x.int(), w.int(), stride=stride, padding=pad)
    got = quantization._int_conv(x.to(cuda), w.to(cuda), stride, pad, (1, 1))
    assert got.dtype == torch.int32 and torch.equal(got.cpu(), ref)
    a = x.reshape(xs[0], -1)[:, : ws[1]].contiguous()
    w2 = w.reshape(ws[0], -1)[:, : ws[1]].contiguous()
    prod = quantization._int_matmul(a.to(cuda), w2.to(cuda))
    assert torch.equal(prod.cpu(), a.int() @ w2.int().t())


def test_int8_symbol_launches_the_pair_and_never_the_plain(cuda, monkeypatch):
    """quantize_model and an int8 forward of the CIFAR ResNet-8 on the card:
    one quantize_int8 per offline weight, then one per int8 quantize node
    and one dequantize_int8 per dequantize node each forward."""
    from mxnet_tpu_torch.contrib.quantization import quantize_model
    from mxnet_tpu_torch.models import resnet_symbol

    def refuse_cuda(plain):
        """The plain version, for the meta tensors of shape inference only."""
        def run(*a, **k):
            if any(torch.is_tensor(t) and t.is_cuda for t in a):
                raise AssertionError("a plain version ran on CUDA tensors")
            return plain(*a, **k)
        return run

    for name in {n.split("[")[0] for n in kernels.KERNELS}:  # the bf16 rows share them
        monkeypatch.setattr(kernels, name + "_plain",
                            refuse_cuda(getattr(kernels, name + "_plain")))
    net = resnet_symbol.get_symbol(10, 8, "3,32,32")
    arg_shapes, _, aux_shapes = net.infer_shape(data=(2, 3, 32, 32))
    g = torch.Generator().manual_seed(0)
    args = {n: torch.randn(s, generator=g).to(cuda) * 0.2
            for n, s in zip(net.list_arguments(), arg_shapes)
            if n not in ("data", "softmax_label")}
    aux = {n: (torch.ones(s) if n.endswith("_var") else torch.zeros(s)).to(cuda)
           for n, s in zip(net.list_auxiliary_states(), aux_shapes)}
    kernels.reset_launches()
    qsym, qargs, qaux = quantize_model(net, args, aux, device=cuda,
                                       excluded_sym_names=["fc1"], calib_mode="none")
    assert kernels.quantize_int8.launches == 10  # conv0 and 3 x 3 unit convs
    exe = qsym.simple_bind(device=cuda, grad_req="null", data=(2, 3, 32, 32))
    for bound, params in ((exe.arg_dict, qargs), (exe.aux_dict, qaux)):
        for k, v in params.items():
            bound[k].copy_(v)
    out = exe.forward(data=torch.randn(2, 3, 32, 32, device=cuda))[0]
    torch.cuda.synchronize()
    assert out.shape == (2, 10) and bool(torch.isfinite(out).all())
    assert kernels.quantize_int8.launches == 10 + 7
    assert kernels.dequantize_int8.launches == 10


# -- the bf16 instances -------------------------------------------------------

BF = torch.bfloat16


def _bf16_close(got, ref, atol=0.0, what=""):
    """bf16 ``got`` within one bf16 ulp of ``ref`` (plus ``atol``); prints
    and returns how many values are not bit-equal."""
    assert got.dtype == ref.dtype == BF and got.shape == ref.shape, what
    g, r = got.float(), ref.float()
    ulp = torch.ldexp(torch.ones_like(r), torch.frexp(r.abs().clamp(min=2.0 ** -126)).exponent - 8)
    bad = (g - r).abs() > ulp + atol
    assert not bool(bad.any()), "%s: %d of %d values more than 1 bf16 ulp apart" % (
        what, int(bad.sum()), bad.numel())
    n = int((got != ref).sum())
    print("%s %s: %d of %d values not bit-equal" % (what, tuple(got.shape), n, got.numel()))
    return n


# (BG, N, H, W, C): the serve call at batch 1 and 2 (BG 4 and 8); the 16-byte
# design (C % 8 == 0, N % 8 == 0) with C = 8, 72 (part of a pass), 136 (a
# second pass of one lane's channels) and 256, N = 504 (a last tile of 56
# rows); the 8-byte design (N = 500, or C = 12); shapes that take the
# one-thread-per-output kernel (N, C not multiples of 4)
@pytest.mark.parametrize("shape", [(4, 21888, 38, 64, 128), (8, 21888, 38, 64, 128),
                                   (2, 504, 19, 23, 8), (2, 504, 19, 23, 72),
                                   (3, 1000, 19, 23, 136), (1, 504, 19, 23, 256),
                                   (1, 500, 19, 23, 128), (2, 504, 19, 23, 12),
                                   (4, 501, 19, 23, 130), (2, 22, 5, 6, 8)])
def test_bf16_dconv_kernel_matches_plain(cuda, shape):
    """A rounded to bf16, the products summed in fp32 and rounded once: the
    plain version sums the same exact products in cuBLAS's order.  Every
    design gives the same bits: where a tiled one runs, a copy of ft one
    element off 16-byte alignment takes the one-thread-per-output kernel."""
    BG, N, H, W, C = shape
    rng = np.random.RandomState(C + N + 1)
    t = _dconv_args(rng, BG, N, H, W, C, cuda)
    t[7] = t[7].to(BF)
    before = (kernels.dconv_col.launches, kernels.dconv_col_bf16.launches)
    got = kernels.dconv_col(*t, (H, W))
    assert (kernels.dconv_col.launches, kernels.dconv_col_bf16.launches) == (
        before[0], before[1] + 1)
    assert got.dtype == BF and got.stride() == (C * N, 1, N)
    _bf16_close(got, kernels.dconv_col_plain(*t, (H, W)), what="dconv_col[bf16]")
    if C % 4 == 0 and N % 4 == 0:
        ft = torch.empty(t[7].numel() + 1, device=cuda, dtype=BF)[1:].view(t[7].shape)
        assert ft.copy_(t[7]).data_ptr() % 16 != 0
        assert torch.equal(kernels.dconv_col(*t[:7], ft, (H, W)), got)


def _bf16_dconv_bwd_check(got, ref, t):
    # the row sums: fp32, in another order; d_ft: fp32 atomics in an order
    # that changes from run to run, rounded once
    for name, a, b in zip(("d_ly", "d_lx", "d_lf"), got[:3], ref[:3]):
        assert a.dtype == torch.float32
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5 * float(b.abs().max()),
                                   msg=lambda m, n=name: "%s: %s" % (n, m))
    _bf16_close(got[3], ref[3], atol=1e-5 * float(ref[3].float().abs().max()),
                what="dconv_col_bwd[bf16] d_ft")
    y0, y1, x0, x1, _, _, lf = t[:7]
    assert bool((got[0][y0 == y1] == 0).all()) and bool((got[1][x0 == x1] == 0).all())
    assert bool((got[0][lf == 0] == 0).all()) and bool((got[1][lf == 0] == 0).all())


# (B, DG, H, W, C, offset px, taps): the train path's res5 call at batch 1
# (BG 4) and 2 (BG 8), BG 1, and 5 x 5 taps
@pytest.mark.parametrize("shape", [(1, 4, 38, 64, 128, 1.5, 3), (2, 4, 38, 64, 128, 1.5, 3),
                                   (1, 1, 19, 23, 16, 0.7, 3), (1, 2, 12, 14, 24, 1.0, 5)])
@pytest.mark.parametrize("g_layout", ["contiguous", "channel_major"])
@pytest.mark.parametrize("with_layout", [True, False])
def test_bf16_dconv_bwd_kernel_matches_plain(cuda, shape, g_layout, with_layout):
    B, DG, H, W, C, px, k = shape
    rng = np.random.RandomState(H + C + 1)
    t = _dconv_path_args(rng, B, DG, H, W, C, px, cuda, k=k)
    t[7] = t[7].to(BF)
    N = t[0].shape[1]
    g = torch.from_numpy(rng.randn(B * DG, C, N).astype(np.float32)).to(cuda).to(BF)
    g = g.transpose(1, 2)
    if g_layout == "contiguous":
        g = g.contiguous()
    before = (kernels.dconv_col_bwd.launches, kernels.dconv_col_bwd_bf16.launches)
    got = kernels.dconv_col_bwd(*t, g, (H, W), (k * k, H, W) if with_layout else None)
    assert (kernels.dconv_col_bwd.launches, kernels.dconv_col_bwd_bf16.launches) == (
        before[0], before[1] + 1)
    _bf16_dconv_bwd_check(got, kernels.dconv_col_bwd_plain(*t, g, (H, W)), t)


def _edged(t, rng, H, W):
    """Path factors ``t`` with another tenth of the rows dead (lf = 0), on
    any tap and position; their windows stay as they were.  The factors of
    deformable_convolution already hold dead rows (samples off the map) and
    live clamped corners at the last row and column (a sample in [H - 1, H)
    has y1 == y0 = H - 1): the test asserts that they do."""
    y0, y1, x0, x1, ly, lx, lf = t[:7]
    dead = torch.from_numpy(rng.rand(*lf.shape) < 0.1).to(lf.device)
    live = lf != 0
    assert bool((live & (y0 == H - 1) & (y1 == y0)).any())
    assert bool((live & (x0 == W - 1) & (x1 == x0)).any())
    return [y0, y1, x0, x1, ly, lx, torch.where(dead, torch.zeros_like(lf), lf)] + list(t[7:])


# (B, DG, H, W, C, offset px, taps): the edges of the bf16 backward's designs,
# with dead rows and clamped corners at the last row and column: C = 4, 8 and
# 12 (a chunk's first n-tile in part, or one and a half); Ho and Wo no
# multiples of the 4 x 8 tile with C = 36 (a second chunk of one n-tile);
# +-3 px offsets (some tiles' windows overflow shared memory) and +-20 px
# (all of them); 25 taps (the row design); a res5 map at batch 1 with more
# than one chunk and every edge
@pytest.mark.parametrize("shape", [(1, 2, 9, 11, 4, 1.0, 3), (1, 2, 9, 11, 8, 1.0, 3),
                                   (1, 2, 9, 11, 12, 1.0, 3), (2, 1, 10, 13, 36, 2.0, 3),
                                   (1, 4, 38, 64, 128, 3.0, 3), (1, 4, 38, 64, 128, 20.0, 3),
                                   (1, 1, 10, 13, 12, 1.0, 5), (1, 4, 38, 64, 128, 1.5, 3)])
@pytest.mark.parametrize("g_layout", ["contiguous", "channel_major"])
def test_bf16_dconv_bwd_kernel_edges_match_plain(cuda, shape, g_layout):
    B, DG, H, W, C, px, k = shape
    rng = np.random.RandomState(H + C + k)
    t = _edged(_dconv_path_args(rng, B, DG, H, W, C, px, cuda, k=k), rng, H, W)
    t[7] = t[7].to(BF)
    N = t[0].shape[1]
    g = torch.from_numpy(rng.randn(B * DG, C, N).astype(np.float32)).to(cuda).to(BF)
    g = g.transpose(1, 2)
    if g_layout == "contiguous":
        g = g.contiguous()
    got = kernels.dconv_col_bwd(*t, g, (H, W), (k * k, H, W))
    _bf16_dconv_bwd_check(got, kernels.dconv_col_bwd_plain(*t, g, (H, W)), t)
    again = kernels.dconv_col_bwd(*t, g, (H, W), (k * k, H, W))
    # the row sums are fixed-order sums: the same bits on every call
    assert all(torch.equal(a, b) for a, b in zip(got[:3], again[:3]))


def _device_ops(fn, tries=3):
    """The device operations (kernels, memsets, copies) of one ``fn()``,
    from the profiler: {name: count}.  A session that recorded no device
    operation at all is taken again, up to ``tries`` times: the card
    machine's profiler has returned an empty session for a call whose
    kernel ran (as ``chip_smoke.py device_ops``)."""
    fn()
    torch.cuda.synchronize()
    ops = {}
    for _ in range(tries):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        for evt in prof.key_averages():
            if getattr(evt, "device_type", None) == torch.autograd.DeviceType.CUDA:
                ops[evt.key] = ops.get(evt.key, 0) + evt.count
        if ops:
            break
    return ops


@pytest.mark.parametrize("design", ["tiled", "rows"])
def test_bf16_dconv_bwd_is_one_device_op_a_call(cuda, design):
    """Zeroing the fp32 buffer, the sums and the rounding to bf16 are one
    cooperative kernel: no memset, no second kernel."""
    rng = np.random.RandomState(8)
    H, W, C = 38, 64, 128
    t = _dconv_path_args(rng, 1, 4, H, W, C, 1.5, cuda)
    t[7] = t[7].to(BF)
    N = t[0].shape[1]
    g = torch.from_numpy(rng.randn(4, C, N).astype(np.float32)).to(cuda).to(BF).transpose(1, 2)
    layout = (9, H, W) if design == "tiled" else None
    ops = _device_ops(lambda: kernels.dconv_col_bwd(*t, g, (H, W), layout))
    assert len(ops) == 1 and list(ops.values()) == [1], ops
    assert ("bf16_tiled" if design == "tiled" else "bf16_rows") in next(iter(ops))


@pytest.mark.parametrize("shape", ABUILD_SHAPES + [(14700, 16, 38, 64)])
def test_bf16_abuild_kernel_matches_plain(cuda, shape):
    """The same fp32 sum of non-negative products, stored in bf16."""
    n, s, h, w = shape
    rng = np.random.RandomState(n + 1)
    yv = torch.from_numpy(rng.rand(n, s, h).astype(np.float32)).to(cuda)
    xv = torch.from_numpy(rng.rand(n, s, w).astype(np.float32)).to(cuda)
    before = kernels.psroi_abuild_bf16.launches
    got = kernels.psroi_abuild(yv, xv, BF)
    assert kernels.psroi_abuild_bf16.launches == before + 1
    _bf16_close(got, kernels.psroi_abuild_plain(yv, xv, BF), what="psroi_abuild[bf16]")


@pytest.mark.parametrize("shape", [(6272, 16, 38, 64), (7, 3, 5, 200),
                                   (20, 16, 300, 64)] + ABUILD_SHAPES[3:])
def test_bf16_abuild_bwd_kernel_matches_plain(cuda, shape):
    n, s, h, w = shape
    rng = np.random.RandomState(n + 1)
    yv = torch.from_numpy(rng.rand(n, s, h).astype(np.float32)).to(cuda)
    xv = torch.from_numpy(rng.rand(n, s, w).astype(np.float32)).to(cuda)
    g = torch.from_numpy(rng.randn(n, h, w).astype(np.float32)).to(cuda).to(BF)
    before = kernels.psroi_abuild_bwd_bf16.launches
    got = kernels.psroi_abuild_bwd(yv, xv, g)
    assert kernels.psroi_abuild_bwd_bf16.launches == before + 1
    ref = kernels.psroi_abuild_bwd_plain(yv, xv, g)
    # fp32 sums of up to 300 products of bf16 values, in a fixed order
    # against torch's reduction order
    for a, b in zip(got, ref):
        assert a.dtype == torch.float32
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5 * float(b.abs().max()))
    second = kernels.psroi_abuild_bwd(yv, xv, g)
    assert all(torch.equal(a, b) for a, b in zip(got, second))


def test_bf16_autograd_functions_launch_the_bf16_kernels_only(cuda, monkeypatch):
    """bf16 on the card reaches neither a plain version nor an fp32 kernel."""
    def refuse(*a, **k):
        raise AssertionError("a plain version ran on CUDA tensors")

    for name in {n.split("[")[0] for n in kernels.KERNELS}:
        monkeypatch.setattr(kernels, name + "_plain", refuse)
    rng = np.random.RandomState(5)
    t = _dconv_args(rng, 2, 300, 9, 11, 40, cuda)
    t[7] = t[7].to(BF)
    leaves = [a.requires_grad_() for a in t[4:]]
    yv = torch.rand(50, 16, 9, device=cuda, requires_grad=True)
    xv = torch.rand(50, 16, 11, device=cuda, requires_grad=True)
    kernels.reset_launches()
    col = kernels.DConvCol.apply(*t[:4], *leaves, (9, 11))
    a = kernels.PSROIABuild.apply(yv, xv, BF)
    assert col.dtype == a.dtype == BF
    (col.float().square().sum() + a.float().square().sum()).backward()
    torch.cuda.synchronize()
    bf16 = ("dconv_col[bf16]", "psroi_abuild[bf16]", "dconv_col_bwd[bf16]",
            "psroi_abuild_bwd[bf16]")
    assert {n: k.wrapper.launches for n, k in kernels.KERNELS.items()} == {
        n: int(n in bf16) for n in kernels.KERNELS}
    assert leaves[3].grad.dtype == BF
    assert all(bool(torch.isfinite(x.grad.float()).all()) for x in leaves + [yv, xv])


def test_bf16_wrappers_raise_on_float16(cuda):
    rng = np.random.RandomState(6)
    t = _dconv_args(rng, 1, 40, 5, 6, 8, cuda)
    h = torch.float16
    with pytest.raises(ValueError, match="float16"):
        kernels.dconv_col(*t[:7], t[7].to(h), (5, 6))
    with pytest.raises(ValueError, match="float16"):
        kernels.dconv_col_bwd(*t[:7], t[7].to(h), torch.rand(1, 40, 8, device=cuda).to(h),
                              (5, 6))
    with pytest.raises(ValueError, match="bfloat16"):
        kernels.dconv_col_bf16(*t, (5, 6))  # an fp32 ft to the bf16 instance
    yv, xv = torch.rand(4, 2, 3, device=cuda), torch.rand(4, 2, 5, device=cuda)
    with pytest.raises(ValueError, match="float16"):
        kernels.psroi_abuild(yv, xv, h)
    with pytest.raises(ValueError, match="float16"):
        kernels.psroi_abuild_bwd(yv, xv, torch.rand(4, 3, 5, device=cuda).to(h))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_batch_norm_training_card_against_cpu(cuda, dtype):
    """The BatchNorm op's training branch (shifted one-pass statistics in
    fp32) on the card against the CPU: output, batch mean and variance, and
    the gradients of data, γ and β."""
    from mxnet_tpu_torch.context import full_fp32
    from mxnet_tpu_torch.ops import nn as ops_nn

    rng = np.random.RandomState(8)
    x = rng.randn(8, 6, 14, 14).astype(np.float32) * 2
    x[:, 1] += 12.0  # a channel far from its running mean
    g, b = rng.rand(6).astype(np.float32) + 0.5, rng.randn(6).astype(np.float32)
    m, v = (rng.randn(6) * 0.3).astype(np.float32), (rng.rand(6) + 0.5).astype(np.float32)
    cot = torch.from_numpy(rng.randn(*x.shape).astype(np.float32))
    res = []
    for d in ("cpu", cuda):
        leaves = [torch.from_numpy(a).to(d, dtype).requires_grad_() for a in (x, g, b)]
        with full_fp32():
            out, mean, var = ops_nn.batch_norm(
                *leaves, torch.from_numpy(m).to(d), torch.from_numpy(v).to(d), eps=1e-5,
                fix_gamma=False, training=True, output_mean_var=True)
            loss = (out.float() * cot.to(d)).sum() + mean.sum() + var.sum()
            grads = torch.autograd.grad(loss, leaves)
        res.append([t.detach().float().cpu() for t in (out, mean, var) + grads])
    for name, got, ref in zip(("out", "mean", "var", "d_data", "d_gamma", "d_beta"), *res):
        # fp32 reductions in another order (the variance keeps the rounding
        # of E[d²] ~ 150 for the far channel); bf16: a few ulps of the largest
        tol = 1e-4 if dtype == torch.float32 else 2 ** -5
        torch.testing.assert_close(got, ref, rtol=tol, atol=tol * float(ref.abs().max()),
                                   msg=lambda msg, n=name: "%s: %s" % (n, msg))


@pytest.mark.parametrize("dtype", [None, "bfloat16"], ids=["fp32", "bf16"])
def test_narrow_resnet_step_card_against_cpu(cuda, dtype):
    """Two steps of the narrow ResNet V1 train step (64x64, batch 4, SGD lr
    0.05 momentum 0.9) on the card against the CPU from the same weights:
    the first step's loss and running statistics, and no ported kernel
    launched."""
    from mxnet_tpu_torch.gluon.functional import make_train_step
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.model_zoo.vision import BottleneckV1, ResNetV1

    rng = np.random.RandomState(9)
    x = torch.from_numpy(rng.randn(4, 3, 64, 64).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, 10, 4).astype(np.float32))
    res = []
    kernels.reset_launches()
    for d in ("cpu", cuda):
        net = ResNetV1(BottleneckV1, [1, 1, 1, 1], [8, 16, 32, 64, 128], classes=10,
                       device=d, generator=torch.Generator().manual_seed(9))
        step, state, (names, _, aux_idx) = make_train_step(
            net, SoftmaxCrossEntropyLoss(), learning_rate=0.05, momentum=0.9,
            compute_dtype=dtype)
        state, loss = step(state, x.to(d), y.to(d))
        stats = {names[i]: t.cpu().clone() for i, t in zip(aux_idx, state[2])}
        state, loss2 = step(state, x.to(d), y.to(d))
        assert all(t.dtype == torch.float32 for part in state for t in part)
        assert not net.training
        res.append((float(loss), float(loss2), stats))
    assert all(k.wrapper.launches == 0 for k in kernels.KERNELS.values())
    (l_ref, l2_ref, s_ref), (l_got, l2_got, s_got) = res
    bf16 = dtype is not None
    assert np.isfinite(l2_got) and np.isfinite(l2_ref)
    # fp32: sums in another order; bf16: each device rounds its bf16
    # convolutions at other places
    np.testing.assert_allclose(l_got, l_ref, rtol=3e-2 if bf16 else 1e-5)
    for name, ref in s_ref.items():
        tol = 5e-2 if bf16 else 1e-5
        torch.testing.assert_close(s_got[name], ref, rtol=tol, atol=tol * float(ref.abs().max()),
                                   msg=lambda msg, n=name: "%s: %s" % (n, msg))


# the tiny Faster R-CNN's seed and RPN score weights' gain: at these its CPU
# run's 144 foreground scores of each image lie at least 4.6e-5 apart, far
# above the two devices' rounding differences
FRCNN_SEED, FRCNN_RPN_GAIN = 42, 2.0


def test_tiny_faster_rcnn_card_against_cpu(cuda):
    """The tiny FasterRCNN (64x96, batch 2) on the card against the CPU from
    the same weights: the serve forward, then one fp32 train step with the
    same noise and dropout masks (loss parts, the conv3 and fc6 gradients);
    NMS launched once a forward and once a step, no other kernel."""
    from mxnet_tpu_torch import train_frcnn
    from mxnet_tpu_torch.gluon.model_zoo import FasterRCNN

    cfg = dict(classes=3, image_shape=(64, 96), rpn_pre_nms=200, rpn_post_nms=32,
               **train_frcnn.TINY)
    gen = torch.Generator().manual_seed(FRCNN_SEED)
    cpu = FasterRCNN(device="cpu", generator=gen, **cfg)
    with torch.no_grad():
        cpu.rpn_cls.weight.mul_(FRCNN_RPN_GAIN)
    gpu = FasterRCNN(device=cuda, **cfg)
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.RandomState(FRCNN_SEED)
    batch = [torch.from_numpy(a) for a in train_frcnn.synthetic_coco(rng, 2, (64, 96), 3, 8)]
    rnd = train_frcnn.draw_randoms(cpu, 2, gen, "cpu")
    res = []
    for net, d in ((cpu, "cpu"), (gpu, cuda)):
        kernels.reset_launches()
        serve = [t.cpu() for t in net(*(t.to(d) for t in batch[:2]))]
        step = train_frcnn.make_frcnn_train_step(net, 2)
        _, parts = step(*(t.to(d) for t in batch + rnd))
        launches = {n: k.wrapper.launches for n, k in kernels.KERNELS.items()}
        named = net.gluon_named_tensors()
        res.append((serve, parts.cpu(), named["conv3_conv2d0_weight"].grad.cpu(),
                    named["fc6_weight"].grad.cpu(), launches))
    (s_ref, p_ref, g3_ref, g6_ref, _), (s_got, p_got, g3_got, g6_got, launches) = res
    assert launches == {n: 2 if n == "nms_alive" else 0 for n in kernels.KERNELS}
    torch.testing.assert_close(s_got[0], s_ref[0], rtol=0, atol=1e-3)   # rois
    torch.testing.assert_close(s_got[1], s_ref[1], rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(s_got[2], s_ref[2], rtol=1e-4,
                               atol=1e-4 * float(s_ref[2].abs().max()))
    # four fp32 means over the same selection, summed in another order
    torch.testing.assert_close(p_got, p_ref, rtol=1e-4, atol=1e-5)
    for got, ref in ((g3_got, g3_ref), (g6_got, g6_ref)):
        assert float(ref.abs().max()) > 0
        torch.testing.assert_close(got, ref, rtol=1e-3, atol=1e-4 * float(ref.abs().max()))


def test_roi_pooling_card_against_cpu(cuda):
    """ROIPooling at the VGG16 map's width (512 channels, 38x64, 7x7 bins),
    grouped, fp32 and bf16: values equal (a max picks an element), input
    gradients within fp32 rounding of the same shares."""
    from mxnet_tpu_torch.ops import detection as ops_det

    rng = np.random.RandomState(10)
    data = torch.from_numpy(rng.randint(0, 8, (2, 512, 38, 64)).astype(np.float32))
    xy = rng.uniform(-40, 1000, (2 * 20, 2)).astype(np.float32)
    wh = rng.uniform(8, 500, (2 * 20, 2)).astype(np.float32)
    rois = torch.from_numpy(np.concatenate(
        [np.repeat(np.arange(2, dtype=np.float32), 20)[:, None], xy, xy + wh], 1))
    cot = torch.from_numpy(rng.randn(40, 512, 7, 7).astype(np.float32))
    for dtype in (torch.float32, torch.bfloat16):
        res = []
        for d in ("cpu", cuda):
            x = data.to(d, dtype).detach().requires_grad_()
            out = ops_det.roi_pooling(x, rois.to(d), pooled_size=7, spatial_scale=1 / 16,
                                      rois_per_image=20)
            (out.float() * cot.to(d)).sum().backward()
            res.append((out.detach().cpu(), x.grad.float().cpu()))
        (o_ref, g_ref), (o_got, g_got) = res
        assert torch.equal(o_got, o_ref)
        tol = 1e-6 if dtype == torch.float32 else 1e-2
        torch.testing.assert_close(g_got, g_ref, rtol=tol, atol=tol * float(g_ref.abs().max()))


def test_tiny_faster_rcnn_bf16_serve_card_against_cpu(cuda):
    """The tiny FasterRCNN served after ``cast("bfloat16")`` on the card
    against the CPU from the same weights, stage by stage, each stage fed
    the CPU's inputs (bf16 values within a few ulps: each device rounds its
    bf16 convolutions at other places), then end to end: rois fp32,
    cls_prob and bbox_pred bf16, finite, one NMS launch and no other
    kernel."""
    from mxnet_tpu_torch import train_frcnn
    from mxnet_tpu_torch.gluon.model_zoo import FasterRCNN

    bf = torch.bfloat16
    cfg = dict(classes=3, image_shape=(64, 96), rpn_pre_nms=200, rpn_post_nms=32,
               **train_frcnn.TINY)
    gen = torch.Generator().manual_seed(FRCNN_SEED)
    cpu = FasterRCNN(device="cpu", generator=gen, **cfg)
    with torch.no_grad():
        cpu.rpn_cls.weight.mul_(FRCNN_RPN_GAIN)
    gpu = FasterRCNN(device=cuda, **cfg)
    gpu.load_state_dict(cpu.state_dict())
    cpu.cast("bfloat16")
    gpu.cast("bfloat16")
    data = torch.randn((2, 3, 64, 96), generator=gen).to(bf)
    info = torch.tensor([[64, 96, 1.0], [48, 80, 1.0]])
    g = lambda t: t.to(cuda)
    close = lambda got, ref, tol: torch.testing.assert_close(
        got.cpu().float(), ref.float(), rtol=tol, atol=tol * float(ref.float().abs().max()))
    with torch.inference_mode():
        c5 = cpu._features(data)
        close(gpu._features(g(data)), c5, 3e-2)
        rc, rb = cpu._rpn(c5)
        grc, grb = gpu._rpn(g(c5))
        close(grc, rc, 2e-2)
        close(grb, rb, 2e-2)
        rois = cpu._proposals(rc, rb, info)
        grois = gpu._proposals(g(rc), g(rb), g(info))
        assert grois.dtype == torch.float32
        torch.testing.assert_close(grois.cpu(), rois, rtol=0, atol=0.1)
        cs, bp = cpu._head(c5, rois, rois_per_image=32)
        gcs, gbp = gpu._head(g(c5), g(rois), rois_per_image=32)
        close(torch.softmax(gcs.float(), -1), torch.softmax(cs.float(), -1), 2e-2)
        close(gbp, bp, 3e-2)
        kernels.reset_launches()
        out = gpu(g(data), g(info))
    assert [t.dtype for t in out] == [torch.float32, bf, bf]
    assert [tuple(t.shape) for t in out] == [(64, 5), (64, 4), (64, 16)]
    assert all(bool(torch.isfinite(t).all()) for t in out)
    assert {n: k.wrapper.launches for n, k in kernels.KERNELS.items()} == \
        {n: int(n == "nms_alive") for n in kernels.KERNELS}


def test_cifar_resnet8_module_step_card_against_cpu(cuda):
    """One Module step (forward_backward + update, sgd lr 0.05 momentum 0.9
    wd 1e-4) of the CIFAR ResNet-8 at batch 4 on the card and on the CPU
    from the same weights: the outputs, every parameter and moving statistic
    after the step; no ported kernel launched."""
    from mxnet_tpu_torch.initializer import Xavier
    from mxnet_tpu_torch.io import DataBatch
    from mxnet_tpu_torch.models.resnet_symbol import get_symbol
    from mxnet_tpu_torch.module import Module

    rng = np.random.RandomState(11)
    x = torch.from_numpy(rng.randn(4, 3, 28, 28).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, 10, (4,)).astype(np.float32))
    res, start = [], None
    for d in ("cpu", cuda):
        mod = Module(get_symbol(10, 8, "3,28,28"), device=d)
        mod.bind(data_shapes=[("data", (4, 3, 28, 28))], label_shapes=[("softmax_label", (4,))])
        if start is None:
            mod.init_params(Xavier(rnd_type="gaussian", factor_type="in", magnitude=2,
                                   generator=torch.Generator().manual_seed(11)))
            start = tuple({k: v.clone() for k, v in p.items()} for p in mod.get_params())
        else:
            mod.init_params(arg_params=start[0], aux_params=start[1])
        mod.init_optimizer(optimizer="sgd", optimizer_params=dict(
            learning_rate=0.05, momentum=0.9, wd=1e-4))
        kernels.reset_launches()
        mod.forward_backward(DataBatch([x.to(d)], [y.to(d)]))
        mod.update()
        assert not any(k.wrapper.launches for k in kernels.KERNELS.values())
        arg, aux = mod.get_params()
        res.append((mod.get_outputs()[0].cpu(), {k: v.cpu() for k, v in {**arg, **aux}.items()}))
    (out_ref, ref), (out_got, got) = res
    torch.testing.assert_close(out_got, out_ref, rtol=1e-4, atol=1e-6)
    for k, r in ref.items():
        moved = r - start[0].get(k, start[1].get(k))
        torch.testing.assert_close(got[k], r, rtol=1e-4, atol=1e-4 * float(moved.abs().max()),
                                   msg=lambda m, k=k: "%s: %s" % (k, m))


def _ssd_nms_inputs(rng, B, n, valid_rows):
    """NMS inputs as SSD's score step gives them: normalized corner boxes
    clustered around a few objects, 20 float class ids (-1 on invalid
    rows), and valid rows either the first 400 (the step's top-k) or a
    random half."""
    ctr = rng.uniform(0.1, 0.9, (B, 16, 2))
    c = np.take_along_axis(ctr, rng.randint(0, 16, (B, n))[..., None], axis=1)
    c = c + rng.normal(0, 0.02, (B, n, 2))
    wh = rng.uniform(0.05, 0.4, (B, n, 2))
    boxes = np.clip(np.concatenate([c - wh / 2, c + wh / 2], -1), 0, 1)
    if valid_rows == "topk":
        valid = np.broadcast_to(np.arange(n) < 400, (B, n)).copy()
    else:
        valid = rng.rand(B, n) < 0.5
    ids = np.where(valid, rng.randint(0, 20, (B, n)), -1).astype(np.float32)
    return (torch.from_numpy(boxes.astype(np.float32)), torch.from_numpy(valid),
            torch.from_numpy(ids))


# SSD300's and SSD512's anchor counts: the staged scan and, above ~14,000
# boxes, nms_scan_kernel_global
@pytest.mark.parametrize("n", [8732, 24564])
@pytest.mark.parametrize("valid_rows", ["topk", "half"])
def test_nms_kernel_on_ssd_inputs(cuda, n, valid_rows):
    rng = np.random.RandomState(n + len(valid_rows))
    boxes, valid, ids = (t.to(cuda) for t in _ssd_nms_inputs(rng, 3, n, valid_rows))
    for idv in (ids, None):
        got = kernels.nms_alive(boxes, valid, idv, thresh=0.45, plus_one=0.0)
        ref = kernels.nms_alive_plain(boxes, valid, idv, thresh=0.45, plus_one=0.0)
        assert torch.equal(got, ref)
        assert 0 < int(got.sum()) < int(valid.sum())


# the two-stage scan's stages fit shared memory up to 219 words (N 14,016)
@pytest.mark.parametrize("n,scan", [(6000, "staged"), (8732, "staged"), (12000, "staged"),
                                    (14016, "staged"), (14017, "global"),
                                    (24564, "global")])
def test_nms_scan_rule(cuda, n, scan):
    assert kernels.nms_scan(n) == scan


def test_ssd_ops_launch_the_kernel_and_never_the_plain(cuda, monkeypatch):
    """multibox_detection (per class and forced) and box_nms on the card:
    one nms_alive launch a call for the batch, never the plain version."""
    from mxnet_tpu_torch.ops import detection as tdet

    def refuse(*a, **k):
        raise AssertionError("the plain NMS ran on CUDA tensors")

    monkeypatch.setattr(kernels, "nms_alive_plain", refuse)
    rng = np.random.RandomState(2)
    A = 1528
    anc = torch.from_numpy(np.sort(rng.uniform(0, 1, (1, A, 2, 2)), axis=2)
                           .transpose(0, 1, 3, 2).reshape(1, A, 4).astype(np.float32)).to(cuda)
    prob = torch.softmax(torch.from_numpy(rng.randn(2, 4, A).astype(np.float32)), 1).to(cuda)
    loc = torch.from_numpy((rng.randn(2, A * 4) * 0.3).astype(np.float32)).to(cuda)
    for force in (False, True):
        kernels.reset_launches()
        out = tdet.multibox_detection(prob, loc, anc, nms_threshold=0.45, nms_topk=400,
                                      force_suppress=force)
        assert kernels.nms_alive.launches == 1 and out.shape == (2, A, 6)
    data = torch.cat([torch.randint(0, 3, (2, 50, 1)).float(), torch.rand(2, 50, 1),
                      torch.rand(2, 50, 2) * 0.5, torch.rand(2, 50, 2) * 0.5 + 0.5], -1)
    kernels.reset_launches()
    out = tdet.box_nms(data.to(cuda), overlap_thresh=0.3, id_index=0, topk=20)
    assert kernels.nms_alive.launches == 1 and out.shape == (2, 50, 6)
    assert {n: k.wrapper.launches for n, k in kernels.KERNELS.items()} == \
        {n: int(n == "nms_alive") for n in kernels.KERNELS}


def test_tiny_ssd_card_against_cpu(cuda):
    """The tiny SSD (the JAX example's CPU smoke at width 0.125: 128², 3
    classes, 1,528 anchors, batch 2) on the card against the CPU from the
    same weights: the forward; MultiBoxDetection fed the CPU's probabilities
    and offsets (the devices' forwards differ in the last bits, enough to
    reorder near-equal scores); the whole score step (one NMS launch); one
    fp32 train step's loss parts and updated weights (no ported kernel)."""
    from mxnet_tpu_torch import train_ssd
    from mxnet_tpu_torch.gluon.model_zoo import VGGSSD
    from mxnet_tpu_torch.ops import detection as tdet

    cfg = train_ssd.tiny_config()
    cpu = VGGSSD(3, cfg, width=0.125, device="cpu",
                 generator=torch.Generator().manual_seed(3))
    gpu = VGGSSD(3, cfg, width=0.125, device=cuda)
    gpu.load_state_dict(cpu.state_dict())
    data, gt = (torch.from_numpy(a) for a in train_ssd.synthetic_voc(
        np.random.RandomState(3), 2, 128, 3))
    res, fed = [], None
    for net, d in ((cpu, "cpu"), (gpu, cuda)):
        anchors = net.make_anchors(128)
        with torch.inference_mode():
            cls, box = net(data.to(d))
            if fed is None:
                fed = (torch.softmax(cls, -1).transpose(1, 2).contiguous(), box)
            det = tdet.multibox_detection(fed[0].to(d), fed[1].to(d), anchors[None],
                                          nms_threshold=0.45, nms_topk=400)
        kernels.reset_launches()
        score = train_ssd.make_score_step(net, anchors)(data.to(d))
        serve = {n: k.wrapper.launches for n, k in kernels.KERNELS.items()}
        step, state = train_ssd.make_ssd_train_step(net, anchors, 2)
        kernels.reset_launches()
        _, _, parts = step(state, data.to(d), gt.to(d))
        train = {n: k.wrapper.launches for n, k in kernels.KERNELS.items()}
        named = net.gluon_named_tensors()
        res.append((cls.cpu(), box.cpu(), det.cpu(), score.cpu(), parts.cpu(),
                    {k: named[k].detach().cpu() for k in
                     ("conv2d0_weight", "conv2d14_weight", "conv2d19_weight")}, serve, train))
    ref, got = res
    for g, r in zip(got[:2], ref[:2]):  # the forward
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-4 * float(r.abs().max()))
    assert torch.equal(got[2][..., 0], ref[2][..., 0])
    torch.testing.assert_close(got[2], ref[2], rtol=1e-6, atol=1e-6)
    assert got[3].shape == (2, 1528, 6) and bool(torch.isfinite(got[3]).all())
    assert ((got[3][..., 1] >= 0).sum(1) == 400).all()
    assert got[6] == {n: int(n == "nms_alive") for n in kernels.KERNELS}
    assert not any(got[7].values())
    torch.testing.assert_close(got[4], ref[4], rtol=1e-4, atol=1e-5)
    for k, r in ref[5].items():
        torch.testing.assert_close(got[5][k], r, rtol=1e-4, atol=1e-6)


def _twin_predictor(device, batch=2, image=16):
    from mxnet_tpu_torch import symbol as tsym
    from mxnet_tpu_torch.predictor import Predictor
    from mxnet_tpu_torch.test_utils import deploy_twin_checkpoint

    with tsym.NameManager():
        net, params, shapes = deploy_twin_checkpoint(batch=batch, image=image)
    return Predictor(net, params, shapes, device=device)


def test_deploy_twin_tiers_card_against_cpu(cuda):
    """The deploy twin as an fp32 Predictor and its bf16 and calibrated int8
    twins (one table for both devices) on the card against the CPU: fp32
    within rtol 1e-4, the twins within their tier's tolerance; each twin
    within its tolerance of the card's fp32; no ported kernel launched."""
    from mxnet_tpu_torch.graph_passes import precision

    rng = np.random.RandomState(21)
    x = torch.from_numpy(rng.rand(2, 3, 16, 16).astype(np.float32))
    calib = [{"data": rng.rand(2, 3, 16, 16).astype(np.float32)} for _ in range(3)]
    cpu = _twin_predictor("cpu")
    table = precision.calibrate(cpu, calib)
    outs = {}
    for dev in ("cpu", cuda):
        base = _twin_predictor(dev)
        kernels.reset_launches()
        for tier in ("fp32", "bf16", "int8"):
            p = base.with_precision(tier, table if tier == "int8" else None)
            outs[(str(dev), tier)] = [o.float().cpu() for o in p.forward(data=x.to(dev))]
        assert not any(k.wrapper.launches for k in kernels.KERNELS.values())
    for tier in ("fp32", "bf16", "int8"):
        tol = dict(rtol=1e-4, atol=1e-6) if tier == "fp32" else precision.tier_tolerance(tier)
        for got, ref, base in zip(outs[("cuda", tier)], outs[("cpu", tier)],
                                  outs[("cuda", "fp32")]):
            torch.testing.assert_close(got, ref, **tol)
            torch.testing.assert_close(got, base, **(precision.tier_tolerance(tier)
                                                     if tier != "fp32" else tol))


def _quantized_resnet8(device):
    from mxnet_tpu_torch import symbol as tsym
    from mxnet_tpu_torch.contrib.quantization import quantize_model
    from mxnet_tpu_torch.io import NDArrayIter
    from mxnet_tpu_torch.models.resnet_symbol import get_symbol

    gen = torch.Generator().manual_seed(22)
    with tsym.NameManager():
        net = get_symbol(10, 8, "3,16,16")
    arg_shapes, _, aux_shapes = net.infer_shape(data=(1, 3, 16, 16))
    args = {n: (torch.randn(s, generator=gen) * (2.0 / np.prod(s[1:])) ** 0.5
                if n.endswith("_weight") else torch.ones(s) if n.endswith("_gamma")
                else torch.zeros(s)).to(device)
            for n, s in zip(net.list_arguments(), arg_shapes)
            if n not in ("data", "softmax_label")}
    aux = {n: (torch.ones(s) if n.endswith("_var") else torch.zeros(s)).to(device)
           for n, s in zip(net.list_auxiliary_states(), aux_shapes)}
    calib = torch.randn((8, 3, 16, 16), generator=gen).to(device)
    return quantize_model(net, args, aux, device=device, excluded_sym_names=["fc1"],
                          calib_mode="naive", calib_data=NDArrayIter(calib, batch_size=4))


def _plan_int8_nodes(exe):
    """(int8 quantize nodes, dequantize nodes of int8 input) of the
    inference plan an executor runs, from its walk on meta tensors."""
    from mxnet_tpu_torch.analysis import executor_context
    from mxnet_tpu_torch.analysis.graph_analyzers import _abstract_walk

    ctx = executor_context(exe)
    dts = {n: v.dtype for n, v in ctx.arg_avals.items()}
    _abstract_walk(ctx.graph, ctx, record=lambda node, nm, shape, dtype, vals, ins:
                   dts.__setitem__(nm, dtype))
    plan = ctx.graph.entries
    return (sum(n.op.name == "_contrib_quantize" and n.attrs.get("out_type") == "int8"
                for n, _ in plan),
            sum(n.op.name == "_contrib_dequantize" and dts[ins[0]] == torch.int8
                for n, ins in plan))


def test_quantized_deploy_predictor_bit_equal_to_bare_executor(cuda, monkeypatch, tmp_path):
    """``quantize_model``'s int8 CIFAR ResNet-8, written to files and served
    by a Predictor on the card: outputs equal bit for bit to a bare Executor
    of the same symbol with the graph passes off; one quantize_int8 launch
    per int8 quantize node and one dequantize_int8 per dequantize node of
    int8 input of the optimised plan, a forward; no host synchronisation."""
    from mxnet_tpu_torch import ndarray, symbol as tsym
    from mxnet_tpu_torch.predictor import Predictor

    qsym, qargs, qaux = _quantized_resnet8(cuda)
    qsym.save(str(tmp_path / "q-symbol.json"))
    ndarray.save(str(tmp_path / "q.params"), {**{"arg:" + k: v for k, v in qargs.items()},
                                               **{"aux:" + k: v for k, v in qaux.items()}})
    x = torch.from_numpy(np.random.RandomState(23).randn(4, 3, 16, 16)
                         .astype(np.float32)).to(cuda)
    pred = Predictor(str(tmp_path / "q-symbol.json"), str(tmp_path / "q.params"),
                     {"data": (4, 3, 16, 16)})
    pred.forward(data=x)  # builds the plan
    n_q, n_dq = _plan_int8_nodes(pred._exec)
    kernels.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = pred.forward(data=x)[0]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert kernels.quantize_int8.launches == n_q > 0
    assert kernels.dequantize_int8.launches == n_dq > 0
    monkeypatch.setenv("MXNET_GRAPH_PASSES", "0")
    # the symbol file does not carry the weights' int8 dtype: type_dict does
    exe = tsym.load(str(tmp_path / "q-symbol.json")).simple_bind(
        device=cuda, grad_req="null", type_dict={k: v.dtype for k, v in qargs.items()},
        data=(4, 3, 16, 16))
    for bound, params in ((exe.arg_dict, qargs), (exe.aux_dict, qaux)):
        for k, v in params.items():
            bound[k].copy_(v)
    ref = exe.forward(data=x)[0]
    assert exe.pass_stats() == {} and torch.equal(out, ref)


def test_kernel_wrappers_launch_nothing_on_meta_tensors(cuda):
    """Under meta tensors (the analyzers' abstract walk) every wrapper gives
    empty meta outputs of the right shapes and dtypes and counts nothing."""
    meta = torch.device("meta")
    kernels.reset_launches()
    i32 = lambda *s: torch.empty(s, dtype=torch.int32, device=meta)
    f32 = lambda *s: torch.empty(s, dtype=torch.float32, device=meta)
    outs = [
        kernels.nms_alive(f32(2, 9, 4), torch.empty((2, 9), dtype=torch.bool, device=meta),
                          thresh=0.5),
        kernels.dconv_col(*(i32(4, 6),) * 4, *(f32(4, 6),) * 3, f32(4, 12, 8), (3, 4)),
        *kernels.dconv_col_bwd(*(i32(4, 6),) * 4, *(f32(4, 6),) * 3, f32(4, 12, 8),
                               f32(4, 6, 8), (3, 4)),
        kernels.psroi_abuild(f32(3, 2, 4), f32(3, 2, 5)),
        *kernels.psroi_abuild_bwd(f32(3, 2, 4), f32(3, 2, 5), f32(3, 4, 5)),
        kernels.quantize_int8(f32(5, 7), f32()),
        kernels.dequantize_int8(torch.empty((5, 7), dtype=torch.int8, device=meta), f32()),
    ]
    assert all(o.device.type == "meta" for o in outs)
    assert [tuple(o.shape) for o in outs] == [(2, 9), (4, 6, 8), (4, 6), (4, 6), (4, 6),
                                              (4, 12, 8), (3, 4, 5), (3, 2, 4), (3, 2, 5),
                                              (5, 7), (5, 7)]
    assert not any(k.wrapper.launches for k in kernels.KERNELS.values())
    assert kernels.quantize_int8(torch.ones(5, device=cuda), torch.ones((), device=cuda)) \
        .dtype == torch.int8 and kernels.quantize_int8.launches == 1


def test_predictor_forward_makes_no_host_sync(cuda):
    """Every forward after the first (which builds the plan) of the deploy
    twin and its bf16 and int8 twins on the card, under
    ``set_sync_debug_mode("error")``."""
    from mxnet_tpu_torch.graph_passes import precision

    base = _twin_predictor(cuda, batch=4)
    x = torch.rand((4, 3, 16, 16), device=cuda)
    table = precision.calibrate(base, [{"data": x}])
    for p in (base, base.with_precision("bf16"), base.with_precision("int8", table)):
        p.forward(data=x)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            p.forward(data=x)
        finally:
            torch.cuda.set_sync_debug_mode(0)


def _serve_stream(eng, xs, wait=60.0):
    reqs = [eng.submit({"data": x}) for x in xs]
    eng.start()
    return [r.result(wait) for r in reqs]


def test_tiny_mlp_engine_card_against_cpu(cuda):
    """The tiny MLP served through an Engine on the card and one on the CPU,
    the same seeded stream (1-5 samples over ladder (1, 2, 4), the 5s
    dispatched directly): replies within rtol 1e-5, one compile a
    signature, no ported kernel launched."""
    from mxnet_tpu_torch import serving
    from mxnet_tpu_torch.test_utils import tiny_mlp_checkpoint

    sym, params = tiny_mlp_checkpoint()
    rng = np.random.RandomState(31)
    xs = [rng.randn(n, 8).astype(np.float32) for n in (1, 2, 3, 4, 5, 2, 1)]
    replies, stats = {}, {}
    kernels.reset_launches()
    for dev in ("cpu", cuda):
        eng = serving.Engine(sym, params, {"data": (8,)}, ladder=serving.BucketLadder((1, 2, 4)),
                             max_wait_ms=2.0, device=dev, start=False)
        try:
            eng.warmup()
            replies[str(dev)] = _serve_stream(eng, xs)
            stats[str(dev)] = eng.stats()
        finally:
            eng.close()
    for got, ref, x in zip(replies["cuda"], replies["cpu"], xs):
        assert isinstance(got[0], np.ndarray) and got[0].shape == (len(x), 4)
        np.testing.assert_allclose(got[0], ref[0], rtol=1e-5, atol=1e-6)
    assert stats["cuda"]["compiles"] == stats["cpu"]["compiles"] == 3 + 1
    assert not any(k.wrapper.launches for k in kernels.KERNELS.values())


def test_quantized_deploy_served_through_an_engine(cuda, tmp_path):
    """``quantize_model``'s int8 CIFAR ResNet-8 from files through an Engine
    on the card: one quantize_int8 launch per int8 quantize node and one
    dequantize_int8 per dequantize node of int8 input, a forward, over the
    warmup's forwards and the served batches; replies equal bit for bit
    to a Predictor of the same bucket on the request's rows padded with
    zeros."""
    from mxnet_tpu_torch import ndarray, serving
    from mxnet_tpu_torch.predictor import Predictor

    qsym, qargs, qaux = _quantized_resnet8(cuda)
    sfile, pfile = str(tmp_path / "q-symbol.json"), str(tmp_path / "q.params")
    qsym.save(sfile)
    ndarray.save(pfile, {**{"arg:" + k: v for k, v in qargs.items()},
                         **{"aux:" + k: v for k, v in qaux.items()}})
    rng = np.random.RandomState(32)
    xs = [rng.randn(n, 3, 16, 16).astype(np.float32) for n in (1, 3, 4, 2, 1, 4)]
    kernels.reset_launches()
    eng = serving.Engine(sfile, pfile, {"data": (3, 16, 16)}, ladder=serving.BucketLadder((1, 4)),
                         max_wait_ms=2.0, start=False)
    try:
        warm = eng.warmup()
        eng.start()
        replies = [eng.predict({"data": x}) for x in xs]  # one request a batch
    finally:
        eng.close()
    torch.cuda.synchronize()
    forwards = len(warm) + eng.stats()["batches"]
    assert eng.stats()["batches"] == len(xs)
    n_q, n_dq = _plan_int8_nodes(eng._proto._exec)
    assert n_q > 0 and n_dq > 0
    assert kernels.quantize_int8.launches == n_q * forwards
    assert kernels.dequantize_int8.launches == n_dq * forwards
    ref = Predictor(sfile, pfile, {"data": (1, 3, 16, 16)})
    for x, got in zip(xs, replies):
        b = 1 if len(x) == 1 else 4
        pad = np.zeros((b, 3, 16, 16), np.float32)
        pad[:len(x)] = x
        want = ref.with_shapes({"data": pad.shape}).forward(data=pad)[0].cpu().numpy()
        np.testing.assert_array_equal(got[0], want[:len(x)])


def test_full_fp32_across_threads_keeps_a_convolution_in_fp32(cuda):
    """Thread A enters ``full_fp32``, thread B enters, A leaves, then B runs
    a cuDNN convolution with TF32 allowed outside: B's result equals a
    single-thread ``full_fp32`` run bit for bit (a per-block save and
    restore turned TF32 back on under B)."""
    import threading

    from mxnet_tpu_torch.context import full_fp32

    gen = torch.Generator().manual_seed(33)
    x = torch.randn((8, 64, 56, 56), generator=gen).to(cuda)
    w = torch.randn((64, 64, 3, 3), generator=gen).to(cuda) * 0.05

    def conv():
        return torch.nn.functional.conv2d(x, w, padding=1)

    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        with full_fp32():
            ref = conv()
        ev = {k: threading.Event() for k in ("a_in", "b_in", "a_out")}
        got = {}

        def a():
            with full_fp32():
                ev["a_in"].set()
                ev["b_in"].wait(30)
            ev["a_out"].set()

        def b():
            ev["a_in"].wait(30)
            with full_fp32():
                ev["b_in"].set()
                ev["a_out"].wait(30)
                got["out"] = conv()
                torch.cuda.synchronize()

        threads = [threading.Thread(target=f) for f in (a, b)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
        assert torch.equal(got["out"], ref)
        assert torch.backends.cudnn.allow_tf32 is True
        # the control: outside full_fp32 the convolution rounds through TF32
        assert not torch.equal(conv(), ref)
    finally:
        torch.backends.cudnn.allow_tf32 = saved

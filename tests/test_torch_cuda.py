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


@pytest.mark.parametrize("c", [1, 72, 128])
def test_dconv_kernel_matches_plain(cuda, c):
    rng = np.random.RandomState(c)
    BG, N, H, W = 4, 500, 19, 23
    y0 = rng.randint(0, H, (BG, N))
    x0 = rng.randint(0, W, (BG, N))
    y0[:, :20] = H - 1  # clamped corners
    x0[:, 10:30] = W - 1
    args = [y0, np.minimum(y0 + 1, H - 1), x0, np.minimum(x0 + 1, W - 1)]
    t = [torch.from_numpy(a.astype(np.int32)).to(cuda) for a in args]
    t += [torch.from_numpy(a.astype(np.float32)).to(cuda) for a in (
        rng.rand(BG, N), rng.rand(BG, N), rng.rand(BG, N) > 0.2,
        rng.randn(BG, H * W, c))]
    # at most four fp32 products per output, in another order than the bmm
    torch.testing.assert_close(kernels.dconv_col(*t, (H, W)),
                               kernels.dconv_col_plain(*t, (H, W)),
                               rtol=1e-5, atol=1e-5)


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


# (BG, N, H, W, C): the res5 shapes of the train path at batch 1, then small
# ones with C not a multiple of 32
@pytest.mark.parametrize("shape", [(4, 21888, 38, 64, 128), (3, 500, 19, 23, 1),
                                   (3, 500, 19, 23, 72)])
def test_dconv_bwd_kernel_matches_plain(cuda, shape):
    BG, N, H, W, C = shape
    rng = np.random.RandomState(C)
    t = _dconv_args(rng, BG, N, H, W, C, cuda)
    g = torch.from_numpy(rng.randn(BG, N, C).astype(np.float32)).to(cuda)
    before = kernels.dconv_col_bwd.launches
    got = kernels.dconv_col_bwd(*t, g, (H, W))
    assert kernels.dconv_col_bwd.launches == before + 1
    ref = kernels.dconv_col_bwd_plain(*t, g, (H, W))
    # sums over C in another order; d_ft sums by atomics in an order that
    # changes from run to run: a tolerance, never bitwise
    for name, a, b in zip(("d_ly", "d_lx", "d_lf", "d_ft"), got, ref):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5 * float(b.abs().max()),
                                   msg=lambda m, n=name: "%s: %s" % (n, m))
    y0, y1, x0, x1, _, _, lf = t[:7]
    assert bool((got[0][y0 == y1] == 0).all()) and bool((got[1][x0 == x1] == 0).all())
    assert bool((got[0][lf == 0] == 0).all()) and bool((got[1][lf == 0] == 0).all())


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
    with pytest.raises(ValueError, match="contiguous"):
        kernels.dconv_col_bwd(*t, torch.rand(1, 8, 40, device=cuda).transpose(1, 2),
                              (5, 6))
    yv, xv = torch.rand(4, 2, 3, device=cuda), torch.rand(4, 2, 5, device=cuda)
    with pytest.raises(ValueError, match="g must be"):
        kernels.psroi_abuild_bwd(yv, xv, torch.rand(4, 5, 3, device=cuda))
    with pytest.raises(ValueError, match="float32"):
        kernels.psroi_abuild_bwd(yv.double(), xv.double(),
                                 torch.rand(4, 3, 5, device=cuda).double())


def test_autograd_functions_launch_the_kernels_and_never_the_plain(cuda, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a plain version ran on CUDA tensors")

    for name in kernels.KERNELS:
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
    assert {n: k.wrapper.launches for n, k in kernels.KERNELS.items()} == {
        "nms_alive": 0, "dconv_col": 1, "psroi_abuild": 1, "dconv_col_bwd": 1,
        "psroi_abuild_bwd": 1, "quantize_int8": 0, "dequantize_int8": 0}
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

    for name in kernels.KERNELS:
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

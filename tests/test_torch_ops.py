"""The port's operators (mxnet_tpu_torch/ops) against mxnet_tpu.ops on the
same numpy inputs, on the CPU (the kernels' plain versions)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.ops import detection as jdet
from mxnet_tpu.ops import matrix as jmat
from mxnet_tpu.ops import nn as jnn
from mxnet_tpu_torch.ops import detection as tdet
from mxnet_tpu_torch.ops import matrix as tmat
from mxnet_tpu_torch.ops import nn as tnn


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread keeps this file off
    the cores that the suite's parallel workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("op", ["Activation", "relu", "RNN"])
def test_relu_matches_jax_but_keeps_the_reference_gradient_at_zero(op):
    """Every ReLU of the port (the Activation op, the relu op, the RNN op's
    relu mode) has the JAX op's values and gradients, but at an input of
    exactly 0 its gradient is 0, the reference's relu_grad, where the JAX
    op's ``jnp.maximum(x, 0)`` passes 1/2 (ROADMAP §C).  The RNN case is one
    step whose pre-activations are 0 (zero weights and biases), 1e-3 or
    -1e-3 (a bias of that value)."""
    from mxnet_tpu.ops import registry as jreg
    from mxnet_tpu_torch.ops import registry as treg

    if op == "RNN":
        kw = dict(state_size=3, num_layers=1, mode="rnn_relu")
        x = np.zeros(3 * 2 + 3 * 3 + 3 + 3, np.float32)  # i2h, h2h weights; biases
        x[15:18] = [0.0, 1e-3, -1e-3]  # the i2h biases
        args = (np.ones((1, 1, 2), np.float32), np.zeros((1, 1, 3), np.float32))
        jf = lambda p: jreg.get(op).fn(jnp.asarray(args[0]), p, jnp.asarray(args[1]),  # noqa: E731
                                       **kw)[0]
        tf = lambda p: treg.get(op).fn(_t(args[0]), p, _t(args[1]), **kw)[0]  # noqa: E731
        tie = np.zeros(x.size, bool)  # what reaches unit 0, whose pre-activation is 0
        tie[[0, 1, 15, 18]] = True  # (its h2h weights meet a zero state)
        g = np.array([[[1.0, 2.0, 3.0]]], np.float32)
    else:
        kw = {"act_type": "relu"} if op == "Activation" else {}
        x = np.array([-2.0, -0.0, 0.0, 1e-30, 3.0, 0.0], np.float32)
        jf = lambda a: jreg.get(op).fn(a, **kw)  # noqa: E731
        tf = lambda a: treg.get(op).fn(a, **kw)  # noqa: E731
        tie = x == 0
        g = np.arange(1.0, 7.0, dtype=np.float32)
    ref_y, vjp = jax.vjp(jf, jnp.asarray(x))
    (ref_dx,) = vjp(jnp.asarray(g))
    xt = _t(x).requires_grad_()
    y = tf(xt)
    y.backward(_t(g))
    got, ref = xt.grad.numpy(), np.asarray(ref_dx)
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(ref_y))
    np.testing.assert_array_equal(got[~tie], ref[~tie])
    assert tie.any() and (got[tie] == 0).all() and (ref[tie] != 0).all()


def test_convolution_with_stride_pad_dilation():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 8, 13, 11).astype(np.float32)
    w = rng.randn(6, 8, 3, 3).astype(np.float32)
    b = rng.randn(6).astype(np.float32)
    kw = dict(kernel=(3, 3), num_filter=6, stride=(2, 1), dilate=(2, 2), pad=(2, 1))
    ref = np.asarray(jnn.convolution(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), **kw))
    got = tnn.convolution(_t(x), _t(w), _t(b), **kw).numpy()
    # 72-term fp32 sums of N(0, 1) products, another summation order
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("gluon", [True, False])
def test_batch_norm_global_stats(gluon):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 5, 4, 3).astype(np.float32)
    g, b, m = (rng.randn(5).astype(np.float32) for _ in range(3))
    v = rng.rand(5).astype(np.float32) + 0.1
    kw = dict(eps=1e-5, fix_gamma=False) if gluon else {}  # else: the op's defaults
    ref = np.asarray(jnn.batch_norm(*map(jnp.asarray, (x, g, b, m, v)),
                                    use_global_stats=True, **kw)[0])
    got = tnn.batch_norm(*map(_t, (x, g, b, m, v)), **kw).numpy()
    # same elementwise formula; only the final x·scale + shift may fuse
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def test_max_pooling_valid_convention():
    rng = np.random.RandomState(2)
    x = rng.randn(2, 3, 15, 10).astype(np.float32)
    kw = dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1))
    ref = np.asarray(jnn.pooling(jnp.asarray(x), pool_type="max", **kw))
    got = tnn.pooling(_t(x), **kw).numpy()
    np.testing.assert_array_equal(got, ref)  # a max picks an input exactly


@pytest.mark.parametrize("target", [(0, 2, -1, 0), (0, 0, -1), (0, 3, 5, 6),
                                    (4, -1), (-1,)])
def test_reshape_specials(target):
    shape = (4, 6, 5, 3)
    assert tmat.infer_reshape(shape, target) == jmat.infer_reshape(shape, target)
    x = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    np.testing.assert_array_equal(
        tmat.reshape(_t(x), target).numpy(),
        np.asarray(jmat.reshape_op(jnp.asarray(x), shape=target)))


def test_reshape_rejects_codes_not_ported():
    """Every MXNet code (-2, -3 and -4 too) is ported now and resolves as
    the JAX function does; a code that MXNet does not have raises."""
    for target in ((0, -3), (-4, 2, -1, 0, 0), (0, -2)):
        assert tmat.infer_reshape((4, 6, 5), target) == jmat.infer_reshape((4, 6, 5), target)
    with pytest.raises(ValueError, match="-5"):
        tmat.infer_reshape((4, 6, 5), (0, -5))


@pytest.mark.parametrize("size,dg,cin", [(7, 2, 8), (28, 1, 8)],
                         ids=["gather_path", "separable_path"])
def test_deformable_convolution(size, dg, cin):
    """7×7 takes the JAX gather path, 28×28 (N·H·W ≥ 2²²) its separable
    one-hot path; the port has one formulation for both."""
    rng = np.random.RandomState(size)
    B, F, K = 2, 6, 3
    x = rng.randn(B, cin, size, size).astype(np.float32)
    # fractional offsets, some samples off the map (|Δ| up to ~4 px)
    off = (rng.randn(B, 2 * dg * K * K, size, size) * 1.5).astype(np.float32)
    w = rng.randn(F, cin, K, K).astype(np.float32)
    b = rng.randn(F).astype(np.float32)
    kw = dict(kernel=(K, K), num_filter=F, stride=(1, 1), dilate=(2, 2),
              pad=(2, 2), num_deformable_group=dg)
    assert (9 * size * size * size * size >= (1 << 22)) == (size == 28)
    ref = np.asarray(jdet.deformable_convolution(
        *map(jnp.asarray, (x, off, w, b)), **kw))
    got = tdet.deformable_convolution(*map(_t, (x, off, w, b)), **kw).numpy()
    # bilinear samples then a 72-term fp32 product, in another order
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("offsets", ["zero", "random"])
@pytest.mark.parametrize("size,dg,cin", [(7, 2, 8), (28, 1, 8)],
                         ids=["gather_path", "separable_path"])
def test_deformable_convolution_gradients(size, dg, cin, offsets):
    """Gradients of data, offset and weight against ``jax.grad``.  With zero
    offsets the taps sample at integer points, many exactly on row or
    column 0 (pad = dilation = 2, as in res5): ``jnp.clip`` passes half the
    gradient at such a tie, ``torch.clamp`` would pass all of it."""
    rng = np.random.RandomState(size + (offsets == "zero"))
    B, F, K = 2, 6, 3
    x = rng.randn(B, cin, size, size).astype(np.float32)
    off = (np.zeros((B, 2 * dg * K * K, size, size), np.float32)
           if offsets == "zero" else
           (rng.randn(B, 2 * dg * K * K, size, size) * 1.5).astype(np.float32))
    w = rng.randn(F, cin, K, K).astype(np.float32)
    ct = rng.randn(B, F, size, size).astype(np.float32)
    kw = dict(kernel=(K, K), num_filter=F, stride=(1, 1), dilate=(2, 2),
              pad=(2, 2), num_deformable_group=dg, no_bias=True)
    ref = jax.jit(jax.grad(
        lambda *a: (jdet.deformable_convolution(*a, **kw) * ct).sum(),
        argnums=(0, 1, 2)))(*map(jnp.asarray, (x, off, w)))
    leaves = [_t(a).requires_grad_() for a in (x, off, w)]
    (tdet.deformable_convolution(*leaves, **kw) * _t(ct)).sum().backward()
    # bilinear samples and a 72-term fp32 product, summed in another order
    for name, r, leaf in zip(("data", "offset", "weight"), ref, leaves):
        r = np.asarray(r)
        np.testing.assert_allclose(leaf.grad.numpy(), r, rtol=1e-5,
                                   atol=1e-5 * np.abs(r).max(), err_msg=name)


def test_deformable_convolution_hands_the_backward_g_as_it_comes(monkeypatch):
    """The column gradient reaches ``dconv_col_bwd`` as the channel-major view
    the autograd makes (no copy), with the factors laid out (tap, ho, wo)."""
    from mxnet_tpu_torch.ops import kernels

    seen = []
    wrapper = kernels.dconv_col_bwd

    def record(*args, **kw):
        seen.append(args)
        return wrapper(*args, **kw)

    monkeypatch.setattr(kernels, "dconv_col_bwd", record)
    rng = np.random.RandomState(3)
    B, C, H, W, DG = 2, 8, 6, 7, 2
    leaves = [_t(rng.randn(*s).astype(np.float32)).requires_grad_() for s in
              ((B, C, H, W), (B, 2 * DG * 9, H, W), (5, C, 3, 3))]
    out = tdet.deformable_convolution(*leaves, kernel=(3, 3), num_filter=5,
                                      dilate=(2, 2), pad=(2, 2),
                                      num_deformable_group=DG, no_bias=True)
    out.square().sum().backward()
    (args,) = seen
    g = args[8]
    N = 9 * H * W
    assert g.shape == (B * DG, N, C // DG) and g.stride() == (C // DG * N, 1, N)
    factors = tdet.dconv_sample_factors(leaves[1].detach(), (H, W), (3, 3), (1, 1),
                                        (2, 2), (2, 2))
    for a, b in zip(args[:7], factors):
        assert torch.equal(a, b)


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_deformable_convolution_hands_bmm_the_kernels_column(monkeypatch, device):
    """The weight product reads ``dconv_col``'s own storage: the reshapes
    between them are views of the channel-major column, not a copy."""
    from mxnet_tpu_torch.ops import kernels

    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
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
    rng = np.random.RandomState(4)
    B, C, H, W, DG = 2, 8, 6, 7, 2
    data, off, w = (_t(rng.randn(*s).astype(np.float32)).to(device) for s in
                    ((B, C, H, W), (B, 2 * DG * 9, H, W), (5, C, 3, 3)))
    tdet.deformable_convolution(data, off, w, kernel=(3, 3), num_filter=5,
                                dilate=(2, 2), pad=(2, 2), num_deformable_group=DG,
                                no_bias=True)
    # the last product is the weight's (on the CPU the plain column is one too)
    (col,), operand = cols, operands[-1]
    assert col.stride() == (C // DG * 9 * H * W, 1, 9 * H * W)
    assert operand.shape == (B, C * 9, H * W)
    assert operand.untyped_storage().data_ptr() == col.untyped_storage().data_ptr()


def _rois(rng, B, per_image, extent_h, extent_w, grouped):
    x1 = rng.uniform(-10, extent_w - 10, (B * per_image,))
    y1 = rng.uniform(-10, extent_h - 10, (B * per_image,))
    x2 = x1 + rng.uniform(2, extent_w / 2, x1.shape)
    y2 = y1 + rng.uniform(2, extent_h / 2, y1.shape)
    bidx = (np.arange(B * per_image) // per_image if grouped
            else rng.randint(0, B, B * per_image))
    return np.stack([bidx, x1, y1, x2, y2], 1).astype(np.float32)


@pytest.mark.parametrize("grouped", [True, False], ids=["grouped", "general"])
@pytest.mark.parametrize("with_trans", [True, False], ids=["trans", "no_trans"])
@pytest.mark.parametrize("big", [True, False], ids=["separable", "gather"])
def test_deformable_psroi_pooling(grouped, with_trans, big):
    """``big`` crosses the JAX package's separable-path threshold
    (R·K·PH·PW·spp²·cpc ≥ 2¹⁶); the port always builds A."""
    rng = np.random.RandomState(int(grouped) + 2 * int(with_trans) + 4 * int(big))
    B, H, W = 2, 10, 12
    k, spp = (7, 4) if big else (3, 2)
    Rb, OD, ncls = (16, 8, 2) if big else (3, 4, 2)
    data = rng.randn(B, OD * k * k, H, W).astype(np.float32)
    rois = _rois(rng, B, Rb, 2 * H, 2 * W, grouped)
    trans = ((rng.randn(B * Rb, 2 * ncls, k, k) * 0.5).astype(np.float32)
             if with_trans else None)
    kw = dict(spatial_scale=0.5, output_dim=OD, group_size=k, pooled_size=k,
              part_size=k, sample_per_part=spp, trans_std=0.1,
              no_trans=not with_trans, rois_per_image=Rb if grouped else 0)
    K = ncls if with_trans else 1
    assert (B * Rb * K * k * k * spp * spp * (OD // K) >= (1 << 16)) == big
    ref = np.asarray(jdet.deformable_psroi_pooling(
        jnp.asarray(data), jnp.asarray(rois),
        None if trans is None else jnp.asarray(trans), **kw))
    got = tdet.deformable_psroi_pooling(
        _t(data), _t(rois), None if trans is None else _t(trans), **kw).numpy()
    # means of ≤ spp² bilinear samples of N(0, 1) data, another order
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("grouped", [True, False], ids=["grouped", "general"])
@pytest.mark.parametrize("big", [True, False], ids=["separable", "gather"])
def test_deformable_psroi_pooling_gradients(grouped, big):
    """Gradients of the score maps and the offsets against ``jax.grad``."""
    rng = np.random.RandomState(10 + int(grouped) + 2 * int(big))
    B, H, W = 2, 10, 12
    k, spp = (7, 4) if big else (3, 2)
    Rb, OD = (16, 8) if big else (3, 4)
    data = rng.randn(B, OD * k * k, H, W).astype(np.float32)
    rois = _rois(rng, B, Rb, 2 * H, 2 * W, grouped)
    trans = (rng.randn(B * Rb, 2, k, k) * 0.5).astype(np.float32)
    ct = rng.randn(B * Rb, OD, k, k).astype(np.float32)
    kw = dict(spatial_scale=0.5, output_dim=OD, group_size=k, pooled_size=k,
              part_size=k, sample_per_part=spp, trans_std=0.1,
              rois_per_image=Rb if grouped else 0)
    ref = jax.jit(jax.grad(
        lambda d, t: (jdet.deformable_psroi_pooling(d, jnp.asarray(rois), t, **kw)
                      * ct).sum(), argnums=(0, 1)))(jnp.asarray(data), jnp.asarray(trans))
    leaves = [_t(data).requires_grad_(), _t(trans).requires_grad_()]
    (tdet.deformable_psroi_pooling(leaves[0], _t(rois), leaves[1], **kw)
     * _t(ct)).sum().backward()
    # means of ≤ spp² bilinear samples and their coordinate derivatives,
    # summed in another order
    for name, r, leaf in zip(("data", "trans"), ref, leaves):
        r = np.asarray(r)
        np.testing.assert_allclose(leaf.grad.numpy(), r, rtol=1e-5,
                                   atol=1e-5 * np.abs(r).max(), err_msg=name)


def test_generate_base_anchors_is_the_reference_copy():
    for stride, scales, ratios in ((16, (4, 8, 16, 32), (0.5, 1, 2)),
                                   (16, (1, 2), (0.5, 1, 2))):
        np.testing.assert_array_equal(
            tdet.generate_base_anchors(stride, scales, ratios),
            jdet._generate_base_anchors(stride, scales, ratios))


@pytest.mark.parametrize("hf,wf,pre,post", [(4, 6, 200, 32), (16, 24, 1500, 100)])
def test_multi_proposal(hf, wf, pre, post):
    rng = np.random.RandomState(hf)
    B, scales, ratios = 2, (2, 4), (0.5, 1, 2)
    A = len(scales) * len(ratios)
    fg = rng.rand(B, A, hf, wf).astype(np.float32)
    cls_prob = np.concatenate([1 - fg, fg], 1)
    bbox_pred = (rng.randn(B, 4 * A, hf, wf) * 0.3).astype(np.float32)
    # the second image is smaller than the map: its padded cells score -1
    im_info = np.array([[hf * 16, wf * 16, 1.0],
                        [hf * 16 - 40, wf * 16 - 56, 1.5]], np.float32)
    kw = dict(rpn_pre_nms_top_n=pre, rpn_post_nms_top_n=post, threshold=0.7,
              rpn_min_size=16, scales=scales, ratios=ratios, feature_stride=16)
    ref = np.asarray(jdet.multi_proposal(
        *map(jnp.asarray, (cls_prob, bbox_pred, im_info)), **kw))
    got = tdet.multi_proposal(*map(_t, (cls_prob, bbox_pred, im_info)), **kw).numpy()
    assert got.shape == (B * post, 5)
    # box decode in fp32 (exp, products); the sort and NMS see equal scores
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)

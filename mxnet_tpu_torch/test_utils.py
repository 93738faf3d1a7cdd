"""Checkpoints and operator cases the tests, ``chip_smoke.py`` and
benchmarks share (counterpart of the parts of ``mxnet_tpu/test_utils.py``
the port needs)."""
from __future__ import annotations

import zlib

import numpy as np
import torch

from . import symbol as sym

__all__ = ["deploy_twin_checkpoint", "tiny_mlp_checkpoint", "registry_cases",
           "register_numpy_softmax", "OpCase"]


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


class OpCase:
    """One operator case: ``op`` (the registered name), ``inputs`` (numpy
    arrays), ``attrs``, ``grad`` (the indices of the inputs to
    differentiate), ``rtol`` / ``atol``, ``exact`` (outputs compared for
    equality), and ``why`` (the reason for a looser tolerance)."""

    def __init__(self, op, inputs, attrs=None, grad=(), rtol=1e-5, atol=1e-6, exact=False,
                 why=""):
        self.op, self.inputs, self.attrs = op, inputs, dict(attrs or {})
        self.grad, self.rtol, self.atol, self.exact, self.why = tuple(grad), rtol, atol, exact, why


def _spd(rng, n, b=2):
    m = rng.uniform(-1, 1, (b, n, n))
    return (m @ np.swapaxes(m, -1, -2) + n * np.eye(n)).astype(np.float32)


def _lower(rng, n, b=None):
    shape = (n, n) if b is None else (b, n, n)
    m = np.tril(rng.uniform(-0.5, 0.5, shape))
    return (m + 2.0 * np.eye(n)).astype(np.float32)


def _boxes(u):
    """(R, 4) uniforms -> rois (R, 5) of image 0, each at least 4 wide and
    high."""
    x1, y1 = u[:, 0:1], u[:, 1:2]
    return np.concatenate([np.zeros_like(x1), x1, y1, x1 + 4 + u[:, 2:3] / 2,
                           y1 + 4 + u[:, 3:4] / 2], axis=1).astype(np.float32)


def registry_cases():
    """{case name: OpCase} for the operators of ``mxnet_tpu/ops`` nn, linalg,
    contrib, misc, ROIAlign, the R-CNN targets and Custom (``name#variant``
    for a further case of an op); the inputs drawn from a
    ``RandomState`` seeded by the case name, at the CPU tests' sizes.
    Custom's case runs the prop of :func:`register_numpy_softmax`."""
    cases = {}

    def case(name, build):
        rng = np.random.RandomState(zlib.crc32(name.encode()))

        def U(*shape, lo=-2.0, hi=2.0):
            return rng.uniform(lo, hi, shape).astype(np.float32)

        cases[name] = build(rng, U)

    f32 = np.float32
    # -- nn
    case("Deconvolution", lambda r, U: OpCase("Deconvolution", [U(1, 4, 5, 5), U(4, 3, 3, 3), U(6)], dict(
        kernel=(3, 3), num_filter=6, stride=(2, 2), pad=(1, 1), adj=(1, 1), num_group=2,
        no_bias=False), grad=(0, 1, 2)))
    case("Deconvolution#dilate", lambda r, U: OpCase("Deconvolution", [U(2, 3, 4, 4), U(3, 2, 3, 3)], dict(
        kernel=(3, 3), num_filter=2, dilate=(2, 2), stride=(1, 2)), grad=(0, 1)))
    case("_contrib_AdaptiveAvgPooling2D", lambda r, U: OpCase(
        "_contrib_AdaptiveAvgPooling2D", [U(2, 3, 7, 5)], dict(output_size=(3, 2)), grad=(0,)))
    case("LayerNorm", lambda r, U: OpCase("LayerNorm", [U(2, 3, 4), U(4), U(4)], dict(eps=1e-5),
                                          grad=(0, 1, 2)))
    case("InstanceNorm", lambda r, U: OpCase("InstanceNorm", [U(2, 3, 4, 5), U(3), U(3)], {},
                                             grad=(0, 1, 2)))
    case("LRN", lambda r, U: OpCase("LRN", [U(2, 7, 3, 3)], dict(nsize=5, alpha=0.1, beta=0.75,
                                                                 knorm=2.0), grad=(0,)))
    for act, extra in (("leaky", dict(slope=0.3)), ("elu", dict(slope=0.5)), ("selu", {}),
                       ("gelu", {}), ("rrelu", {})):
        case("LeakyReLU#" + act, lambda r, U, act=act, extra=extra: OpCase(
            "LeakyReLU", [U(2, 3, 4)], dict(act_type=act, **extra), grad=(0,)))
    case("LeakyReLU", lambda r, U: OpCase("LeakyReLU", [U(2, 3, 4), U(3, lo=0.1, hi=0.5)],
                                          dict(act_type="prelu"), grad=(0, 1)))
    case("log_softmax", lambda r, U: OpCase("log_softmax", [U(3, 5)], dict(temperature=2.0),
                                            grad=(0,)))
    case("softmin", lambda r, U: OpCase("softmin", [U(3, 5)], dict(axis=0), grad=(0,)))
    case("SoftmaxActivation", lambda r, U: OpCase("SoftmaxActivation", [U(2, 3, 2, 2)], {},
                                                  grad=(0,)))
    case("SoftmaxActivation#channel", lambda r, U: OpCase(
        "SoftmaxActivation", [U(2, 3, 2, 2)], dict(mode="channel"), grad=(0,)))
    for name in ("LinearRegressionOutput", "MAERegressionOutput", "LogisticRegressionOutput"):
        case(name, lambda r, U, name=name: OpCase(name, [U(4, 3), U(4, 3, lo=0.0, hi=1.0)],
                                                  dict(grad_scale=0.5), grad=(0,)))
    case("MakeLoss", lambda r, U: OpCase("MakeLoss", [U(4, 3)],
                                         dict(grad_scale=2.0, normalization="batch"), grad=(0,)))
    case("SVMOutput", lambda r, U: OpCase("SVMOutput", [U(4, 5), np.array([0, 3, 4, 1], f32)],
                                          dict(margin=1.0, regularization_coefficient=0.7),
                                          grad=(0,)))
    case("SVMOutput#linear", lambda r, U: OpCase(
        "SVMOutput", [U(4, 5), np.array([2, 0, 1, 4], f32)], dict(use_linear=True), grad=(0,)))
    case("UpSampling", lambda r, U: OpCase("UpSampling", [U(1, 2, 3, 3)], dict(scale=2),
                                           grad=(0,)))
    case("UpSampling#inputs", lambda r, U: OpCase("UpSampling", [U(1, 2, 6, 6), U(1, 1, 3, 3)],
                                                  dict(scale=2, num_args=2), grad=(0, 1)))
    case("UpSampling#bilinear", lambda r, U: OpCase(
        "UpSampling", [U(1, 2, 3, 3), U(2, 1, 4, 4)],
        dict(scale=2, sample_type="bilinear", num_args=2), grad=(0, 1)))
    # samples up to 30% outside the image: the zero-weight border
    case("BilinearSampler", lambda r, U: OpCase(
        "BilinearSampler", [U(2, 3, 5, 6), U(2, 2, 4, 4, lo=-1.3, hi=1.3)], {}, grad=(0, 1)))
    case("GridGenerator", lambda r, U: OpCase(
        "GridGenerator", [U(2, 6)], dict(transform_type="affine", target_shape=(4, 5)),
        grad=(0,)))
    case("GridGenerator#warp", lambda r, U: OpCase(
        "GridGenerator", [U(2, 2, 3, 4)], dict(transform_type="warp"), grad=(0,)))
    case("SpatialTransformer", lambda r, U: OpCase(
        "SpatialTransformer", [U(2, 3, 5, 6), U(2, 6, lo=-1.2, hi=1.2)],
        dict(target_shape=(4, 4), transform_type="affine"), grad=(0, 1)))
    # -- linalg
    case("_linalg_gemm", lambda r, U: OpCase("_linalg_gemm", [U(2, 4, 3), U(2, 4, 5), U(2, 3, 5)],
                                             dict(transpose_a=True, alpha=0.7, beta=1.3),
                                             grad=(0, 1, 2)))
    case("_linalg_gemm#axis", lambda r, U: OpCase(
        "_linalg_gemm", [U(3, 2, 4), U(4, 2, 5), U(3, 2, 5)], dict(axis=0), grad=(0, 1, 2)))
    case("_linalg_gemm2", lambda r, U: OpCase("_linalg_gemm2", [U(3, 4), U(5, 4)],
                                              dict(transpose_b=True, alpha=2.0), grad=(0, 1)))
    case("_linalg_potrf", lambda r, U: OpCase("_linalg_potrf", [_spd(r, 3)], {}, grad=(0,)))
    case("_linalg_potri", lambda r, U: OpCase(
        "_linalg_potri", [_lower(r, 3, 2)], {}, grad=(0,), rtol=1e-4,
        why="two triangular solves and a product: 1e-5 relative differences in float32"))
    case("_linalg_trmm", lambda r, U: OpCase("_linalg_trmm", [U(3, 3), U(3, 4)],
                                             dict(alpha=1.5), grad=(0, 1)))
    case("_linalg_trmm#right", lambda r, U: OpCase(
        "_linalg_trmm", [U(3, 3), U(4, 3)], dict(rightside=True, transpose=True, lower=False),
        grad=(0, 1)))
    case("_linalg_trsm", lambda r, U: OpCase("_linalg_trsm", [_lower(r, 3), U(3, 4)],
                                             dict(alpha=0.5), grad=(1,)))
    case("_linalg_trsm#right", lambda r, U: OpCase(
        "_linalg_trsm", [_lower(r, 3), U(4, 3)], dict(rightside=True, transpose=True),
        grad=(1,)))
    case("_linalg_sumlogdiag", lambda r, U: OpCase("_linalg_sumlogdiag", [_lower(r, 3, 2)], {},
                                                   grad=(0,)))
    case("_linalg_syrk", lambda r, U: OpCase("_linalg_syrk", [U(3, 4)], dict(alpha=0.5),
                                             grad=(0,)))
    case("_linalg_syrk#transpose", lambda r, U: OpCase(
        "_linalg_syrk", [U(3, 4)], dict(transpose=True), grad=(0,)))
    case("_linalg_gelqf", lambda r, U: OpCase("_linalg_gelqf", [U(3, 5)], {}, grad=(0,)))
    case("_linalg_syevd", lambda r, U: OpCase(
        "_linalg_syevd", [_spd(r, 3, 1)[0]], {}, grad=(0,), rtol=1e-4,
        why="LAPACK's symmetric eigensolver: float32 eigenvectors within 1e-5 relative"))
    # -- contrib
    case("_contrib_CTCLoss", lambda r, U: OpCase(
        "_contrib_CTCLoss", [U(6, 2, 5), np.array([[1, 2, 2], [3, 0, 0]], f32)], {}, grad=(0,),
        rtol=1e-4, why="the gradient sums exp of log-space terms over 6 steps"))
    case("_contrib_CTCLoss#last", lambda r, U: OpCase(
        "_contrib_CTCLoss", [U(6, 2, 5), np.array([[0, 1, 1], [2, -1, -1]], f32)],
        dict(blank_label="last"), grad=(0,), rtol=1e-4,
        why="the gradient sums exp of log-space terms over 6 steps"))
    case("_contrib_CTCLoss#lengths", lambda r, U: OpCase(
        "_contrib_CTCLoss", [U(6, 2, 5), np.array([[1, 2, 3], [4, 2, 1]], f32),
                             np.array([6, 4], f32), np.array([3, 1], f32)],
        dict(use_data_lengths=True, use_label_lengths=True), grad=(0,), rtol=1e-4,
        why="the gradient sums exp of log-space terms over 6 steps"))
    case("_contrib_fft", lambda r, U: OpCase("_contrib_fft", [U(2, 4)], {}, grad=(0,), rtol=1e-4,
                                             why="pocketfft and XLA's FFT order their sums "
                                             "differently"))
    case("_contrib_ifft", lambda r, U: OpCase("_contrib_ifft", [U(2, 8)], {}, grad=(0,),
                                              rtol=1e-4, why="pocketfft and XLA's FFT order "
                                              "their sums differently"))
    case("_contrib_count_sketch", lambda r, U: OpCase(
        "_contrib_count_sketch", [U(3, 5), np.array([0, 3, 1, 3, 2], f32),
                                  np.array([1, -1, -1, 1, 1], f32)], dict(out_dim=4),
        grad=(0,)))
    case("khatri_rao", lambda r, U: OpCase("khatri_rao", [U(2, 3), U(4, 3)], {}, grad=(0, 1)))
    case("_contrib_quadratic", lambda r, U: OpCase("_contrib_quadratic", [U(3, 4)],
                                                   dict(a=0.5, b=-1.5, c=2.0), grad=(0,)))
    case("_contrib_BilinearResize2D", lambda r, U: OpCase(
        "_contrib_BilinearResize2D", [U(1, 2, 3, 4)], dict(height=5, width=7), grad=(0,)))
    case("_contrib_div_sqrt_dim", lambda r, U: OpCase("_contrib_div_sqrt_dim", [U(2, 3, 5)],
                                                      {}, grad=(0,)))
    case("Correlation", lambda r, U: OpCase(
        "Correlation", [U(1, 3, 6, 6), U(1, 3, 6, 6)],
        dict(kernel_size=1, max_displacement=1, pad_size=1), grad=(0, 1)))
    case("Correlation#window", lambda r, U: OpCase(
        "Correlation", [U(1, 2, 7, 7), U(1, 2, 7, 7)],
        dict(kernel_size=3, max_displacement=2, stride1=2, stride2=2, pad_size=2,
             is_multiply=False), grad=(0, 1)))
    case("Crop", lambda r, U: OpCase("Crop", [U(1, 2, 6, 7)], dict(h_w=(3, 4), offset=(1, 2)),
                                     grad=(0,)))
    case("Crop#center", lambda r, U: OpCase("Crop", [U(1, 2, 6, 7)],
                                            dict(h_w=(3, 3), center_crop=True), grad=(0,)))
    case("Crop#like", lambda r, U: OpCase("Crop", [U(1, 2, 6, 7), U(1, 1, 4, 5)],
                                          dict(num_args=2, offset=(2, 1)), grad=(0,)))
    # -- misc
    case("hard_sigmoid", lambda r, U: OpCase("hard_sigmoid", [U(3, 4, lo=-4, hi=4)], {},
                                             grad=(0,)))
    case("_identity_with_attr_like_rhs", lambda r, U: OpCase(
        "_identity_with_attr_like_rhs", [U(3, 4), U(3, 4)], {}, grad=(0,)))
    case("_ravel_multi_index", lambda r, U: OpCase(
        "_ravel_multi_index", [np.array([[0, 2, 5, -1], [4, 1, 0, 7]], f32)],
        dict(shape=(3, 5)), exact=True))
    case("_unravel_index", lambda r, U: OpCase("_unravel_index", [np.array([0, 7, 14, 3], f32)],
                                               dict(shape=(3, 5)), exact=True))
    case("_square_sum", lambda r, U: OpCase("_square_sum", [U(2, 3, 4)],
                                            dict(axis=1, keepdims=True), grad=(0,)))
    case("_scatter_plus_scalar", lambda r, U: OpCase("_scatter_plus_scalar", [U(3, 4)],
                                                     dict(scalar=1.5), grad=(0,)))
    case("_scatter_minus_scalar", lambda r, U: OpCase("_scatter_minus_scalar", [U(3, 4)],
                                                      dict(scalar=1.5), grad=(0,)))
    case("_slice_assign", lambda r, U: OpCase(
        "_slice_assign", [U(4, 5), U(2, 2)], dict(begin=(1, 0), end=(3, 4), step=(1, 2)),
        grad=(0, 1)))
    case("_slice_assign_scalar", lambda r, U: OpCase(
        "_slice_assign_scalar", [U(4, 5)], dict(begin=(0, 1), end=(2, 5), scalar=3.0),
        grad=(0,)))
    case("_image_to_tensor", lambda r, U: OpCase(
        "_image_to_tensor", [r.randint(0, 256, (4, 5, 3)).astype(f32)], {}))
    case("_image_normalize", lambda r, U: OpCase(
        "_image_normalize", [U(3, 4, 5)], dict(mean=(0.1, 0.2, 0.3), std=(0.5, 0.6, 0.7)),
        grad=(0,)))
    case("_sparse_adagrad_update", lambda r, U: OpCase(
        "_sparse_adagrad_update", [U(3, 4), U(3, 4), U(3, 4, lo=0.2, hi=3.0)],
        dict(lr=0.1, wd=0.01, clip_gradient=0.5)))
    case("IdentityAttachKLSparseReg", lambda r, U: OpCase(
        "IdentityAttachKLSparseReg", [U(4, 3, lo=0.1, hi=0.9), U(3, lo=0.2, hi=0.8)],
        dict(penalty=0.01), grad=(0,)))
    # -- detection and the R-CNN targets
    rois = np.array([[0, 1, 1, 6, 5], [1, 0.5, 2, 7.5, 7], [0, -2, -1, 3, 4]], f32)
    case("_contrib_ROIAlign", lambda r, U: OpCase(
        "_contrib_ROIAlign", [U(2, 3, 8, 8), rois],
        dict(pooled_size=(2, 2), spatial_scale=1.0, sample_ratio=2), grad=(0,)))
    case("_contrib_ROIAlign#adaptive", lambda r, U: OpCase(
        "_contrib_ROIAlign", [U(2, 3, 8, 8), rois * np.array([1, 2, 2, 2, 2], f32)],
        dict(pooled_size=(2, 3), spatial_scale=0.5), grad=(0,)))
    gt = np.array([[[1, 4, 6, 30, 40], [0, 20, 10, 60, 50], [-1, -1, -1, -1, -1]]], f32)
    case("_contrib_rpn_anchor_target", lambda r, U: OpCase(
        "_contrib_rpn_anchor_target", [gt, np.array([[64, 64, 1]], f32), U(1, 144, 2, lo=0, hi=1)],
        dict(feat_height=4, feat_width=4, batch_rois=16)))
    case("_contrib_proposal_target", lambda r, U: OpCase(
        "_contrib_proposal_target", [_boxes(U(6, 4, lo=0, hi=50)), gt, U(1, 9, 2, lo=0, hi=1)],
        dict(num_classes=3, batch_images=1, batch_rois=8)))
    # -- Custom
    case("Custom", lambda r, U: OpCase("Custom", [U(4, 5), np.array([0, 3, 4, 1], f32)],
                                       dict(op_type="numpy_softmax"), grad=(0,)))
    return cases


def register_numpy_softmax(mx):
    """Register the reference's numpy softmax custom op as
    ``op_type="numpy_softmax"`` in the package ``mx`` (this one or the JAX
    package: the same code runs on both's NDArrays): softmax forward,
    ``p − onehot(label)`` backward whatever the head's gradient."""

    class NumpySoftmax(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0].asnumpy()
            y = np.exp(x - x.max(axis=1, keepdims=True))
            y /= y.sum(axis=1, keepdims=True)
            self.assign(out_data[0], req[0], mx.nd.array(y))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            lab = in_data[1].asnumpy().astype(np.int32)
            y = out_data[0].asnumpy().copy()
            y[np.arange(lab.shape[0]), lab] -= 1.0
            self.assign(in_grad[0], req[0], mx.nd.array(y))
            self.assign(in_grad[1], req[1], mx.nd.array(np.zeros(lab.shape, np.float32)))

    @mx.operator.register("numpy_softmax")
    class NumpySoftmaxProp(mx.operator.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=False)

        def list_arguments(self):
            return ["data", "label"]

        def list_outputs(self):
            return ["output"]

        def infer_shape(self, in_shape):
            return [in_shape[0], (in_shape[0][0],)], [in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            return NumpySoftmax()

    return "numpy_softmax"

"""The port's Deformable R-FCN inference (mxnet_tpu_torch) end to end against
the JAX model, on the tiny configuration of
examples/deformable_rfcn/train_fused.py (units (1,1,1,1), 64×96, 3 classes),
with the JAX weights carried across by ``load_jax_params``.

The comparison runs in stages, each fed the JAX stage's own inputs, so that
one near-tie in the proposal sort cannot hide a fault: trunk and RPN, then
MultiProposal, then the head, then the whole forward at a seed checked to
be tie-free.
"""
import ast
import pathlib

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import nd
from mxnet_tpu.gluon.model_zoo.detection import DeformableRFCN as JaxRFCN
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.gluon.model_zoo import (DeformableConv2D, DeformableRFCN,
                                             FasterRCNN, faster_rcnn_vgg16,
                                             load_jax_params, rfcn_resnet101)
from mxnet_tpu_torch.train_frcnn import TINY as TINY_FRCNN
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet18_v1

ROOT = pathlib.Path(__file__).resolve().parents[1]
CFG = dict(classes=3, image_shape=(64, 96), units=(1, 1, 1, 1), scales=(1, 2),
           rpn_pre_nms=200, rpn_post_nms=32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread keeps this file off
    the cores that the suite's parallel workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(a):
    return a.asnumpy() if hasattr(a, "asnumpy") else a.numpy()


@pytest.fixture(scope="module")
def pair():
    """(jax net, torch net, inputs, jax stage outputs), built once."""
    mx.random.seed(0)
    jnet = JaxRFCN(batch_rois=16, rpn_batch=32, max_gts=8, **CFG)
    jnet.initialize()
    jnet.init_params()
    rng = np.random.RandomState(0)
    # the offset and trans convs are zero-initialised, which would sample
    # only at integer points: give them (and the score maps) real weights
    scale = {"offset_weight": 0.2, "rfcn_trans_weight": 0.5,
             "rfcn_cls_weight": 4.0, "rfcn_bbox_weight": 4.0}
    for k, p in jnet.collect_params().items():
        for suffix, s in scale.items():
            if k.endswith(suffix):
                p.set_data(nd.array((rng.randn(*p.shape) * s).astype(np.float32)))
    params = {k[len(jnet.prefix):]: p.data().asnumpy()
              for k, p in jnet.collect_params().items()}
    tnet = load_jax_params(DeformableRFCN(device="cpu", **CFG), params)
    x = rng.randn(2, 3, 64, 96).astype(np.float32)
    # the second image is smaller than the input: padded cells score -1
    info = np.array([[64, 96, 1.0], [48, 80, 1.0]], np.float32)
    c4, c5 = (_np(a) for a in jnet._features(nd, nd.array(x)))
    rpn_cls, rpn_bbox = (_np(a) for a in jnet._rpn(nd, nd.array(c4)))
    rois = _np(jnet._proposals(nd, nd.array(rpn_cls), nd.array(rpn_bbox),
                               nd.array(info)))
    cls_score, bbox_pred = (_np(a) for a in jnet._head(
        nd, nd.array(c5), nd.array(rois), rois_per_image=CFG["rpn_post_nms"]))
    ref = dict(c4=c4, c5=c5, rpn_cls=rpn_cls, rpn_bbox=rpn_bbox, rois=rois,
               cls_score=cls_score, bbox_pred=bbox_pred)
    return jnet, tnet, params, x, info, ref


def _t(a):
    return torch.from_numpy(np.array(a))


def test_param_names_map_one_to_one(pair):
    _, tnet, params, *_ = pair
    assert len(params) == 101
    assert set(tnet.gluon_named_tensors()) == set(params)


def test_trunk_and_rpn_match(pair):
    _, tnet, _, x, _, ref = pair
    with torch.inference_mode():
        c4, c5 = tnet._features(_t(x))
        rpn_cls, rpn_bbox = tnet._rpn(_t(ref["c4"]))
    # fp32 convs summed in another order over up to 4608 terms: rtol 1e-4,
    # with an atol at 1e-4 of the map's scale for elements near zero
    for got, name in ((c4, "c4"), (c5, "c5"), (rpn_cls, "rpn_cls"),
                      (rpn_bbox, "rpn_bbox")):
        r = ref[name]
        np.testing.assert_allclose(got.numpy(), r, rtol=1e-4,
                                   atol=1e-4 * np.abs(r).max(), err_msg=name)


def test_multi_proposal_on_the_same_rpn_outputs(pair):
    _, tnet, _, _, info, ref = pair
    with torch.inference_mode():
        rois = tnet._proposals(_t(ref["rpn_cls"]), _t(ref["rpn_bbox"]), _t(info))
    # fp32 box decode (exp, products) in another order
    np.testing.assert_allclose(rois.numpy(), ref["rois"], rtol=0, atol=1e-4)


def test_head_on_the_same_c5_and_rois(pair):
    _, tnet, _, _, _, ref = pair
    with torch.inference_mode():
        cls_score, bbox_pred = tnet._head(_t(ref["c5"]), _t(ref["rois"]),
                                          rois_per_image=CFG["rpn_post_nms"])
    prob = torch.softmax(cls_score, -1).numpy()
    ref_prob = _np(nd.softmax(nd.array(ref["cls_score"]), axis=-1))
    assert np.ptp(ref_prob) > 0.05  # the scores discriminate
    # pooled bilinear means, then 1×1 conv sums in another order
    np.testing.assert_allclose(prob, ref_prob, rtol=0, atol=1e-4)
    np.testing.assert_allclose(bbox_pred.numpy(), ref["bbox_pred"], rtol=0, atol=1e-4)


def test_whole_forward_matches(pair):
    jnet, tnet, _, x, info, _ = pair
    ref = [_np(a) for a in jnet(nd.array(x), nd.array(info))]
    got = [a.numpy() for a in tnet(_t(x), _t(info))]
    assert got[0].shape == (2 * 32, 5) and got[1].shape == (2 * 32, 4)
    assert got[2].shape == (2 * 32, 8)
    # every stage's error above, compounded; seed 0 has no proposal near-tie
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-3)


def test_load_jax_params_rejects_mismatches(pair):
    _, _, params, *_ = pair
    net = DeformableRFCN(device="cpu", **CFG)
    missing = dict(params)
    missing.pop("rfcn_trans_bias")
    with pytest.raises(KeyError, match="rfcn_trans_bias"):
        load_jax_params(net, missing)
    with pytest.raises(KeyError, match="extra_weight"):
        load_jax_params(net, dict(params, extra_weight=np.zeros(3, np.float32)))
    bad = dict(params, rpn_cls_bias=np.zeros(7, np.float32))
    with pytest.raises(ValueError, match="rpn_cls_bias"):
        load_jax_params(net, bad)


def test_batch_statistics_net_is_built_in_eval_mode_and_serves_on_running_statistics(pair):
    """``frozen_bn=False`` is built in eval mode, so that it serves on the
    running statistics, as the frozen net does, and leaves them as they
    are: both give the same answer from the same weights."""
    _, _, params, x, info, _ = pair
    live = DeformableRFCN(device="cpu", frozen_bn=False, **CFG)
    assert not any(m.training for m in live.modules())
    rng = np.random.RandomState(5)
    stats = {k: (rng.rand(*v.shape) + 0.5 if k.endswith("_var") else rng.randn(*v.shape) * 0.1)
             .astype(np.float32) for k, v in params.items() if k.endswith(("_mean", "_var"))}
    load_jax_params(live, dict(params, **stats))
    frozen = load_jax_params(DeformableRFCN(device="cpu", **CFG), dict(params, **stats))
    got = live(_t(x), _t(info))
    for g, r in zip(got, frozen(_t(x), _t(info))):
        assert torch.equal(g, r)
    for k, v in live.gluon_named_tensors().items():
        if k in stats:
            np.testing.assert_array_equal(v.numpy(), stats[k])


def _gluon(make):
    """The tensors of a Gluon entry point's block."""
    return lambda **kw: list(make(**kw).state_dict().values())


def _simple_bind(**kw):
    from mxnet_tpu_torch.models import resnet_symbol

    exe = resnet_symbol.get_symbol(10, 8, "3,32,32").simple_bind(
        grad_req="null", data=(1, 3, 32, 32), **kw)
    return exe.arg_arrays + exe.aux_arrays


def _quantize_model(**kw):
    from mxnet_tpu_torch import symbol as tsym
    from mxnet_tpu_torch.contrib.quantization import quantize_model

    data = tsym.Variable("data")
    net = tsym.FullyConnected(tsym.Flatten(data), num_hidden=3, name="fc")
    params = {"fc_weight": np.ones((3, 4), np.float32), "fc_bias": np.zeros(3, np.float32)}
    _, qargs, _ = quantize_model(net, params, {}, calib_mode="none", **kw)
    return list(qargs.values())


@pytest.mark.parametrize("make", [
    _gluon(lambda **kw: rfcn_resnet101(classes=3, image_shape=(64, 96), **kw)),
    _gluon(lambda **kw: DeformableRFCN(**CFG, **kw)),
    _gluon(lambda **kw: tnn.Conv2D(8, 3, in_channels=4, **kw)),
    _gluon(lambda **kw: tnn.BatchNorm(in_channels=4, **kw)),
    _gluon(lambda **kw: DeformableConv2D(8, 4, num_deformable_group=2, **kw)),
    _simple_bind,
    _quantize_model,
    _gluon(lambda **kw: tnn.Dense(4, in_units=3, **kw)),
    _gluon(lambda **kw: resnet18_v1(classes=10, **kw)),
    _gluon(lambda **kw: faster_rcnn_vgg16(classes=3, image_shape=(64, 96), **kw)),
    _gluon(lambda **kw: FasterRCNN(classes=3, image_shape=(64, 96), **TINY_FRCNN, **kw)),
], ids=["rfcn_resnet101", "DeformableRFCN", "Conv2D", "BatchNorm",
        "DeformableConv2D", "simple_bind", "quantize_model", "Dense", "resnet18_v1",
        "faster_rcnn_vgg16", "FasterRCNN"])
def test_entry_point_needs_cuda_unless_cpu_is_asked(monkeypatch, make):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make(device="cuda")
    tensors = make(device="cpu")
    assert tensors and all(t.device.type == "cpu" for t in tensors)


def test_forward_computes_in_full_fp32(pair, monkeypatch):
    """The forward turns TF32 off for its convolutions and matmuls and gives
    the caller's settings back after."""
    _, tnet, _, x, info, _ = pair
    seen = []
    features = tnet._features

    def spy(data):
        seen.append((torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32))
        return features(data)

    monkeypatch.setattr(tnet, "_features", spy)
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        tnet(_t(x), _t(info))
        after = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
    assert seen == [(False, False)]
    assert after == (True, True)


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted(f for f in (ROOT / "mxnet_tpu_torch").rglob("*.py")
                   if "_build" not in f.parts)
    files += [ROOT / "chip_smoke.py", ROOT / "tools" / "profile_torch_rfcn.py"]
    assert len(files) > 10
    port = ROOT / "mxnet_tpu_torch"
    for new in (port / "train_fused.py", port / "ops" / "elemwise.py",
                port / "ops" / "rcnn_targets.py", port / "ops" / "quantization.py",
                port / "ops" / "registry.py", port / "ops" / "reduce.py",
                port / "symbol" / "symbol.py", port / "symbol" / "__init__.py",
                port / "executor.py", port / "io.py",
                port / "contrib" / "quantization.py",
                port / "models" / "resnet_symbol.py",
                port / "gluon" / "functional.py", port / "gluon" / "loss.py",
                port / "gluon" / "model_zoo" / "vision" / "__init__.py",
                port / "gluon" / "model_zoo" / "vision" / "resnet.py",
                port / "train_frcnn.py", port / "gluon" / "model_zoo" / "detection.py",
                port / "gluon" / "nn" / "basic_layers.py", port / "initializer.py",
                port / "lr_scheduler.py", port / "optimizer.py", port / "metric.py",
                port / "ndarray.py", port / "model.py", port / "callback.py",
                port / "module" / "__init__.py", port / "module" / "base_module.py",
                port / "module" / "module.py", port / "train_ssd.py",
                port / "gluon" / "model_zoo" / "ssd.py"):
        assert new in files
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "mxnet_tpu", "examples"), (f, mod)


def test_profile_tool_groups_each_kernel_under_its_own_name():
    """tools/profile_torch_rfcn.py sums device time by group: every kernel
    of an R-FCN kernel source (each design of it) lands in the source's
    group, and no other group claims it."""
    import importlib.util
    import re

    spec = importlib.util.spec_from_file_location(
        "profile_torch_rfcn", ROOT / "tools" / "profile_torch_rfcn.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    csrc = ROOT / "mxnet_tpu_torch" / "ops" / "csrc"
    for group in ("nms_alive", "dconv_col", "dconv_col_bwd", "psroi_abuild",
                  "psroi_abuild_bwd"):
        names = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(",
                           (csrc / (group + ".cu")).read_text())
        assert names, group
        for name in names:  # as the profiler shows a kernel in an anonymous namespace
            assert tool.group_of("(anonymous namespace)::%s(float const*)" % name) == group

"""The port's detection-quality gates (``mxnet_tpu_torch.quality``,
``metric.VOCMApMetric``, the device data streams) against the JAX package's
(``examples/ssd/metric.py``, ``ci/gate_map.py``,
``examples/quality/eval_{ssd,frcnn,rfcn}_map.py``), on the CPU.  No network
is built on the JAX side: the scripts' training loops run with stand-ins
for the net and its step, which record the learning rates.

Tolerances: the metric, the gate and the learning rates exactly; the
decodes' classes, order and scores exactly, boxes within 1e-3 px (the
inputs are tie-free: the JAX cut sorts with numpy's unstable ``argsort``,
the port's sort is stable).
"""
import io
import pathlib
import sys
import types
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

import jax

import mxnet_tpu.gluon.functional as jfunctional
from mxnet_tpu.test_utils import load_module_by_path
from mxnet_tpu_torch import metric as tmetric
from mxnet_tpu_torch import train_fused, train_ssd
from mxnet_tpu_torch.quality import (common, eval_frcnn_map, eval_rfcn_map, eval_ssd_map,
                                     gate_map)

ROOT = pathlib.Path(__file__).resolve().parents[1]
QUALITY = ROOT / "examples" / "quality"


def _load(path, name):
    return load_module_by_path(str(path), name=name)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread keeps this file off
    the cores that the suite's parallel workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_metric():
    return _load(ROOT / "examples" / "ssd" / "metric.py", "_ssd_metric_for_port_tests")


@pytest.fixture(scope="module")
def jax_gate():
    return _load(ROOT / "ci" / "gate_map.py", "_ci_gate_map_for_port_tests")


@pytest.fixture(scope="module")
def jax_scripts():
    return {name: _load(QUALITY / ("eval_%s_map.py" % name), "_eval_%s_map_for_port_tests" % name)
            for name in ("ssd", "frcnn", "rfcn")}


# ---------------------------------------------------------------------------
# (a) VOCMApMetric
# ---------------------------------------------------------------------------


def _random_image(rng, classes=4, n_gt=5, n_det=12, pad=3):
    """One image: -1-padded ground truth and detections, some near a ground
    truth (jittered), some anywhere, some of an absent class."""
    gt = np.full((1, n_gt + pad, 5), -1.0, np.float32)
    det = np.full((1, n_det + pad, 6), -1.0, np.float32)
    k = rng.randint(1, n_gt + 1)
    for j in range(k):
        x1, y1 = rng.uniform(0, 0.6, 2)
        w, h = rng.uniform(0.1, 0.4, 2)
        gt[0, j] = [rng.randint(0, classes), x1, y1, x1 + w, y1 + h]
    for j in range(n_det):
        if rng.rand() < 0.6:
            src = gt[0, rng.randint(0, k)]
            box = src[1:5] + rng.normal(0, 0.04, 4)
            c = src[0] if rng.rand() < 0.8 else rng.randint(0, classes + 1)
        else:
            x1, y1 = rng.uniform(0, 0.6, 2)
            box = np.array([x1, y1, x1 + 0.2, y1 + 0.3])
            c = rng.randint(0, classes + 1)
        det[0, j] = [c, rng.rand(), *box]
    return det, gt


def _case(name):
    """-> [(dets, labels)] updates of one metric case."""
    box = [0.1, 0.1, 0.5, 0.5]
    if name.startswith("random"):
        rng = np.random.RandomState(int(name[6:]))
        return [_random_image(rng) for _ in range(6)]
    if name == "gt_without_dets":  # class 1 has ground truth and no detection: AP 0
        return [(np.array([[[0, 0.9, *box]]], np.float32),
                 np.array([[[0, *box], [1, 0.6, 0.6, 0.9, 0.9]]], np.float32))]
    if name == "dets_of_absent_class":  # class 2 has no ground truth: not counted
        return [(np.array([[[0, 0.9, *box], [2, 0.95, *box]]], np.float32),
                 np.array([[[0, *box]]], np.float32))]
    if name == "padding":  # -1 rows on both sides, an image with none at all
        return [(np.array([[[0, 0.8, *box], [-1, -1, -1, -1, -1, -1]]], np.float32),
                 np.array([[[0, *box], [-1, -1, -1, -1, -1]]], np.float32)),
                (np.full((1, 2, 6), -1, np.float32), np.full((1, 2, 5), -1, np.float32))]
    if name == "duplicate_hits":  # the second hit of a matched ground truth is an FP
        return [(np.array([[[0, 0.9, *box], [0, 0.8, 0.11, 0.1, 0.5, 0.5],
                            [0, 0.7, 0.1, 0.12, 0.5, 0.5]]], np.float32),
                 np.array([[[0, *box], [0, 0.6, 0.6, 0.9, 0.9]]], np.float32))]
    if name == "equal_scores":
        return [(np.array([[[0, 0.5, *box], [0, 0.5, 0.6, 0.6, 0.9, 0.9],
                            [1, 0.5, *box], [0, 0.5, 0.3, 0.3, 0.4, 0.4]]], np.float32),
                 np.array([[[0, 0.6, 0.6, 0.9, 0.9], [1, *box]]], np.float32)),
                (np.array([[[0, 0.5, *box]]], np.float32), np.array([[[0, *box]]], np.float32))]
    raise KeyError(name)


METRIC_CASES = ("random0", "random1", "random2", "gt_without_dets", "dets_of_absent_class",
                "padding", "duplicate_hits", "equal_scores")


@pytest.mark.parametrize("use_voc07", [False, True])
@pytest.mark.parametrize("case", METRIC_CASES)
def test_voc_map_metric_equals_the_jax_class(jax_metric, case, use_voc07):
    ref = jax_metric.VOCMApMetric(iou_thresh=0.5, use_voc07=use_voc07)
    got = tmetric.VOCMApMetric(iou_thresh=0.5, use_voc07=use_voc07)
    for dets, labels in _case(case):
        ref.update(dets, labels)
        # the port's takes CPU tensors as well as numpy arrays
        got.update(torch.from_numpy(dets), labels)
    assert got.get() == ref.get()
    assert got.get()[0] == "mAP"
    if case == "gt_without_dets":
        assert got.get()[1] == pytest.approx(0.5)
    if case == "duplicate_hits" and not use_voc07:
        assert got.get()[1] == pytest.approx(0.5)
    got.reset()
    assert got.get() == ("mAP", 0.0)


# ---------------------------------------------------------------------------
# (b) the gate
# ---------------------------------------------------------------------------

LOGS = {
    "trailing": "step 0 loss 1.0\nFINAL rfcn resnet101 synthetic-VOC mAP = 0.2743  "
                "(steps=3000, classes=3, eval n=500)\n",
    "last_wins": "FINAL ssd300 full synthetic-VOC mAP = 0.5  (steps=2000)\nnoise = 3\n"
                 "  FINAL ssd300 full synthetic-VOC mAP = .75  (steps=2000, eval n=500, "
                 "8732 anchors)\n",
    "integer": "FINAL frcnn vgg16 synthetic-VOC mAP = 1  (steps=3000, classes=3, eval n=500)\n",
    "other_lines": "lr -> 0.0002 at step 1800\nFINALLY = 0.9\nFINAL x = 0.125 (a = 0.5)\n",
}


@pytest.mark.parametrize("log", sorted(LOGS) + ["none"])
def test_gate_extract_map_equals_ci(jax_gate, tmp_path, log):
    path = tmp_path / "run.log"
    path.write_text(LOGS.get(log, "step 0 loss 1.0\nFINAL but no value\n"))
    if log == "none":
        for mod in (jax_gate, gate_map):
            with pytest.raises(SystemExit):
                mod.extract_map(str(path))
        return
    assert gate_map.extract_map(str(path)) == jax_gate.extract_map(str(path))
    outs = []
    for mod in (jax_gate, gate_map):
        buf = io.StringIO()
        with redirect_stdout(buf):
            assert mod.main(["--extract", str(path)]) == 0
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]


@pytest.mark.parametrize("floor,values", [(0.14, [0.09, 0.27]), (0.64, [0.5, 0.6]),
                                          (0.5, [0.5, 0.5]), (0.3, [0.1, 0.4, 0.35])])
def test_gate_median_equals_ci(jax_gate, floor, values):
    argv = ["--floor", str(floor)] + [str(v) for v in values]
    outs = []
    for mod in (jax_gate, gate_map):
        buf = io.StringIO()
        with redirect_stdout(buf):
            rc = mod.main(argv)
        outs.append((rc, buf.getvalue()))
    assert outs[0] == outs[1]


class _FakeRun:
    """A stand-in for ``subprocess.Popen`` of one eval run: prints a FINAL
    line whose mAP is 0.1 + 0.2 × the seed, and a TIMES line."""

    calls = []

    def __init__(self, cmd, **kwargs):
        _FakeRun.calls.append((cmd, kwargs))
        seed = int(cmd[cmd.index("--seed") + 1])
        self.stdout = iter(["step 0 loss 1.0\n",
                            "TIMES device=x steps=9 train_s=4.50 steps_per_s=2.000 eval_s=1.25 "
                            "eval_images=5\n",
                            "FINAL ssd300 full synthetic-VOC mAP = %.4f  (steps=9, eval n=5)\n"
                            % (0.1 + 0.2 * seed)])
        self.returncode = 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_gate_runner_runs_each_seed_and_gates_the_median(tmp_path, monkeypatch):
    """``--run``: one process per seed with the recipe's arguments from the
    repository's root, each log written, the median gated (0.1 and 0.3 ->
    0.2) against the recipe's floor."""
    monkeypatch.setattr(gate_map.subprocess, "Popen", _FakeRun)
    _FakeRun.calls = []
    monkeypatch.setitem(gate_map.FLOORS, "ssd300", 0.2)
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = gate_map.main(["--run", "ssd300", "--device", "cpu", "--log-dir", str(tmp_path)])
    assert rc == 0, buf.getvalue()
    assert [c[0][1:] for c in _FakeRun.calls] == [
        ["-m", "mxnet_tpu_torch.quality.eval_ssd_map", "--full", "--steps", "2000",
         "--seed", str(s), "--device", "cpu"] for s in (0, 1)]
    assert all(pathlib.Path(c[1]["cwd"]) == ROOT for c in _FakeRun.calls)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["ssd300_seed0.log", "ssd300_seed1.log"]
    assert gate_map.extract_map(str(tmp_path / "ssd300_seed1.log")) == 0.3
    out = buf.getvalue()
    assert "ssd300 PASS: gate_map: median(0.1000, 0.3000) = 0.2000 vs floor 0.2000" in out
    assert "(1, 0.3, 4.5, 2.0, 1.25)" in out
    monkeypatch.setitem(gate_map.FLOORS, "ssd300", 0.21)
    with redirect_stdout(io.StringIO()):
        assert gate_map.main(["--run", "ssd300"]) == 1
    with redirect_stdout(io.StringIO()):  # one seed: its own value is the median
        assert gate_map.main(["--run", "ssd300", "--seeds", "1"]) == 0


def test_gate_floors_are_gates():
    """Every recipe has a floor above the broken-target signature (mAP ≤
    0.03) and below 1, and the smoke's single-run floor is below the
    two-seed one."""
    assert sorted(gate_map.FLOORS) == sorted(gate_map.RECIPES)
    assert all(0.03 < f < 1.0 for f in gate_map.FLOORS.values())
    assert 0.03 < gate_map.SINGLE_RUN_FLOORS["ssd300"] < gate_map.FLOORS["ssd300"]


# ---------------------------------------------------------------------------
# (c) the decodes
# ---------------------------------------------------------------------------

IM_SHAPE = (600, 1000)
CLASSES = 3


def _decode_inputs(R, box_cols, seed, none_above=False):
    """Seeded (rois, cls_prob, bbox_pred): distinct foreground scores (a
    shuffled ladder, so no two are equal and the cut is tie-free), all
    below 0.05 with ``none_above``."""
    rng = np.random.RandomState(seed)
    x1 = rng.uniform(0, IM_SHAPE[1] - 200, R)
    y1 = rng.uniform(0, IM_SHAPE[0] - 200, R)
    w, h = rng.uniform(16, 200, R), rng.uniform(16, 200, R)
    rois = np.stack([np.zeros(R), x1, y1, x1 + w, y1 + h], 1).astype(np.float32)
    top = 0.049 if none_above else 0.33
    fg = (rng.permutation(R * CLASSES).reshape(R, CLASSES) + 1) * (top / (R * CLASSES))
    prob = np.concatenate([1 - fg.sum(1, keepdims=True), fg], 1).astype(np.float32)
    assert np.unique(prob[:, 1:]).size == R * CLASSES
    deltas = (rng.normal(0, 0.3, (R, box_cols))).astype(np.float32)
    return rois, prob, deltas


@pytest.mark.parametrize("case", ["r64", "r600_cut", "none_above"])
@pytest.mark.parametrize("model", ["frcnn", "rfcn"])
def test_decode_detections_equals_the_jax_scripts(jax_scripts, model, case):
    R = {"r64": 64, "r600_cut": 600, "none_above": 64}[case]
    box_cols = 4 * (CLASSES + 1) if model == "frcnn" else 8
    rois, prob, deltas = _decode_inputs(R, box_cols, seed=len(case) + R,
                                        none_above=case == "none_above")
    rows = int((prob[:, 1:] >= 0.05).sum())
    assert (rows > common.NMS_CAP) == (case == "r600_cut")
    ref = jax_scripts[model].decode_detections(rois, prob, deltas, CLASSES, IM_SHAPE)
    port = eval_frcnn_map if model == "frcnn" else eval_rfcn_map
    got = port.decode_detections(*(torch.from_numpy(a) for a in (rois, prob, deltas)),
                                 CLASSES, IM_SHAPE)
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got[..., 0], ref[..., 0])
    np.testing.assert_array_equal(got[..., 1], ref[..., 1])
    np.testing.assert_allclose(got[..., 2:], ref[..., 2:], rtol=0, atol=1e-3)
    if case == "none_above":
        np.testing.assert_array_equal(got, np.full((1, 1, 6), -1, np.float32))
    else:
        assert 1 < got.shape[1] <= 100


# ---------------------------------------------------------------------------
# (d) the learning rates
# ---------------------------------------------------------------------------


class _Recorder:
    """A stand-in train step: records each step's learning rate."""

    def __init__(self, state):
        self.lrs, self.state = [], state

    def __call__(self, state, *args):
        self.lrs.append(float(args[-1]))
        return state, np.float32(0.0), None


class _FakeNet:
    """A stand-in for the JAX scripts' nets: no parameters, no forward."""

    max_gts = 8
    box_stds = (0.1, 0.1, 0.2, 0.2)

    def __init__(self, *args, **kwargs):
        pass

    def __call__(self, *args):
        return None

    def initialize(self, *args, **kwargs):
        pass

    def make_anchors(self, size):
        return np.zeros((8732 if size == 300 else 24564, 4), np.float32)


def _jax_learning_rates(script, monkeypatch, argv, recorder, n_data):
    """Run a JAX gate script's ``main`` with its net, step, data and eval
    forward replaced by stand-ins (``n_data`` values from its generator),
    zero eval images: -> (the recorded rates, its "lr ->" lines)."""
    monkeypatch.setattr(jax, "jit", lambda f, **kw: f)
    monkeypatch.setattr(jfunctional, "merge_params", lambda *a: [])
    monkeypatch.setattr(script.mx.random, "seed", lambda *a: None)
    step = lambda *a, **k: (recorder, recorder.state)
    for attr, value in dict(
            _vgg=types.SimpleNamespace(SSD300=None, SSD512=None, VGGSSD=_FakeNet),
            build_net=lambda *a, **k: (_FakeNet(), (64, 96), 3),
            functionalize=lambda *a, **k: (None, [], [], []),
            synthetic_voc=lambda *a, **k: (None,) * n_data,
            synthetic_coco=lambda *a, **k: (None,) * n_data,
            make_ssd_train_step=step, make_frcnn_train_step=step, make_rfcn_train_step=step,
            make_score_step=lambda *a, **k: (None, None),
            _merge_vals=lambda *a: []).items():
        if hasattr(script, attr):
            monkeypatch.setattr(script, attr, value)
    monkeypatch.setattr(sys, "argv", ["eval"] + argv + ["--eval-images", "0"])
    buf = io.StringIO()
    with redirect_stdout(buf):
        script.main()
    return recorder.lrs, [l for l in buf.getvalue().splitlines() if l.startswith("lr ->")]


LR_CASES = [("ssd", [], 50), ("ssd", [], 37), ("frcnn", [], 41), ("frcnn", ["--flat-lr"], 20),
            ("rfcn", [], 33), ("rfcn", ["--flat-lr"], 20)]


@pytest.mark.parametrize("model,flags,steps", LR_CASES)
def test_learning_rates_equal_the_jax_loops(jax_scripts, monkeypatch, model, flags, steps):
    script = jax_scripts[model]
    recorder = _Recorder((None, None) if model == "ssd" else ((), (), ()))
    ref, ref_lines = _jax_learning_rates(script, monkeypatch, flags + ["--steps", str(steps)],
                                         recorder, 2 if model == "ssd" else 3)
    base = {"ssd": 5e-3, "frcnn": 2e-3, "rfcn": 2e-3}[model]
    rates = common.learning_rates(steps, base, warmup=model == "ssd",
                                  flat="--flat-lr" in flags)
    assert [float(np.float32(r)) for r, _ in rates] == ref
    buf = io.StringIO()
    with redirect_stdout(buf):
        common.train_loop(steps, rates, lambda s, lr: torch.zeros(()))
    assert [l for l in buf.getvalue().splitlines() if l.startswith("lr ->")] == ref_lines
    assert len(ref_lines) == (0 if flags else 2)


# ---------------------------------------------------------------------------
# (e) the device data streams, on a CPU generator
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["voc", "coco"])
def test_device_streams_paint_each_rectangle_and_repeat(kind):
    def draw(seed):
        g = torch.Generator().manual_seed(seed)
        if kind == "voc":
            data, gt = train_ssd.synthetic_voc_device(g, 6, 96, 5)
            return data, gt, 96.0, (1, 4), (0.1, 0.5)
        data, im_info, gt = train_fused.synthetic_coco_device(g, 6, (64, 96), 5, 16)
        np.testing.assert_array_equal(im_info.numpy(), [[64, 96, 1.0]] * 6)
        return data, gt, 1.0, (1, 8), (0.08, 0.5)

    data, gt, scale, (lo, hi), (smin, smax) = draw(3)
    again = draw(3)
    assert torch.equal(data, again[0]) and torch.equal(gt, again[1])
    assert not torch.equal(data, draw(4)[0])
    assert data.dtype == gt.dtype == torch.float32
    H, W = data.shape[-2:]
    valid = gt[..., 0] >= 0
    n = valid.sum(1)
    assert bool(((n >= lo) & (n <= hi)).all()) and len(set(n.tolist())) > 1
    # the valid rows are a prefix; padding rows are all -1
    assert bool((valid == (torch.arange(gt.shape[1]) < n[:, None])).all())
    assert bool((gt[~valid] == -1).all())
    g = gt[valid]
    assert bool(((g[:, 0] >= 0) & (g[:, 0] < 5) & (g[:, 0] == g[:, 0].round())).all())
    size = torch.tensor([W, H], dtype=torch.float32) / scale
    rel = (g[:, 3:5] - g[:, 1:3]) / size
    assert bool(((rel >= smin - 1e-6) & (rel <= smax + 1e-6)).all())
    assert bool((g[:, 1:3] >= 0).all()) and bool((g[:, 3:5] <= size + 1e-4).all())
    # noise below 0.2 outside every rectangle; each rectangle +0.8 on cls % 3
    painted = torch.zeros_like(data, dtype=torch.bool)
    for b in range(gt.shape[0]):
        for row in gt[b][valid[b]]:
            c = int(row[0]) % 3
            x1, y1, x2, y2 = (int(v) for v in (row[1:] * scale).tolist())
            patch = data[b, c, y1:y2, x1:x2]
            assert patch.numel() > 0 and bool((patch >= 0.8).all())
            painted[b, c, y1:y2, x1:x2] = True
    assert bool((data[~painted] < 0.2).all()) and bool((data[~painted] >= 0).all())


# ---------------------------------------------------------------------------
# (g) the scripts end to end on the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("script", [eval_ssd_map, eval_frcnn_map, eval_rfcn_map],
                         ids=["ssd", "frcnn", "rfcn"])
def test_eval_script_runs_on_the_cpu_and_prints_a_final_line(script, tmp_path):
    torch.manual_seed(0)
    argv = ["--device", "cpu", "--steps", "2", "--eval-images", "2"]
    argv += {eval_ssd_map: ["--batch", "2"], eval_rfcn_map: ["--live-bn"]}.get(script, [])
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = script.main(argv)
    out = buf.getvalue()
    assert rc == 0, out
    log = tmp_path / "run.log"
    log.write_text(out)
    value = gate_map.extract_map(str(log))
    assert 0.0 <= value <= 1.0
    assert out.count("FINAL ") == 1 and "TIMES device=cpu steps=2" in out
    assert "eval n=2" in out

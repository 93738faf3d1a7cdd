"""What the three gate scripts share: the learning-rate schedule, the
decode's NMS tail, the training loop's clock and the lines they print."""
from __future__ import annotations

import time

import numpy as np
import torch

from ..metric import VOCMApMetric
from ..ops.detection import box_nms
from ..train_fused import synthetic_coco

__all__ = ["EVAL_SEED", "NMS_CAP", "learning_rates", "nms_detections", "train_loop",
           "evaluate_detector", "report", "finish"]

# the held-out stream: numpy.random.RandomState(12345), as the JAX scripts'
# host eval stream, so both packages score the same images
EVAL_SEED = 12345
# the decode's fixed row count before its NMS (the JAX scripts' bucket)
NMS_CAP = 512


def learning_rates(steps, lr, warmup=False, flat=False):
    """-> [(lr of step s, decayed at s)] for s < ``steps``: ×0.1 at
    ``int(0.6·steps)`` and ``int(0.85·steps)`` (none with ``flat``); with
    ``warmup`` each step's rate is also scaled by min(1, (s + 1) / max(1,
    steps // 10)), the SSD gate's linear warm-up (the JAX loops of
    ``examples/quality/eval_*_map.py``)."""
    decay = set() if flat else {int(steps * 0.6), int(steps * 0.85)}
    ramp = max(1, steps // 10)
    out = []
    for s in range(steps):
        if s in decay:
            lr *= 0.1
        out.append((lr * min(1.0, (s + 1) / ramp) if warmup else lr, s in decay))
    return out


def nms_detections(rows, nms_thresh=0.3, max_det=100):
    """The decode's tail on the device: ``rows`` (N, 6) ``[cls, score, x1,
    y1, x2, y2]`` in class-major order are padded with −1 rows to NMS_CAP
    (or cut to the NMS_CAP best by score, stably, when N >= NMS_CAP), go
    through per-class ``box_nms`` at ``nms_thresh`` (one ``nms_alive``
    launch, B 1, N NMS_CAP), and the first ``max_det`` survivors by score
    are copied to the host.  -> numpy (1, K, 6), or one −1 row when nothing is left (the
    JAX scripts' ``decode_detections`` tail)."""
    none = np.full((1, 1, 6), -1, np.float32)
    n = rows.shape[0]
    if n == 0:
        return none
    if n < NMS_CAP:
        rows = torch.cat([rows, rows.new_full((NMS_CAP - n, 6), -1.0)])
    else:
        rows = rows[torch.argsort(-rows[:, 1], stable=True)[:NMS_CAP]]
    out = box_nms(rows[None], overlap_thresh=nms_thresh, coord_start=2, score_index=1,
                  id_index=0, force_suppress=False)[0]
    out = out[out[:, 0] >= 0][:max_det].cpu().numpy()
    return out[None] if out.size else none


def train_loop(steps, rates, one_step):
    """Run ``one_step(s, lr) -> loss`` (a 0-d tensor) for each of ``rates``
    (:func:`learning_rates`), printing each decay and the loss at every
    eighth of the run; the last loss is read too, which waits for the
    device.  -> seconds of the loop."""
    t0 = time.perf_counter()
    loss = None
    for s, (lr, decayed) in enumerate(rates):
        if decayed:
            print("lr -> %g at step %d" % (lr, s), flush=True)
        loss = one_step(s, lr)
        if s % max(1, steps // 8) == 0:
            print("step %4d  loss %.4f  (%.1f s)" % (s, float(loss), time.perf_counter() - t0),
                  flush=True)
    if loss is not None:
        print("last step %4d  loss %.4f" % (steps - 1, float(loss)), flush=True)
    return time.perf_counter() - t0


def evaluate_detector(net, decode, images, device):
    """Score ``net`` (Faster R-CNN or R-FCN, eval mode) on the first
    ``images`` images of the held-out host stream (``net.classes``
    classes): the inference forward,
    ``decode(rois, cls_prob, bbox_pred) -> (1, K, 6)`` numpy detections,
    and ``VOCMApMetric`` at IoU 0.5.  -> (mAP, [detections of each image])."""
    metric = VOCMApMetric(iou_thresh=0.5)
    rng = np.random.RandomState(EVAL_SEED)
    dets = []
    for _ in range(images):
        data, im_info, gt = synthetic_coco(rng, 1, net.image_shape, net.classes, net.max_gts)
        out = net(torch.from_numpy(data).to(device), torch.from_numpy(im_info).to(device))
        dets.append(decode(*out))
        metric.update(dets[-1], gt[:, :, :5])
    return metric.get()[1], dets


def report(device, steps, train_s, eval_s, images):
    """Print the run's times on one ``TIMES`` line (``gate_map`` reads it)."""
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print("TIMES device=%s steps=%d train_s=%.2f steps_per_s=%.3f eval_s=%.2f "
          "eval_images=%d" % (name.replace(" ", "_"), steps, train_s,
                              steps / train_s if train_s > 0 else 0.0, eval_s, images),
          flush=True)


def finish(result, floor):
    """A script's exit code: 1 (and a FAIL line) when ``result["map"]`` is
    below ``floor``, else 0."""
    if floor is not None and result["map"] < floor:
        print("FAIL: mAP %.4f below floor %.4f" % (result["map"], floor))
        return 1
    return 0

"""Evaluation metrics (counterpart of ``mxnet_tpu/metric.py``; reference
python/mxnet/metric.py): ``EvalMetric``, ``Accuracy``, ``TopKAccuracy``,
``F1``, ``MCC``, ``MAE``, ``MSE``, ``RMSE``, ``CrossEntropy``,
``NegativeLogLikelihood``, ``PearsonCorrelation``, ``Perplexity``,
``Loss``, ``CustomMetric`` (and ``np``), ``CompositeEvalMetric`` and
``create``, under the JAX package's registered names, and the detection
gates' ``VOCMApMetric`` (``examples/ssd/metric.py``).  An update reads its
labels and predictions to the host (a synchronisation) and sums in numpy,
as the JAX package's metrics do.
"""
from __future__ import annotations

import math

import numpy

import torch

__all__ = ["EvalMetric", "CompositeEvalMetric", "Accuracy", "TopKAccuracy", "F1", "MCC",
           "MAE", "MSE", "RMSE", "CrossEntropy", "NegativeLogLikelihood",
           "PearsonCorrelation", "Perplexity", "Loss", "CustomMetric", "np",
           "VOCMApMetric", "create", "register"]

_METRIC_REGISTRY = {}


def register(klass, *names):
    for n in names or (klass.__name__.lower(),):
        _METRIC_REGISTRY[n] = klass
    return klass


def create(metric, *args, **kwargs):
    """A metric by name (``"acc"``, ``"top_k_accuracy"``, ``"ce"``, ...), a
    metric itself, a function ``feval(label, pred)`` (a ``CustomMetric``),
    or a list of them as a ``CompositeEvalMetric``."""
    if callable(metric):
        return CustomMetric(metric, *args, **kwargs)
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, (list, tuple)):
        composite = CompositeEvalMetric()
        for m in metric:
            composite.add(create(m, *args, **kwargs))
        return composite
    if metric.lower() not in _METRIC_REGISTRY:
        raise ValueError("Metric %s not registered (have %s)"
                         % (metric, sorted(_METRIC_REGISTRY)))
    return _METRIC_REGISTRY[metric.lower()](*args, **kwargs)


def _as_np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.dtype == torch.bfloat16 else x).cpu().numpy()
    return numpy.asarray(x)


def _as_list(x):
    return x if isinstance(x, (list, tuple)) else [x]


class EvalMetric:
    """Base metric (reference metric.py:68): a sum over instances and their
    count."""

    def __init__(self, name):
        self.name = str(name)
        self.reset()

    def __str__(self):
        return "EvalMetric: {}".format(dict(self.get_name_value()))

    def update(self, labels, preds):
        raise NotImplementedError

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, self.sum_metric / self.num_inst)

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name, value = [name], [value]
        return list(zip(name, value))


class CompositeEvalMetric(EvalMetric):
    """Several metrics updated together."""

    def __init__(self, metrics=None, name="composite"):
        super().__init__(name)
        self.metrics = [create(m) for m in (metrics or [])]

    def add(self, metric):
        self.metrics.append(create(metric))

    def get_metric(self, index):
        return self.metrics[index]

    def update(self, labels, preds):
        for metric in self.metrics:
            metric.update(labels, preds)

    def reset(self):
        for metric in getattr(self, "metrics", []):
            metric.reset()

    def get(self):
        names, values = [], []
        for metric in self.metrics:
            name, value = metric.get()
            names.extend(name if isinstance(name, list) else [name])
            values.extend(value if isinstance(value, list) else [value])
        return (names, values)


class Accuracy(EvalMetric):
    """Classification accuracy: the argmax over ``axis`` of each prediction
    against its label."""

    def __init__(self, axis=1, name="accuracy"):
        super().__init__(name)
        self.axis = axis

    def update(self, labels, preds):
        labels, preds = _as_list(labels), _as_list(preds)
        if len(labels) != len(preds):
            raise ValueError("%d labels for %d predictions" % (len(labels), len(preds)))
        for label, pred in zip(labels, preds):
            label, pred = _as_np(label), _as_np(pred)
            if pred.ndim > label.ndim:
                pred = numpy.argmax(pred, axis=self.axis)
            pred = pred.astype(numpy.int32).flatten()
            label = label.astype(numpy.int32).flatten()
            if len(label) != len(pred):
                raise ValueError("%d labels for %d predictions" % (len(label), len(pred)))
            self.sum_metric += (pred == label).sum()
            self.num_inst += len(pred)


class TopKAccuracy(EvalMetric):
    """Whether the label is among the ``top_k`` largest predictions."""

    def __init__(self, top_k=1, name="top_k_accuracy"):
        super().__init__(name)
        if top_k <= 1:
            raise ValueError("Use Accuracy for top_k=1")
        self.top_k = top_k
        self.name += "_%d" % top_k

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            label = _as_np(label).astype(numpy.int32)
            pred = _as_np(pred)
            if pred.ndim != 2:
                raise ValueError("TopKAccuracy takes (batch, classes) predictions")
            topk_idx = numpy.argsort(pred, axis=1)[:, -self.top_k:]
            self.sum_metric += (topk_idx == label.reshape(-1, 1)).any(axis=1).sum()
            self.num_inst += label.shape[0]


class CrossEntropy(EvalMetric):
    """−log of the predicted probability of the true class (+ ``eps``)."""

    def __init__(self, eps=1e-12, name="cross-entropy"):
        super().__init__(name)
        self.eps = eps

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            label = _as_np(label).ravel().astype(numpy.int32)
            pred = _as_np(pred)
            if label.shape[0] != pred.shape[0]:
                raise ValueError("%d labels for %d predictions" % (label.shape[0], pred.shape[0]))
            prob = pred[numpy.arange(label.shape[0]), label]
            self.sum_metric += (-numpy.log(prob + self.eps)).sum()
            self.num_inst += label.shape[0]


def _class_counts(label, pred):
    """Binary labels and predictions (argmax over axis 1 of scores) as int
    vectors."""
    label = _as_np(label).flatten().astype(numpy.int32)
    pred = _as_np(pred)
    if pred.ndim > 1:
        pred = numpy.argmax(pred, axis=1)
    return label, pred.flatten().astype(numpy.int32)


class F1(EvalMetric):
    """Binary F1 of the counts so far (reference metric.py F1)."""

    def __init__(self, name="f1", output_names=None, label_names=None, average="macro"):
        super().__init__(name)
        self.average = average

    def reset(self):
        super().reset()
        self._tp = self._fp = self._fn = 0.0

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            label, pred = _class_counts(label, pred)
            self._tp += ((pred == 1) & (label == 1)).sum()
            self._fp += ((pred == 1) & (label == 0)).sum()
            self._fn += ((pred == 0) & (label == 1)).sum()
            prec = self._tp / max(self._tp + self._fp, 1e-12)
            rec = self._tp / max(self._tp + self._fn, 1e-12)
            self.sum_metric = 2 * prec * rec / max(prec + rec, 1e-12)
            self.num_inst = 1


class MCC(EvalMetric):
    """Matthews correlation coefficient of the counts so far (reference
    metric.py MCC)."""

    def __init__(self, name="mcc", output_names=None, label_names=None):
        super().__init__(name)

    def reset(self):
        super().reset()
        self._tp = self._fp = self._fn = self._tn = 0.0

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            label, pred = _class_counts(label, pred)
            self._tp += ((pred == 1) & (label == 1)).sum()
            self._fp += ((pred == 1) & (label == 0)).sum()
            self._fn += ((pred == 0) & (label == 1)).sum()
            self._tn += ((pred == 0) & (label == 0)).sum()
            denom = math.sqrt((self._tp + self._fp) * (self._tp + self._fn)
                              * (self._tn + self._fp) * (self._tn + self._fn))
            self.sum_metric = (self._tp * self._tn - self._fp * self._fn) / max(denom, 1e-12)
            self.num_inst = 1


class _RegressionMetric(EvalMetric):
    """The mean over updates of a per-batch error (1-D inputs as columns)."""

    def __init__(self, name, output_names=None, label_names=None):
        super().__init__(name)

    def _err(self, label, pred):
        raise NotImplementedError

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            label, pred = _as_np(label), _as_np(pred)
            if label.ndim == 1:
                label = label.reshape(label.shape[0], 1)
            if pred.ndim == 1:
                pred = pred.reshape(pred.shape[0], 1)
            self.sum_metric += self._err(label, pred)
            self.num_inst += 1


class MAE(_RegressionMetric):
    def __init__(self, name="mae", output_names=None, label_names=None):
        super().__init__(name)

    def _err(self, label, pred):
        return numpy.abs(label - pred).mean()


class MSE(_RegressionMetric):
    def __init__(self, name="mse", output_names=None, label_names=None):
        super().__init__(name)

    def _err(self, label, pred):
        return ((label - pred) ** 2).mean()


class RMSE(_RegressionMetric):
    def __init__(self, name="rmse", output_names=None, label_names=None):
        super().__init__(name)

    def _err(self, label, pred):
        return numpy.sqrt(((label - pred) ** 2).mean())


class NegativeLogLikelihood(CrossEntropy):
    """``CrossEntropy`` named ``nll-loss``."""

    def __init__(self, eps=1e-12, name="nll-loss", output_names=None, label_names=None):
        super().__init__(eps=eps, name=name)


class PearsonCorrelation(EvalMetric):
    """The mean over updates of the Pearson correlation of predictions and
    labels."""

    def __init__(self, name="pearsonr", output_names=None, label_names=None):
        super().__init__(name)

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            self.sum_metric += numpy.corrcoef(_as_np(pred).ravel(), _as_np(label).ravel())[0, 1]
            self.num_inst += 1


class Loss(EvalMetric):
    """The mean of a loss output's elements."""

    def __init__(self, name="loss", output_names=None, label_names=None):
        super().__init__(name)

    def update(self, _, preds):
        for pred in _as_list(preds):
            loss = _as_np(pred)
            self.sum_metric += loss.sum()
            self.num_inst += loss.size


class CustomMetric(EvalMetric):
    """A metric of ``feval(label, pred)`` on numpy arrays, which returns a
    value or (sum, count) (reference metric.py CustomMetric)."""

    def __init__(self, feval, name=None, allow_extra_outputs=False, output_names=None,
                 label_names=None):
        if name is None:
            name = feval.__name__ if feval.__name__ != "<lambda>" else "custom"
        super().__init__("custom(%s)" % name if "(" not in name else name)
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs

    def update(self, labels, preds):
        labels, preds = _as_list(labels), _as_list(preds)
        if not self._allow_extra_outputs and len(labels) != len(preds):
            raise ValueError("Shape of labels %d does not match shape of predictions %d"
                             % (len(labels), len(preds)))
        for label, pred in zip(labels, preds):
            reval = self._feval(_as_np(label), _as_np(pred))
            if isinstance(reval, tuple):
                self.sum_metric += reval[0]
                self.num_inst += reval[1]
            else:
                self.sum_metric += reval
                self.num_inst += 1


def np(numpy_feval, name=None, allow_extra_outputs=False):
    """A ``CustomMetric`` of a numpy function (reference metric.py np)."""

    def feval(label, pred):
        return numpy_feval(label, pred)

    feval.__name__ = numpy_feval.__name__
    return CustomMetric(feval, name, allow_extra_outputs)


class Perplexity(EvalMetric):
    """exp(mean negative log-likelihood) of the labels (reference metric.py
    Perplexity); labels equal to ``ignore_label`` count neither in the sum
    nor in the number of instances."""

    def __init__(self, ignore_label=None, axis=-1, name="perplexity", output_names=None,
                 label_names=None):
        super().__init__(name)
        self.ignore_label = ignore_label
        self.axis = axis

    def update(self, labels, preds):
        loss = 0.0
        num = 0
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            label = _as_np(label).astype(numpy.int32).flatten()
            rows = numpy.arange(label.shape[0])
            if isinstance(pred, torch.Tensor):
                # pick on the device: only the labels' probabilities cross
                pred = pred.detach().reshape(-1, pred.shape[-1])
                probs = _as_np(pred[torch.as_tensor(rows, device=pred.device),
                                    torch.as_tensor(label, device=pred.device).long()])
            else:
                pred = numpy.asarray(pred)
                probs = pred.reshape(-1, pred.shape[-1])[rows, label]
            if self.ignore_label is not None:
                ignore = (label == self.ignore_label).astype(probs.dtype)
                probs = probs * (1 - ignore) + ignore
                num -= int(ignore.sum())
            loss -= numpy.sum(numpy.log(numpy.maximum(1e-10, probs)))
            num += label.shape[0]
        self.sum_metric += loss
        self.num_inst += num

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, math.exp(self.sum_metric / self.num_inst))


class VOCMApMetric:
    """Mean average precision of detections over the classes that have
    ground truth (``examples/ssd/metric.py VOCMApMetric``; reference
    ``example/ssd/evaluate/eval_metric.py`` MApMetric / VOC07MApMetric).

    ``update(dets, labels)``: detections (B, A, 6) ``[cls, score, x1, y1,
    x2, y2]`` (cls −1: no detection) and ground truth (B, N, 5+) ``[cls,
    x1, y1, x2, y2]`` (cls −1: padding), numpy arrays or CPU tensors: the
    caller copies the detections to the host once per image.  Per image the
    detections are taken by falling score; one is a true positive when its
    best IoU among the ground truths of its class reaches ``iou_thresh``
    and that ground truth is not matched yet (a second detection of a
    matched ground truth is a false positive).  ``get() -> ("mAP",
    value)``: a class with ground truth and no detection scores AP 0;
    ``use_voc07`` takes the 11-point AP, else the area under the
    monotone precision envelope.  Host numpy, the IoU in the inputs' dtype
    and the AP in float64, as the JAX class computes them.
    """

    def __init__(self, iou_thresh=0.5, class_names=None, use_voc07=False):
        self.iou_thresh = iou_thresh
        self.class_names = class_names
        self.use_voc07 = use_voc07
        self.reset()

    def reset(self):
        self._records = {}  # class -> [(score, tp)]
        self._gt_counts = {}

    @staticmethod
    def _iou(box, boxes):
        ix1 = numpy.maximum(box[0], boxes[:, 0])
        iy1 = numpy.maximum(box[1], boxes[:, 1])
        ix2 = numpy.minimum(box[2], boxes[:, 2])
        iy2 = numpy.minimum(box[3], boxes[:, 3])
        inter = numpy.maximum(ix2 - ix1, 0) * numpy.maximum(iy2 - iy1, 0)
        union = ((box[2] - box[0]) * (box[3] - box[1])
                 + (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1]) - inter)
        return inter / numpy.maximum(union, 1e-12)

    def update(self, dets, labels):
        dets, labels = _as_np(dets), _as_np(labels)
        for b in range(dets.shape[0]):
            gt = labels[b]
            gt = gt[gt[:, 0] >= 0]
            for c in numpy.unique(gt[:, 0]).astype(int):
                self._gt_counts[c] = self._gt_counts.get(c, 0) + int((gt[:, 0] == c).sum())
            det = dets[b]
            det = det[det[:, 0] >= 0]
            det = det[numpy.argsort(-det[:, 1])]
            matched = numpy.zeros(gt.shape[0], dtype=bool)
            for row in det:
                c = int(row[0])
                idx = numpy.where(gt[:, 0] == c)[0]
                tp = 0
                if idx.size:
                    ious = self._iou(row[2:6], gt[idx, 1:5])
                    best = numpy.argmax(ious)
                    if ious[best] >= self.iou_thresh and not matched[idx[best]]:
                        matched[idx[best]] = True
                        tp = 1
                self._records.setdefault(c, []).append((float(row[1]), tp))

    def _average_precision(self, rec, prec):
        if self.use_voc07:
            ap = 0.0
            for t in numpy.arange(0.0, 1.1, 0.1):
                ap += (prec[rec >= t].max() if (rec >= t).any() else 0.0) / 11.0
            return ap
        mrec = numpy.concatenate([[0.0], rec, [1.0]])
        mpre = numpy.concatenate([[0.0], prec, [0.0]])
        for i in range(mpre.size - 1, 0, -1):
            mpre[i - 1] = max(mpre[i - 1], mpre[i])
        idx = numpy.where(mrec[1:] != mrec[:-1])[0]
        return float(((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]).sum())

    def get(self):
        aps = []
        for c in sorted(set(self._records) | set(self._gt_counts)):
            npos = self._gt_counts.get(c, 0)
            if npos == 0:  # detections of a class without ground truth
                continue
            recs = sorted(self._records.get(c, []), key=lambda x: -x[0])
            if not recs:
                aps.append(0.0)
                continue
            tps = numpy.array([tp for _, tp in recs], dtype=numpy.float64)
            tp_cum = numpy.cumsum(tps)
            fp_cum = numpy.cumsum(1.0 - tps)
            aps.append(self._average_precision(
                tp_cum / npos, tp_cum / numpy.maximum(tp_cum + fp_cum, 1e-12)))
        return "mAP", float(numpy.mean(aps)) if aps else 0.0


register(TopKAccuracy)
register(CrossEntropy)
register(CustomMetric)
register(NegativeLogLikelihood, "nll_loss")
register(Accuracy, "acc", "accuracy")
register(TopKAccuracy, "top_k_accuracy", "top_k_acc")
register(MSE, "mse")
register(RMSE, "rmse")
register(MAE, "mae")
register(CrossEntropy, "ce", "cross-entropy")
register(F1, "f1")
register(MCC, "mcc")
register(Loss, "loss")
register(Perplexity, "perplexity")
register(PearsonCorrelation, "pearsonr")
register(CompositeEvalMetric, "composite")

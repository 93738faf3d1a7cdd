"""Evaluation metrics (counterpart of ``mxnet_tpu/metric.py``; reference
python/mxnet/metric.py): ``EvalMetric``, ``Accuracy``, ``TopKAccuracy``,
``CrossEntropy``, ``CompositeEvalMetric`` and ``create``, what
``Module.fit`` and ``Module.score`` use.  An update reads its labels and
predictions to the host (a synchronisation) and sums in numpy, as the JAX
package's metrics do.  The other metrics are ROADMAP A11.
"""
from __future__ import annotations

import numpy

import torch

__all__ = ["EvalMetric", "CompositeEvalMetric", "Accuracy", "TopKAccuracy",
           "CrossEntropy", "create", "register"]

_METRIC_REGISTRY = {}


def register(klass, *names):
    for n in names or (klass.__name__.lower(),):
        _METRIC_REGISTRY[n] = klass
    return klass


def create(metric, *args, **kwargs):
    """A metric by name (``"acc"``, ``"top_k_accuracy"``, ``"ce"``, ...), a
    metric itself, or a list of them as a ``CompositeEvalMetric``."""
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, (list, tuple)):
        composite = CompositeEvalMetric()
        for m in metric:
            composite.add(create(m, *args, **kwargs))
        return composite
    if metric.lower() not in _METRIC_REGISTRY:
        raise NotImplementedError("metric %r is not ported (ROADMAP A11); ported: %s"
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


register(Accuracy, "acc", "accuracy")
register(TopKAccuracy, "top_k_accuracy", "top_k_acc")
register(CrossEntropy, "ce", "cross-entropy")
register(CompositeEvalMetric, "composite")

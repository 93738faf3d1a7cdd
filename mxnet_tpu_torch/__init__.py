"""mxnet_tpu_torch — the PyTorch and CUDA port of ``mxnet_tpu``.

The JAX package ``mxnet_tpu`` is the reference; this package mirrors its
module layout (``ops/nn.py``, ``ops/detection.py``, ``gluon/nn``,
``gluon/model_zoo/detection.py``) and runs on an NVIDIA GPU, with the TPU
kernels of its path rewritten as CUDA kernels (``ops/csrc``).  It imports
neither JAX nor ``mxnet_tpu``.

Ported so far: Deformable R-FCN serving and training
(``gluon.model_zoo.detection.rfcn_resnet101``, ``train_fused``), int8
post-training quantization (``contrib.quantization``), the Gluon ResNet
train step (``gluon.model_zoo.vision``, ``gluon.functional.make_train_step``),
Faster R-CNN VGG16 (``gluon.model_zoo.detection.faster_rcnn_vgg16``,
``train_frcnn``), SSD (``gluon.model_zoo.ssd``, ``train_ssd``), the symbolic
frontend and its training path (``symbol``, ``executor``, ``module``),
deployment: ``predictor.Predictor`` over the graph passes
(``graph_passes``), the graph analyzers (``analysis``) and the bf16 and int8
precision tiers (``graph_passes.precision``), serving (``serving``), the
detection-quality gates (``quality``, ``metric.VOCMApMetric``), and the
imperative frontend: ``nd`` (NDArray and the registry's operators),
``autograd``, ``random``, ``Context`` (``cpu()``, ``gpu()``) and Gluon's
``Parameter`` / ``Trainer``, used as ``import mxnet_tpu_torch as mx``; and
the LSTM bucketing language model: the fused ``RNN`` op, ``rnn`` (the
cells, ``BucketSentenceIter``), ``mod.BucketingModule``, Adam and
``metric.Perplexity``; the whole operator registry with ``operator``
(custom ops), ``mod.SequentialModule`` / ``PythonModule``, the other
optimizers, metrics, initializers and schedules, the one-process
``kvstore``, and ``examples.image_classification`` (``train_imagenet``,
``train_mnist``).
"""
import importlib

from .context import (Context, cpu, current_context, full_fp32, gpu, num_gpus,
                      resolve_device)

__all__ = ["Context", "cpu", "current_context", "full_fp32", "gpu", "num_gpus",
           "resolve_device", "nd", "ndarray", "autograd", "random", "gluon", "init",
           "initializer", "optimizer", "symbol", "sym", "name", "attribute", "metric",
           "lr_scheduler", "module", "mod", "rnn", "io", "callback", "model", "kvstore",
           "operator"]

# submodules imported on first use: ``mx.nd``, ``mx.gluon``, ``mx.init``, ...
_LAZY = {"nd": "ndarray", "sym": "symbol", "init": "initializer", "mod": "module"}


def __getattr__(name):
    target = _LAZY.get(name, name)
    if name in __all__ and not name.startswith("_"):
        mod = importlib.import_module("." + target, __name__)
        globals()[name] = mod
        return mod
    raise AttributeError("module %r has no attribute %r" % (__name__, name))

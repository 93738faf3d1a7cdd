"""mxnet_tpu_torch — the PyTorch and CUDA port of ``mxnet_tpu``.

The JAX package ``mxnet_tpu`` is the reference; this package mirrors its
module layout (``ops/nn.py``, ``ops/detection.py``, ``gluon/nn``,
``gluon/model_zoo/detection.py``) and runs on an NVIDIA GPU, with the TPU
kernels of its path rewritten as CUDA kernels (``ops/csrc``).  It imports
neither JAX nor ``mxnet_tpu``.

Ported so far: Deformable R-FCN serving and training
(``gluon.model_zoo.detection.rfcn_resnet101``, ``train_fused``), int8
post-training quantization (``contrib.quantization``), and the Gluon ResNet
train step (``gluon.model_zoo.vision``, ``gluon.functional.make_train_step``).
"""
from .context import full_fp32, resolve_device

__all__ = ["full_fp32", "resolve_device"]

"""Symbolic training modules (counterpart of ``mxnet_tpu/module``):
``BaseModule``, ``Module`` and ``BucketingModule``.  ``SequentialModule``
and ``PythonModule`` are ROADMAP A8.3, ``elastic`` A10."""
from .base_module import BaseModule
from .bucketing_module import BucketingModule
from .module import Module

__all__ = ["BaseModule", "BucketingModule", "Module"]

"""Symbolic training modules (counterpart of ``mxnet_tpu/module``):
``BaseModule``, ``Module``, ``BucketingModule``, ``SequentialModule``,
``PythonModule`` and ``PythonLossModule``.  ``elastic`` is ROADMAP A10."""
from .base_module import BaseModule
from .bucketing_module import BucketingModule
from .module import Module
from .python_module import PythonLossModule, PythonModule
from .sequential_module import SequentialModule

__all__ = ["BaseModule", "BucketingModule", "Module", "PythonLossModule", "PythonModule",
           "SequentialModule"]

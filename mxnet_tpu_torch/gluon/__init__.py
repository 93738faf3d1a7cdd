"""Gluon-style blocks of the port (counterpart of ``mxnet_tpu/gluon``)."""
from . import functional, loss, nn
from .block import HybridBlock, HybridSequential

__all__ = ["HybridBlock", "HybridSequential", "functional", "loss", "nn"]

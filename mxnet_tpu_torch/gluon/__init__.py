"""Gluon of the port (counterpart of ``mxnet_tpu/gluon``): blocks, layers,
Parameters, the Trainer, losses and the functional train step."""
from . import functional, loss, nn
from .block import Block, HybridBlock, HybridSequential
from .parameter import Constant, DeferredInitializationError, Parameter, ParameterDict
from .trainer import Trainer

__all__ = ["Block", "Constant", "DeferredInitializationError", "HybridBlock",
           "HybridSequential", "Parameter", "ParameterDict", "Trainer", "functional", "loss",
           "nn"]

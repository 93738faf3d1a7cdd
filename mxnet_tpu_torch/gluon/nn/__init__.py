"""Gluon layers of the port (counterpart of ``mxnet_tpu/gluon/nn``)."""
from .activations import Activation
from .basic_layers import BatchNorm, Dense, Dropout, Flatten, HybridSequential
from .conv_layers import Conv2D, GlobalAvgPool2D, MaxPool2D

__all__ = ["Activation", "BatchNorm", "Conv2D", "Dense", "Dropout", "Flatten",
           "GlobalAvgPool2D", "HybridSequential", "MaxPool2D"]

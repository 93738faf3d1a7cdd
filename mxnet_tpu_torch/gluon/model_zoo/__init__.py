"""Model zoo of the port (counterpart of ``mxnet_tpu/gluon/model_zoo``)."""
from . import vision
from .convert import load_jax_params
from .detection import (DeformableConv2D, DeformableRFCN, FasterRCNN,
                        faster_rcnn_vgg16, rfcn_resnet101)
from .ssd import SSD300, SSD512, VGGSSD

__all__ = ["DeformableConv2D", "DeformableRFCN", "FasterRCNN", "SSD300", "SSD512",
           "VGGSSD", "faster_rcnn_vgg16", "load_jax_params", "rfcn_resnet101", "vision"]

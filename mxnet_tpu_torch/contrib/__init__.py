"""Contrib modules of the port (counterpart of ``mxnet_tpu/contrib``)."""

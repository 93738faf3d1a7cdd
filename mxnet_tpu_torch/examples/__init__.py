"""The JAX package's examples that the port runs, each a copy of its
counterpart under ``examples/`` written against ``mxnet_tpu_torch``."""

"""``examples/deformable_rfcn``'s imperative (non-fused) training loop:
``python -m mxnet_tpu_torch.examples.deformable_rfcn.train [--bench]``."""

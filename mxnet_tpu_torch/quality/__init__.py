"""Detection-quality gates (counterpart of ``examples/quality/eval_{ssd,
frcnn,rfcn}_map.py`` and ``ci/gate_map.py``).

Each ``eval_*_map`` script trains one detector from seeded random weights
on a seeded synthetic VOC-format stream (bright rectangles on noise, drawn
on the device), then scores it with ``metric.VOCMApMetric`` over 500
held-out images of the host stream ``numpy.random.RandomState(12345)``, the
JAX scripts' host eval stream, and prints a ``FINAL ... = <mAP>`` line.
``gate_map`` runs a recipe at two fixed seeds and gates the median of
their mAPs against the port's floor:

    python -m mxnet_tpu_torch.quality.gate_map --run ssd300|ssd512|frcnn|rfcn|all
    python -m mxnet_tpu_torch.quality.eval_ssd_map --device cpu --steps 4 --eval-images 2
"""

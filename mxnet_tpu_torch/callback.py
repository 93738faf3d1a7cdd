"""Training callbacks (counterpart of ``mxnet_tpu/callback.py``; reference
python/mxnet/callback.py): ``Speedometer`` (batch end) and
``do_checkpoint`` (epoch end)."""
from __future__ import annotations

import logging
import time

__all__ = ["Speedometer", "do_checkpoint"]


def do_checkpoint(prefix, period=1):
    """An epoch-end callback writing a checkpoint every ``period`` epochs
    (reference callback.py:55)."""
    from .model import save_checkpoint

    every = max(int(period), 1)

    def _callback(iter_no, sym, arg, aux):
        epoch = iter_no + 1
        if epoch % every == 0:
            save_checkpoint(prefix, epoch, sym, arg, aux)

    return _callback


class Speedometer:
    """Log samples/s and the training metric every ``frequent`` batches,
    resetting the metric after each log with ``auto_reset`` (reference
    callback.py:120).  The window restarts when the batch count rewinds (a
    new epoch).  The metric's read synchronises the host with the device,
    so the rate covers the device's work."""

    def __init__(self, batch_size, frequent=50, auto_reset=True):
        self.batch_size = batch_size
        self.frequent = frequent
        self.auto_reset = auto_reset
        self._mark = None
        self._prev_count = -1

    def __call__(self, param):
        count = param.nbatch
        rewound = count < self._prev_count
        self._prev_count = count
        if self._mark is None or rewound:
            self._mark = time.time()
            return
        if count % self.frequent:
            return
        rate = self.frequent * self.batch_size / (time.time() - self._mark)
        line = "Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec" % (param.epoch, count, rate)
        if param.eval_metric is not None:
            pairs = param.eval_metric.get_name_value()
            if self.auto_reset:
                param.eval_metric.reset()
            line = "\t".join([line] + ["%s=%f" % (n, v) for n, v in pairs])
        logging.info(line)
        self._mark = time.time()

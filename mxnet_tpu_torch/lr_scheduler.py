"""Learning-rate schedules (counterpart of ``mxnet_tpu/lr_scheduler.py``;
reference python/mxnet/lr_scheduler.py): ``FactorScheduler`` and
``MultiFactorScheduler``, which ``common/fit.py``'s ``lr_step_epochs`` builds.
A schedule maps the optimizer's update count to a learning rate on the
host."""
from __future__ import annotations

__all__ = ["LRScheduler", "FactorScheduler", "MultiFactorScheduler"]


class LRScheduler:
    """Base: ``base_lr`` (the optimizer sets it to its learning rate) and a
    linear warm-up over ``warmup_steps`` updates from ``warmup_begin_lr``."""

    def __init__(self, base_lr=0.01, warmup_steps=0, warmup_begin_lr=0.0,
                 warmup_mode="linear"):
        self.base_lr = base_lr
        self.warmup_steps = warmup_steps
        self.warmup_begin_lr = warmup_begin_lr
        self.warmup_mode = warmup_mode

    def get_warmup_lr(self, num_update):
        if self.warmup_mode == "linear":
            inc = (self.base_lr - self.warmup_begin_lr) * num_update / max(self.warmup_steps, 1)
            return self.warmup_begin_lr + inc
        return self.base_lr

    def __call__(self, num_update):
        raise NotImplementedError


class FactorScheduler(LRScheduler):
    """lr × factor every ``step`` updates, not below ``stop_factor_lr``."""

    def __init__(self, step, factor=1.0, stop_factor_lr=1e-8, **kw):
        super().__init__(**kw)
        if step < 1:
            raise ValueError("Schedule step must be greater or equal than 1")
        self.step = step
        self.factor = factor
        self.stop_factor_lr = stop_factor_lr

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        lr = self.base_lr * (self.factor ** ((num_update - self.warmup_steps) // self.step))
        return max(lr, self.stop_factor_lr)


class MultiFactorScheduler(LRScheduler):
    """lr × factor at each update count of the increasing list ``step``."""

    def __init__(self, step, factor=1.0, **kw):
        super().__init__(**kw)
        if not all(step[i] < step[i + 1] for i in range(len(step) - 1)):
            raise ValueError("Schedule step must be an increasing list")
        self.step = list(step)
        self.factor = factor

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        n = sum(1 for s in self.step if s <= num_update)
        return self.base_lr * (self.factor ** n)

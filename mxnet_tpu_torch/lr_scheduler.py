"""Learning-rate schedulers: ``FactorScheduler``, ``MultiFactorScheduler``,
``PolyScheduler``, ``CosineScheduler`` and ``WarmupScheduler``.

PyTorch-port copy of ``mxnet_tpu/lr_scheduler.py`` (reference:
python/mxnet/lr_scheduler.py).  A scheduler maps the optimizer's
``num_update`` to a rate; the optimizer sets its ``base_lr``.  Factor and
MultiFactor keep their decay in ``base_lr`` as they go, as the
reference's do, so a schedule is read forward, once per update count.
"""
from __future__ import annotations

import math

__all__ = ["LRScheduler", "FactorScheduler", "MultiFactorScheduler", "PolyScheduler",
           "CosineScheduler", "WarmupScheduler"]


class LRScheduler:
    def __init__(self, base_lr=0.01):
        self.base_lr = base_lr

    def __call__(self, num_update: int) -> float:
        raise NotImplementedError


class FactorScheduler(LRScheduler):
    def __init__(self, step, factor=1.0, stop_factor_lr=1e-8, base_lr=0.01):
        super().__init__(base_lr)
        if step < 1:
            raise ValueError("step must be >= 1")
        self.step = step
        self.factor = factor
        self.stop_factor_lr = stop_factor_lr
        self.count = 0

    def __call__(self, num_update):
        while num_update > self.count + self.step:
            self.count += self.step
            self.base_lr *= self.factor
            if self.base_lr < self.stop_factor_lr:
                self.base_lr = self.stop_factor_lr
        return self.base_lr


class MultiFactorScheduler(LRScheduler):
    def __init__(self, step, factor=1.0, base_lr=0.01):
        super().__init__(base_lr)
        if not all(step[i] < step[i + 1] for i in range(len(step) - 1)):
            raise ValueError("steps must be increasing")
        self.step = list(step)
        self.cur_step_ind = 0
        self.factor = factor
        self.count = 0

    def __call__(self, num_update):
        while self.cur_step_ind < len(self.step):
            if num_update > self.step[self.cur_step_ind]:
                self.count = self.step[self.cur_step_ind]
                self.cur_step_ind += 1
                self.base_lr *= self.factor
            else:
                break
        return self.base_lr


class PolyScheduler(LRScheduler):
    def __init__(self, max_update, base_lr=0.01, pwr=2):
        super().__init__(base_lr)
        self.base_lr_orig = base_lr
        self.max_update = max_update
        self.power = pwr

    def __call__(self, num_update):
        if num_update <= self.max_update:
            self.base_lr = self.base_lr_orig * (
                1.0 - num_update / self.max_update) ** self.power
        return self.base_lr


class CosineScheduler(LRScheduler):
    def __init__(self, max_update, base_lr=0.01, final_lr=0.0):
        super().__init__(base_lr)
        self.base_lr_orig = base_lr
        self.max_update = max_update
        self.final_lr = final_lr

    def __call__(self, num_update):
        if num_update <= self.max_update:
            self.base_lr = self.final_lr + (self.base_lr_orig - self.final_lr) * \
                (1 + math.cos(math.pi * num_update / self.max_update)) / 2
        return self.base_lr


class WarmupScheduler(LRScheduler):
    """Linear warmup wrapping another scheduler."""

    def __init__(self, scheduler: LRScheduler, warmup_steps=0, warmup_begin_lr=0.0):
        self.scheduler = scheduler  # before super(): base_lr setter forwards
        super().__init__(scheduler.base_lr)
        self.warmup_steps = warmup_steps
        self.warmup_begin_lr = warmup_begin_lr

    # The optimizer assigns base_lr on the WRAPPER.  Forward each assignment
    # to the wrapped schedule exactly once — reassigning inside __call__
    # erased the in-place decay Factor/MultiFactor keep in their base_lr
    # (one-shot counters: the decay could never be recomputed).
    @property
    def base_lr(self):
        return self._base_lr

    @base_lr.setter
    def base_lr(self, value):
        self._base_lr = value
        sched = getattr(self, "scheduler", None)
        if sched is not None:
            sched.base_lr = value
            if hasattr(sched, "base_lr_orig"):
                sched.base_lr_orig = value

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.warmup_begin_lr + (self._base_lr - self.warmup_begin_lr) \
                * num_update / max(self.warmup_steps, 1)
        return self.scheduler(num_update)

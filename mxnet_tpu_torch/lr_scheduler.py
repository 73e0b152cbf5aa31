"""Learning-rate schedules (parity: mxnet_tpu/lr_scheduler.py:20-153; the
reference python/mxnet/lr_scheduler.py): Factor, MultiFactor, Poly and
Cosine, each with warmup.  Host-side Python, called with the optimizer's
``num_update``; its own copy of the JAX package's stdlib module."""
from __future__ import annotations

import math

__all__ = ["LRScheduler", "FactorScheduler", "MultiFactorScheduler",
           "PolyScheduler", "CosineScheduler"]


class LRScheduler:
    """Maps ``num_update`` (optimizer update count) to a learning rate.

    Subclasses override :meth:`_lr_after_warmup`; warmup interpolation for
    steps below ``warmup_steps`` is handled here for every schedule.
    """

    def __init__(self, base_lr=0.01, warmup_steps=0, warmup_begin_lr=0,
                 warmup_mode="linear"):
        if warmup_begin_lr > base_lr:
            raise ValueError("base lr must be larger than warmup_begin_lr")
        if warmup_steps < 0:
            raise ValueError("warmup_steps must be >= 0")
        if warmup_mode not in ("linear", "constant"):
            raise ValueError("Invalid warmup mode %s" % warmup_mode)
        self.base_lr = self.warmup_final_lr = base_lr
        self.warmup_steps, self.warmup_begin_lr = warmup_steps, warmup_begin_lr
        self.warmup_mode = warmup_mode

    def get_warmup_lr(self, num_update):
        assert num_update < self.warmup_steps, "past the warmup window"
        if self.warmup_mode == "constant":
            return self.warmup_begin_lr
        ramp = num_update / float(self.warmup_steps)
        return self.warmup_begin_lr + \
            ramp * (self.warmup_final_lr - self.warmup_begin_lr)

    def _lr_after_warmup(self, num_update):
        raise NotImplementedError

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        return self._lr_after_warmup(num_update)


class FactorScheduler(LRScheduler):
    """Multiply lr by ``factor`` every ``step`` updates, floored at
    ``stop_factor_lr``."""

    def __init__(self, step, factor=1, stop_factor_lr=1e-8, base_lr=0.01,
                 warmup_steps=0, warmup_begin_lr=0, warmup_mode="linear"):
        super().__init__(base_lr, warmup_steps, warmup_begin_lr, warmup_mode)
        if step < 1:
            raise ValueError("step must be at least 1")
        if factor > 1.0:
            raise ValueError("factor must be <= 1 so the lr decays")
        self.step, self.factor = step, factor
        self.stop_factor_lr, self.count = stop_factor_lr, 0

    def _lr_after_warmup(self, num_update):
        # Stateful on purpose (matches reference): base_lr decays as the
        # update counter crosses each step boundary.
        while num_update - self.count > self.step:
            self.count += self.step
            self.base_lr = max(self.base_lr * self.factor,
                               self.stop_factor_lr)
        return self.base_lr


class MultiFactorScheduler(LRScheduler):
    """Multiply lr by ``factor`` at each milestone in the ``step`` list."""

    def __init__(self, step, factor=1, base_lr=0.01, warmup_steps=0,
                 warmup_begin_lr=0, warmup_mode="linear"):
        super().__init__(base_lr, warmup_steps, warmup_begin_lr, warmup_mode)
        if not isinstance(step, list) or not step:
            raise ValueError("step must be a non-empty list of milestones")
        if any(s < 1 for s in step):
            raise ValueError("every milestone must be at least 1")
        if sorted(set(step)) != step:
            raise ValueError("milestones must be strictly increasing")
        if factor > 1.0:
            raise ValueError("factor must be <= 1 so the lr decays")
        self.step, self.factor = step, factor
        self.cur_step_ind, self.count = 0, 0

    def _lr_after_warmup(self, num_update):
        pending = self.step[self.cur_step_ind:]
        for milestone in pending:
            if num_update <= milestone:
                break
            self.count = milestone
            self.cur_step_ind += 1
            self.base_lr *= self.factor
        return self.base_lr


class _AnnealingScheduler(LRScheduler):
    """Shared shell for schedules that anneal base→final over ``max_update``
    post-warmup steps via a shape function of progress t ∈ [0, 1]."""

    def __init__(self, max_update, base_lr=0.01, final_lr=0, warmup_steps=0,
                 warmup_begin_lr=0, warmup_mode="linear"):
        super().__init__(base_lr, warmup_steps, warmup_begin_lr, warmup_mode)
        if not isinstance(max_update, int):
            raise TypeError("max_update must be an int")
        if max_update < 1:
            raise ValueError(
                "maximum number of updates must be strictly positive")
        self.base_lr_orig, self.final_lr = base_lr, final_lr
        self.max_update = max_update
        self.max_steps = max_update - warmup_steps

    def _shape(self, t):
        """Decay weight in [0,1]: 1 at t=0, 0 at t=1."""
        raise NotImplementedError

    def _lr_after_warmup(self, num_update):
        if num_update <= self.max_update:
            t = (num_update - self.warmup_steps) / float(self.max_steps)
            span = self.base_lr_orig - self.final_lr
            self.base_lr = self.final_lr + span * self._shape(t)
        return self.base_lr


class PolyScheduler(_AnnealingScheduler):
    """Polynomial decay: lr = final + (base-final) * (1-t)^pwr."""

    def __init__(self, max_update, base_lr=0.01, pwr=2, final_lr=0,
                 warmup_steps=0, warmup_begin_lr=0, warmup_mode="linear"):
        super().__init__(max_update, base_lr, final_lr, warmup_steps,
                         warmup_begin_lr, warmup_mode)
        self.power = pwr

    def _shape(self, t):
        return (1 - t) ** self.power


class CosineScheduler(_AnnealingScheduler):
    """Cosine decay: lr = final + (base-final) * (1+cos(pi t))/2."""

    def _shape(self, t):
        return (1 + math.cos(math.pi * t)) / 2

"""Learning-rate schedules (the port's copy of ``mxnet_tpu/lr_scheduler.py``).

Each schedule maps the optimizer's update count to a learning rate in
closed form (``__call__(num_update)``; the optimizer sets ``base_lr``),
so the train step can evaluate it on the host every step and a replay or
a resume sees the same rates.  ``FactorScheduler`` and
``MultiFactorScheduler`` are the reference pair; ``PolyScheduler``,
``CosineScheduler`` and the linear ``WarmupScheduler`` wrapper come with
the JAX package.
"""
from __future__ import annotations

import bisect
import logging
import math

__all__ = ["LRScheduler", "FactorScheduler", "MultiFactorScheduler",
           "PolyScheduler", "CosineScheduler", "WarmupScheduler"]


class LRScheduler:
    """Maps the optimizer's global update count to a learning rate."""

    def __init__(self, base_lr=0.01):
        self.base_lr = base_lr
        self._last_announced = None

    def _rate(self, num_update):
        raise NotImplementedError()

    def __call__(self, num_update):
        lr = self._rate(max(int(num_update), 0))
        if lr != self._last_announced:
            if self._last_announced is not None:
                logging.info("Update[%d]: learning rate is now %0.5e",
                             num_update, lr)
            self._last_announced = lr
        return lr


class FactorScheduler(LRScheduler):
    """Geometric decay: one ``factor`` multiplication every ``step``
    updates, floored at ``stop_factor_lr``."""

    def __init__(self, step, factor=1, stop_factor_lr=1e-8):
        super().__init__()
        if step < 1:
            raise ValueError("schedule step must be >= 1")
        if factor > 1.0:
            raise ValueError("factor must be <= 1 so the lr decays")
        self.step = step
        self.factor = factor
        self.stop_factor_lr = stop_factor_lr

    def _rate(self, num_update):
        drops = max(num_update - 1, 0) // self.step
        return max(self.base_lr * self.factor ** drops, self.stop_factor_lr)


class MultiFactorScheduler(LRScheduler):
    """Multiply by ``factor`` as each milestone in ``step`` is passed."""

    def __init__(self, step, factor=1):
        super().__init__()
        if not isinstance(step, list) or not step:
            raise ValueError("step must be a non-empty list of milestones")
        if any(s < 1 for s in step):
            raise ValueError("schedule step must be >= 1")
        if any(b <= a for a, b in zip(step, step[1:])):
            raise ValueError("milestones must be strictly increasing")
        if factor > 1.0:
            raise ValueError("factor must be <= 1 so the lr decays")
        self.step = step
        self.factor = factor

    def _rate(self, num_update):
        # milestones passed = how many entries are < num_update
        drops = bisect.bisect_left(self.step, num_update)
        return self.base_lr * self.factor ** drops


class PolyScheduler(LRScheduler):
    """Polynomial decay to ``final_lr`` over ``max_update`` steps."""

    def __init__(self, max_update, power=2.0, final_lr=0.0):
        super().__init__()
        if max_update < 1:
            raise ValueError("max_update must be >= 1")
        self.max_update = max_update
        self.power = power
        self.final_lr = final_lr

    def _rate(self, num_update):
        frac = min(num_update / self.max_update, 1.0)
        return self.final_lr + (self.base_lr - self.final_lr) \
            * (1.0 - frac) ** self.power


class CosineScheduler(LRScheduler):
    """Cosine decay to ``final_lr`` over ``max_update`` steps."""

    def __init__(self, max_update, final_lr=0.0):
        super().__init__()
        if max_update < 1:
            raise ValueError("max_update must be >= 1")
        self.max_update = max_update
        self.final_lr = final_lr

    def _rate(self, num_update):
        frac = min(num_update / self.max_update, 1.0)
        return self.final_lr + 0.5 * (self.base_lr - self.final_lr) \
            * (1.0 + math.cos(math.pi * frac))


class WarmupScheduler(LRScheduler):
    """Linear ramp from ``start_lr`` for ``warmup_steps``, then delegate to
    the wrapped schedule (which sees the post-warmup update count)."""

    def __init__(self, child, warmup_steps, start_lr=0.0):
        super().__init__()
        if warmup_steps < 1:
            raise ValueError("warmup_steps must be >= 1")
        self.child = child
        self.warmup_steps = warmup_steps
        self.start_lr = start_lr

    @property
    def base_lr(self):
        return self.child.base_lr

    @base_lr.setter
    def base_lr(self, v):
        # the optimizer assigns base_lr before the child exists (object
        # construction order) — tolerate that window
        if hasattr(self, "child"):
            self.child.base_lr = v

    def _rate(self, num_update):
        if num_update < self.warmup_steps:
            frac = num_update / self.warmup_steps
            return self.start_lr + (self.base_lr - self.start_lr) * frac
        return self.child._rate(num_update - self.warmup_steps)

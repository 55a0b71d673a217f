"""Mip-NeRF's log-linear learning-rate schedule with a delayed warm-up.

Counterpart of `jnerf_tpu/optims/linearlog.py`: ``lr = delay(step) *
exp(log(init) * (1 - t) + log(end) * t)``, t = clip(step / max_steps, 0,
1), the delay a sine ease from ``lr_delay_mult`` to 1 over
``lr_delay_steps``.  The schedule is computed in f32 step by step, as the
jnp version computes it, and the nested Adam reads it at its step count
before the increment, as optax's ``scale_by_schedule`` does.
"""

from __future__ import annotations

import math

import numpy as np

from jnerf_tpu_torch.utils.registry import OPTIMS


@OPTIMS.register_module()
class LinearLog:
    def __init__(self, nested_optimizer, end_lr, max_steps, lr_delay_steps=0,
                 lr_delay_mult=1.0):
        self.nested = nested_optimizer
        self.init_lr = nested_optimizer.lr
        self.end_lr = end_lr
        self.max_steps = max_steps
        self.lr_delay_steps = lr_delay_steps
        self.lr_delay_mult = lr_delay_mult

    def schedule(self, step) -> float:
        f = np.float32
        step = f(step)
        if self.lr_delay_steps > 0:
            ramp = np.clip(step / f(self.lr_delay_steps), f(0), f(1))
            delay_rate = f(self.lr_delay_mult) + f(1 - self.lr_delay_mult) \
                * np.sin(f(0.5 * math.pi) * ramp)
        else:
            delay_rate = f(1.0)
        t = np.clip(step / f(self.max_steps), f(0), f(1))
        log_lerp = np.exp(np.log(f(self.init_lr)) * (f(1) - t)
                          + np.log(f(self.end_lr)) * t)
        return float(f(delay_rate * log_lerp))

    def make(self, params):
        return self.nested.make(params, lr_schedule=self.schedule)

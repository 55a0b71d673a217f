"""Optimizers: Adam, the ExpDecay LR wrapper, and the in-place EMA smoother.

Counterpart of `jnerf_tpu/optims/__init__.py`, with the same numbers as
the optax transforms the JAX package builds:

- ``Adam`` is ``optax.adam``: moments ``(1-b)*g + b*m``, bias correction at
  the incremented step count, eps added after the square root, and the
  step ``-lr * m_hat / (sqrt(v_hat) + eps)``.
- ``ExpDecay`` wraps a nested Adam with the step-function schedule
  ``lr * decay_base ** n_decays(step)``, read at the step count *before*
  the increment, as optax's ``scale_by_schedule`` reads it.
- ``EMA`` overwrites the live parameters with the debiased moving average
  each step and the shadow copies the result, so training continues from
  the smoothed parameters (the reference's `ema.py:26-37`).

Updates are in place on the parameters' own storage.
"""

from __future__ import annotations

from typing import Callable, Iterable

import numpy as np
import torch

from jnerf_tpu_torch.utils.registry import OPTIMS


def _f32(x) -> float:
    """x rounded to f32, as a Python float."""
    return float(np.float32(x))


class AdamOptimizer(torch.optim.Optimizer):
    """optax.adam over ``params``' ``.grad``, updated in place."""

    def __init__(self, params: Iterable[torch.nn.Parameter], lr: float,
                 betas=(0.9, 0.999), eps: float = 1e-8,
                 lr_schedule: Callable[[int], float] | None = None):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps))
        self.lr_schedule = lr_schedule
        self.count = 0  # steps taken; optax's ScaleByAdamState.count

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("AdamOptimizer.step takes no closure")
        count_inc = self.count + 1
        for group in self.param_groups:
            b1, b2 = group["betas"]
            lr = (group["lr"] if self.lr_schedule is None
                  else self.lr_schedule(self.count))
            # decay**count in f32, as optax computes it; every scalar below
            # is a Python float holding an f32 value.
            c1 = _f32(1.0 - _f32(np.float32(b1) ** np.float32(count_inc)))
            c2 = _f32(1.0 - _f32(np.float32(b2) ** np.float32(count_inc)))
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                st = self.state[p]
                if not st:
                    st["mu"] = torch.zeros_like(p)
                    st["nu"] = torch.zeros_like(p)
                mu, nu = st["mu"], st["nu"]
                mu.mul_(b1).add_(g * (1.0 - b1))
                nu.mul_(b2).add_(g * g * (1.0 - b2))
                upd = (mu / c1) / (torch.sqrt(nu / c2) + group["eps"])
                p.sub_(upd * _f32(lr))
        self.count = count_inc


@OPTIMS.register_module()
class Adam:
    def __init__(self, lr, eps=1e-8, betas=(0.9, 0.999)):
        self.lr = lr
        self.eps = eps
        self.betas = tuple(betas)

    def make(self, params, lr_schedule=None) -> AdamOptimizer:
        return AdamOptimizer(params, self.lr, self.betas, self.eps,
                             lr_schedule=lr_schedule)


@OPTIMS.register_module()
class ExpDecay:
    def __init__(
        self,
        nested_optimizer,
        decay_start: int,
        decay_interval: int,
        decay_base: float,
        decay_end=None,
    ):
        self.nested = nested_optimizer
        self.decay_start = decay_start
        self.decay_interval = decay_interval
        self.decay_base = decay_base
        self.decay_end = 10_000_000 if decay_end is None else decay_end

    def schedule(self, step: int) -> float:
        """Learning rate at optimizer step ``step`` (pre-increment)."""
        step = min(step, self.decay_end)
        n = ((step - self.decay_start) // self.decay_interval + 1
             if step >= self.decay_start else 0)
        return _f32(np.float32(self.nested.lr)
                    * np.float32(self.decay_base) ** np.float32(n))

    def make(self, params) -> AdamOptimizer:
        return self.nested.make(params, lr_schedule=self.schedule)


@OPTIMS.register_module()
class EMA:
    def __init__(self, decay):
        self.decay = decay

    def init(self, params: Iterable[torch.Tensor]):
        return {"shadow": [p.detach().clone() for p in params], "steps": 0}

    @torch.no_grad()
    def step(self, params: Iterable[torch.Tensor], state):
        """Smooth ``params`` in place; the shadow takes the same values."""
        steps = state["steps"] + 1
        d = np.float32(self.decay)
        debias_old = np.float32(1.0) - d ** np.float32(steps - 1)
        debias_new = np.float32(1.0) / (np.float32(1.0) - d ** np.float32(steps))
        keep, mix = _f32(np.float32(1.0) - d), _f32(d * debias_old)
        for p, v in zip(params, state["shadow"]):
            p.mul_(keep).add_(v * mix)
            p.mul_(_f32(debias_new))
            v.copy_(p)
        state["steps"] = steps
        return state


from .linearlog import LinearLog  # noqa: E402,F401
from .svox2_optim import PlenOptim  # noqa: E402,F401

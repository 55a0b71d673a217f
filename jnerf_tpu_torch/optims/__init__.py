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

Updates are in place on the parameters' own storage.  The scalars that
change from step to step (Adam's learning rate and bias corrections, the
EMA's factors) are computed on the host in numpy f32, one row a step
(``scalar_rows``), and the updates read them from a device tensor: a row
that ``step`` makes, or a row of a window's table that the runner copies
in once, so that a captured CUDA graph reads each replay's own values.
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

    # Columns of a parameter group's scalars in a step's row.
    ROW = ("lr", "c1", "c2", "inv_c1", "inv_c2")

    def __init__(self, params: Iterable[torch.nn.Parameter], lr: float,
                 betas=(0.9, 0.999), eps: float = 1e-8,
                 lr_schedule: Callable[[int], float] | None = None):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps))
        self.lr_schedule = lr_schedule
        self.count = 0  # steps taken; optax's ScaleByAdamState.count

    @property
    def row_width(self) -> int:
        return len(self.ROW) * len(self.param_groups)

    def scalar_rows(self, n: int) -> np.ndarray:
        """[n, row_width] f32: the scalars of the next ``n`` steps, each
        group's ``ROW`` in turn.  The learning rate is the schedule's at
        the step count before the increment; c1 and c2 are the bias
        corrections at the incremented count, decay**count in f32 as optax
        computes it; inv_c1 and inv_c2 their f32 reciprocals."""
        rows = np.empty((n, self.row_width), dtype=np.float32)
        w = len(self.ROW)
        for j in range(n):
            count = self.count + j
            for gi, group in enumerate(self.param_groups):
                b1, b2 = group["betas"]
                lr = (group["lr"] if self.lr_schedule is None
                      else self.lr_schedule(count))
                c1 = _f32(1.0 - _f32(np.float32(b1) ** np.float32(count + 1)))
                c2 = _f32(1.0 - _f32(np.float32(b2) ** np.float32(count + 1)))
                rows[j, w * gi:w * (gi + 1)] = (
                    lr, c1, c2, np.float32(1.0) / np.float32(c1),
                    np.float32(1.0) / np.float32(c2))
        return rows

    @torch.no_grad()
    def step(self, closure=None, row: torch.Tensor | None = None):
        """One update; ``row`` [row_width] holds this step's scalars on the
        parameters' device (``scalar_rows(1)[0]`` copied there if None)."""
        if closure is not None:
            raise ValueError("AdamOptimizer.step takes no closure")
        if row is None:
            row = _device_row(self.scalar_rows(1)[0],
                              self.param_groups[0]["params"][0].device)
        w = len(self.ROW)
        for gi, group in enumerate(self.param_groups):
            b1, b2 = group["betas"]
            lr, c1, c2, inv_c1, inv_c2 = row[w * gi:w * (gi + 1)].unbind()
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
                # What `t / c` computed when c was a Python float: on CUDA
                # a product with c's f32 reciprocal, on the CPU a quotient.
                if p.is_cuda:
                    upd = (mu * inv_c1) / (torch.sqrt(nu * inv_c2)
                                           + group["eps"])
                else:
                    upd = (mu / c1) / (torch.sqrt(nu / c2) + group["eps"])
                p.sub_(upd * lr)
        self.count += 1


def _device_row(row: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host row of f32 scalars on ``device``, copied without a wait."""
    t = torch.from_numpy(row)
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


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

    def scalar_rows(self, steps: int, n: int) -> np.ndarray:
        """[n, 3] f32: (keep, mix, debias) of the ``n`` steps after
        ``steps`` taken."""
        rows = np.empty((n, 3), dtype=np.float32)
        d = np.float32(self.decay)
        for j in range(n):
            s = steps + j + 1
            debias_old = np.float32(1.0) - d ** np.float32(s - 1)
            debias_new = np.float32(1.0) / (np.float32(1.0) - d ** np.float32(s))
            rows[j] = (_f32(np.float32(1.0) - d), _f32(d * debias_old),
                       _f32(debias_new))
        return rows

    @torch.no_grad()
    def step(self, params: Iterable[torch.Tensor], state,
             row: torch.Tensor | None = None):
        """Smooth ``params`` in place; the shadow takes the same values.
        ``row`` [3] holds this step's scalars on the parameters' device
        (``scalar_rows`` of this step copied there if None)."""
        params = list(params)
        if row is None:
            row = _device_row(self.scalar_rows(state["steps"], 1)[0],
                              params[0].device)
        keep, mix, debias = row.unbind()
        for p, v in zip(params, state["shadow"]):
            p.mul_(keep).add_(v * mix)
            p.mul_(debias)
            v.copy_(p)
        state["steps"] += 1
        return state


from .linearlog import LinearLog  # noqa: E402,F401
from .svox2_optim import PlenOptim  # noqa: E402,F401

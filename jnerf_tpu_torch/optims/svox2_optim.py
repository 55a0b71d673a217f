"""Plenoxels' two-group optimizer: SGD on density, RMSprop on SH.

Counterpart of `jnerf_tpu/optims/svox2_optim.py`: svox2's delayed
exponential learning rate (``expon_lr``, in f32 as the jnp version computes
it) and ``PlenOptim``, whose step updates the grid's tables in place:
``density -= lr_sigma * g``; ``rms = b * rms + (1 - b) * g^2``; ``sh -=
lr_sh * g / (sqrt(rms) + 1e-8)`` (eps outside the square root).  The
tables are the dense grid's ``density`` and ``sh`` or the sparse grid's
``density_data`` and ``sh_data``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from jnerf_tpu_torch.utils.registry import OPTIMS


def expon_lr(step, lr_init, lr_final, lr_delay_steps=0, lr_delay_mult=1.0,
             max_steps=250000) -> float:
    """svox2's get_expon_lr_func: log-lerp with an optional sine-eased
    delay, as a Python float holding the f32 value."""
    f = np.float32
    step = f(step)
    if lr_delay_steps > 0:
        ramp = np.clip(step / f(lr_delay_steps), f(0), f(1))
        delay = f(lr_delay_mult) + f(1 - lr_delay_mult) \
            * np.sin(f(0.5 * math.pi) * ramp)
    else:
        delay = f(1.0)
    t = np.clip(step / f(max_steps), f(0), f(1))
    return float(f(delay * np.exp(f(np.log(lr_init)) * (f(1) - t)
                                  + f(np.log(lr_final)) * t)))


@OPTIMS.register_module()
class PlenOptim:
    """Per-group plain SGD (density) + RMSprop (SH); the runner supplies
    each step's learning rates."""

    def __init__(self, rms_beta=0.95):
        self.rms_beta = rms_beta

    @staticmethod
    def _keys(params):
        dk = "density" if "density" in params else "density_data"
        sk = "sh" if "sh" in params else "sh_data"
        return dk, sk

    def init(self, params: dict) -> dict:
        """``params``: the grid's tables by name (its named parameters)."""
        _, sk = self._keys(params)
        return {"sh_rms": torch.zeros_like(params[sk])}

    @torch.no_grad()
    def step(self, params: dict, state: dict, lr_sigma, lr_sh) -> dict:
        """Update the tables from their ``.grad`` in place at the learning
        rates ``lr_sigma`` and ``lr_sh`` (f32 values: Python floats, or
        0-dim tensors on the tables' device, which a CUDA graph reads
        there); returns the state."""
        dk, sk = self._keys(params)
        density, sh = params[dk], params[sk]
        density.sub_(density.grad * lr_sigma)
        g = sh.grad
        b = self.rms_beta
        rms = state["sh_rms"]
        rms.mul_(b).add_(g.square().mul_(1 - b))
        sh.sub_((g * lr_sh).div_(rms.sqrt().add_(1e-8)))
        return state

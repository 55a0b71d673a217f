"""The numbers that decide ``correct``: what the timed path produced
against the plain reference, each held to its limit (`limits/<cell>.json`).

Training (the first steps, taken through the window's own call):

- ``first_loss_gap``: the gap of the first step's main loss, as a share of
  the reference's; ``loss_gap``: the largest such gap over the steps;
- ``grad_gap``: by the worst leaf, the gap between the program's and the
  reference's norm of the first gradient, as a share of the larger of the
  reference's norm of that leaf and of the median leaf;
- ``change_gap``: the same of the parameters' change after the steps, over
  the leaves whose reference gradient is at least a thousandth of the
  median leaf's (the others move under Adam by rounding alone).

Rendering (a sample of the window's requests, drawn from the seed):
``view_rmse``, the largest root-mean-square gap of a view's pixels;
``pixels_off``, the number of pixels of the sampled views whose largest
channel gap exceeds a tenth of the colour range; ``pixel_gap``, the
largest gap of any channel of any pixel.
"""

from __future__ import annotations

import math
import statistics

import numpy as np
import torch

# A leaf whose reference gradient is under this share of the median
# leaf's is left out of the change.
STILL = 1e-3
# A pixel is off when a channel's gap exceeds this share of the range.
OFF = 0.1


def _norm(t) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def _worst(prog: dict, ref: dict, names) -> float:
    med = statistics.median(ref[k] for k in names)
    return max(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-300)
               for k in names)


def train_numbers(judged: dict, losses, grads: dict, params: dict,
                  params0: dict) -> dict:
    """The training numbers from the program's ``judged`` outputs and the
    reference's losses, first gradients and parameters after the steps."""
    gaps = [abs(p - r) / abs(r) for p, r in zip(judged["losses"], losses)]
    g_ref = {k: _norm(g) for k, g in grads.items()}
    med = statistics.median(g_ref.values())
    moved = [k for k in g_ref if g_ref[k] >= STILL * med]
    d_ref = {k: _norm(params[k] - params0[k].to(params[k].device))
             for k in moved}
    return {"first_loss_gap": gaps[0], "loss_gap": max(gaps),
            "grad_gap": _worst(judged["grad"], g_ref, list(g_ref)),
            "change_gap": _worst(judged["change"], d_ref, moved)}


def judged_of(losses, grads: dict, params: dict, params0: dict) -> dict:
    """Reference outputs (as `reference.train_steps` returns them) in the
    form of the program's judged outputs: the control's."""
    return {"losses": losses,
            "grad": {k: _norm(g) for k, g in grads.items()},
            "change": {k: _norm(params[k] - params0[k]) for k in params}}


def render_numbers(prog_imgs, ref_imgs) -> dict:
    rmse, gap, off = 0.0, 0.0, 0
    for p, r in zip(prog_imgs, ref_imgs):
        d = np.asarray(p, np.float64) - np.asarray(r, np.float64)
        rmse = max(rmse, math.sqrt(float(np.mean(d * d))))
        worst = np.max(np.abs(d), axis=-1)
        gap = max(gap, float(np.max(worst)))
        off += int(np.sum(worst > OFF))
    return {"view_rmse": rmse, "pixels_off": off, "pixel_gap": gap}


def verdict(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: {value, limit}}): every number that the cell's
    limits name finite and at most its limit."""
    shown = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    ok = all(math.isfinite(v["value"]) and v["value"] <= v["limit"]
             for v in shown.values())
    return ok, shown

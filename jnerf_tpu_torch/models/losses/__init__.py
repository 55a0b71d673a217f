"""Losses: Huber and MSE + PSNR helpers.

Counterpart of `jnerf_tpu/models/losses/__init__.py`: the loss classes
return elementwise values; the trainer takes the mean.
"""

from __future__ import annotations

import math

import torch

from jnerf_tpu_torch.utils.registry import LOSSES


def img2mse(x, y):
    return torch.mean((x - y) ** 2)


def mse2psnr(mse):
    return -10.0 * torch.log(torch.as_tensor(mse)) / math.log(10.0)


@LOSSES.register_module()
class HuberLoss:
    def __init__(self, delta):
        self.delta = delta

    def __call__(self, x, target):
        rel = torch.abs(x - target)
        sqr = 0.5 / self.delta * rel * rel
        return torch.where(rel > self.delta, rel - 0.5 * self.delta, sqr)


@LOSSES.register_module()
class MSELoss:
    def __call__(self, x, target):
        return (x - target) ** 2

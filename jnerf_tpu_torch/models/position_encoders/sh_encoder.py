"""Spherical-harmonics view-direction encoder module (degree 4, 16 dims).

Counterpart of `jnerf_tpu/models/position_encoders/sh_encoder.py`.
"""

from __future__ import annotations

import torch
from torch import nn

from jnerf_tpu_torch.ops.sh import sh_encode
from jnerf_tpu_torch.utils.registry import ENCODERS


@ENCODERS.register_module()
class SHEncoder(nn.Module):
    def __init__(self, degree: int = 4):
        super().__init__()
        if degree != 4:
            raise ValueError("SHEncoder runs at degree 4 / 16 dims")
        self.degree = degree
        self.out_dim = 16
        self.compute_dtype = None

    def reset_parameters(self, generator: torch.Generator):
        del generator  # no parameters

    def forward(self, x):
        out = sh_encode(x, self.degree)
        if self.compute_dtype is not None:
            out = out.to(self.compute_dtype)
        return out

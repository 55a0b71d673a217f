"""Classic NeRF sin/cos positional encoding.

Counterpart of `jnerf_tpu/models/position_encoders/freq_encoder.py`: no
parameters; the output is ``[x, sin(f_0 x), cos(f_0 x), sin(f_1 x), ...]``
(each block over the ``input_dims`` coordinates), f32, with frequencies
``2^0 .. 2^(multires-1)`` (log sampling) or evenly spaced between them.
"""

from __future__ import annotations

import torch
from torch import nn

from jnerf_tpu_torch.ops.linspace import linspace
from jnerf_tpu_torch.utils.registry import ENCODERS


@ENCODERS.register_module()
class FrequencyEncoder(nn.Module):
    def __init__(self, multires, include_input=True, input_dims=3,
                 log_sampling=True):
        super().__init__()
        self.multires = multires
        self.include_input = include_input
        self.input_dims = input_dims
        if log_sampling:
            freqs = 2.0 ** linspace(0.0, multires - 1, multires)
        else:
            freqs = linspace(2.0 ** 0.0, 2.0 ** (multires - 1), multires)
        self.register_buffer("freq_bands", freqs, persistent=False)
        self.out_dim = input_dims * (2 * multires + (1 if include_input else 0))

    def forward(self, x):
        """[..., D] -> [..., D * (include_input + 2 * multires)]."""
        xb = x[..., None, :] * self.freq_bands[:, None]  # [..., F, D]
        enc = torch.stack([torch.sin(xb), torch.cos(xb)], dim=-2)
        parts = [x] if self.include_input else []
        parts.append(enc.reshape(*x.shape[:-1], -1))
        return torch.cat(parts, dim=-1)

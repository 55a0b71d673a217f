"""Small shared helpers (counterpart of `jnerf_tpu/utils/common.py`)."""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=256)
def _device_const(values, dtype, device):
    return torch.tensor(values, dtype=dtype, device=device)


def device_const(values, device, dtype=torch.float32) -> torch.Tensor:
    """A constant tensor of ``values`` (a number or a tuple) on ``device``,
    made once a (values, dtype, device) and shared: a CUDA graph can read
    it, where ``torch.tensor(..., device=...)`` would copy from the host
    while the graph is captured.  Callers must not write to it."""
    return _device_const(values, dtype, torch.device(device))


def enlarge(arr: torch.Tensor, size: int) -> torch.Tensor:
    """Grow a buffer along its first axis to at least ``size`` rows, padded
    with zeros of its dtype on its device."""
    if arr.shape[0] >= size:
        return arr
    pad = arr.new_zeros((size - arr.shape[0],) + tuple(arr.shape[1:]))
    return torch.cat([arr, pad], dim=0)


class BoundingBox:
    """Host-side axis-aligned box."""

    def __init__(self, min_point=(0.0, 0.0, 0.0), max_point=(1.0, 1.0, 1.0)):
        self.min = np.asarray(min_point, np.float32)
        self.max = np.asarray(max_point, np.float32)

    def contains(self, p) -> bool:
        p = np.asarray(p)
        return bool(np.all(p >= self.min) and np.all(p <= self.max))

    def diag(self):
        return self.max - self.min

    def relative_pos(self, p):
        return (np.asarray(p) - self.min) / self.diag()

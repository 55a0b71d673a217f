"""Closed-form spherical-harmonics direction encoding (degree <= 4).

Same function as `jnerf_tpu/ops/sh.py`: warped directions in [0, 1]
(rescaled internally to [-1, 1]) -> degree**2 SH basis values per point.
Elementwise math; PyTorch's own kernels serve it.
"""

from __future__ import annotations

import torch


def sh_encode(dirs: torch.Tensor, degree: int = 4) -> torch.Tensor:
    """[N, 3] warped dirs in [0,1] -> [N, degree**2] SH features."""
    if not 1 <= degree <= 4:
        raise ValueError(f"SH degree must be in [1, 4], got {degree}")
    x = dirs[:, 0] * 2.0 - 1.0
    y = dirs[:, 1] * 2.0 - 1.0
    z = dirs[:, 2] * 2.0 - 1.0
    xy, xz, yz = x * y, x * z, y * z
    x2, y2, z2 = x * x, y * y, z * z

    out = [torch.full_like(x, 0.28209479177387814)]
    if degree >= 2:
        out += [
            -0.48860251190291987 * y,
            0.48860251190291987 * z,
            -0.48860251190291987 * x,
        ]
    if degree >= 3:
        out += [
            1.0925484305920792 * xy,
            -1.0925484305920792 * yz,
            0.94617469575755997 * z2 - 0.31539156525251999,
            -1.0925484305920792 * xz,
            0.54627421529603959 * (x2 - y2),
        ]
    if degree >= 4:
        out += [
            0.59004358992664352 * y * (-3.0 * x2 + y2),
            2.8906114426405538 * xy * z,
            0.45704579946446572 * y * (1.0 - 5.0 * z2),
            0.3731763325901154 * z * (5.0 * z2 - 3.0),
            0.45704579946446572 * x * (1.0 - 5.0 * z2),
            1.4453057213202769 * z * (x2 - y2),
            0.59004358992664352 * x * (-x2 + 3.0 * y2),
        ]
    return torch.stack(out, dim=-1)

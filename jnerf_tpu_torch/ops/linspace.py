"""``linspace`` with the JAX package's rounding.

``jnp.linspace`` computes ``start * (1 - s) + stop * s`` with ``s = i /
(num - 1)`` in f32 and sets the last point to ``stop``; ``torch.linspace``
steps from both ends and rounds differently in the last bit.  The NeuS
renderer's sample depths and inverse-CDF positions and the NeuS dataset's
pixel grids are such linspaces, so the port computes them this way.
"""

from __future__ import annotations

import torch

from jnerf_tpu_torch.utils.common import device_const


def linspace(start, stop, num: int, device=None) -> torch.Tensor:
    """[num] f32 from ``start`` to ``stop`` inclusive, as jnp.linspace."""
    if num == 1:
        return torch.full((1,), float(start), dtype=torch.float32,
                          device=device)
    div = num - 1
    s = torch.arange(div, dtype=torch.float32, device=device) / div
    dev = torch.device("cpu") if device is None else device
    start = device_const(float(start), dev)
    stop = device_const(float(stop), dev)
    return torch.cat([start * (1 - s) + stop * s, stop[None]])

"""General utilities (seeding, checkpoint discovery, file checks).

Counterpart of `jnerf_tpu/utils/general.py`; ``sync`` reduces over a
`jnerf_tpu_torch.parallel` mesh where the JAX function reduces over a
named mesh axis.
"""

from __future__ import annotations

import os
import random
import re

import numpy as np


def check_file(path: str, ext=None) -> bool:
    if not path or not os.path.isfile(path):
        return False
    if ext is not None and os.path.splitext(path)[1] not in ext:
        return False
    return True


def check_dir(path: str, make: bool = False) -> bool:
    if os.path.isdir(path):
        return True
    if make:
        os.makedirs(path, exist_ok=True)
        return True
    return False


def set_random_seed(seed: int) -> None:
    """Seed host-side RNGs.  Device randomness uses explicit
    ``torch.Generator``s."""
    random.seed(seed)
    np.random.seed(seed)


def search_ckpt(ckpt_dir: str, prefix: str = "ckpt_", suffix: str = ".pkl"):
    """Find the latest checkpoint file ``{prefix}{iter:06d}{suffix}`` in a dir.

    Returns the filename (not full path) or None.
    """
    if not os.path.isdir(ckpt_dir):
        return None
    best, best_iter = None, -1
    pat = re.compile(re.escape(prefix) + r"(\d+)" + re.escape(suffix) + r"$")
    for name in os.listdir(ckpt_dir):
        m = pat.match(name)
        if m and int(m.group(1)) > best_iter:
            best_iter, best = int(m.group(1)), name
    return best


def sync(data, reduce_mode="mean", mesh=None):
    """Sum (``reduce_mode="sum"``) or mean (``"mean"``) of a metric over
    the ranks of ``mesh`` (`jnerf_tpu_torch.parallel.Mesh`), as a tensor
    on the mesh's device; without a mesh the value as a tensor.  Python
    numbers pass through, as in the JAX package."""
    import torch

    if reduce_mode not in ("mean", "sum"):
        raise ValueError(f"reduce_mode={reduce_mode!r}: 'mean' or 'sum'")
    if isinstance(data, (int, float)):
        return data
    if mesh is None:
        return torch.as_tensor(data)
    import torch.distributed as dist

    data = torch.as_tensor(data, device=mesh.device).clone()
    dist.all_reduce(data, group=mesh.group)
    return data / mesh.size if reduce_mode == "mean" else data

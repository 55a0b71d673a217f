"""Multiresolution hash-grid geometry and the per-level linear hash.

`HashGridSpec` has the same fields and derived geometry as
`jnerf_tpu/ops/hash_grid.py::HashGridSpec`, so a table trained by either
package reads the same in the other.  `level_multipliers` and
`_corner_offsets` are copies of `jnerf_tpu/ops/hash_grid_rows.py:47-74`:
they must draw from ``default_rng(0x5F3759DF)`` in the same order, or the
hashed levels index a different table.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Tuple

import numpy as np
import torch

DEFAULT_HASH_FUNC = "p0 ^ p1 * 19349663 ^ p2 * 83492791"


@dataclass(frozen=True)
class HashGridSpec:
    """Static geometry of the hash grid (all host-side constants)."""

    n_levels: int = 16
    n_features_per_level: int = 2
    base_resolution: int = 16
    log2_hashmap_size: int = 19
    aabb_scale: float = 1.0
    desired_resolution: float = 2048.0
    hash_func: str = DEFAULT_HASH_FUNC
    # Extra cap on hashed-level table size (entries), on top of
    # 2**log2_hashmap_size (`HashEncoder`'s fast cap).  None = no extra cap.
    max_level_size: int | None = None
    # Derived (filled in __post_init__):
    per_level_scale: float = field(init=False, default=0.0)
    scales: Tuple[float, ...] = field(init=False, default=())
    resolutions: Tuple[int, ...] = field(init=False, default=())
    level_sizes: Tuple[int, ...] = field(init=False, default=())
    level_offsets: Tuple[int, ...] = field(init=False, default=())
    n_entries: int = field(init=False, default=0)

    def __post_init__(self):
        pls = math.exp(
            math.log(self.desired_resolution * self.aabb_scale / self.base_resolution)
            / max(self.n_levels - 1, 1)
        )
        scales, resolutions, sizes, offsets = [], [], [], [0]
        max_entries = 1 << self.log2_hashmap_size
        if self.max_level_size is not None:
            max_entries = min(max_entries, self.max_level_size)
        for lvl in range(self.n_levels):
            scale = 2.0 ** (lvl * math.log2(pls)) * self.base_resolution - 1.0
            res = int(math.ceil(scale)) + 1
            dense = res ** 3
            size = min(-(-dense // 8) * 8, max_entries)  # 8-aligned, capped
            scales.append(scale)
            resolutions.append(res)
            sizes.append(size)
            offsets.append(offsets[-1] + size)
        object.__setattr__(self, "per_level_scale", pls)
        object.__setattr__(self, "scales", tuple(scales))
        object.__setattr__(self, "resolutions", tuple(resolutions))
        object.__setattr__(self, "level_sizes", tuple(sizes))
        object.__setattr__(self, "level_offsets", tuple(offsets))
        object.__setattr__(self, "n_entries", offsets[-1])

    @property
    def out_dim(self) -> int:
        return self.n_levels * self.n_features_per_level

    def init_table(self, generator: torch.Generator):
        """Uniform +-1e-4 f32 init on the generator's device."""
        u = torch.rand((self.n_entries, self.n_features_per_level),
                       generator=generator, device=generator.device)
        return u * 2e-4 - 1e-4


def level_multipliers(spec: HashGridSpec) -> Tuple[Tuple[int, int, int], ...]:
    """(A, B, C) per level: dense strides for dense levels, randomized odd
    constants for hashed levels (decorrelated across levels)."""
    rng = np.random.default_rng(0x5F3759DF)
    out = []
    for lvl in range(spec.n_levels):
        res = spec.resolutions[lvl]
        size = spec.level_sizes[lvl]
        if res ** 3 <= size:
            out.append((1, res, res * res))
        else:
            a = int(rng.integers(1 << 16, 1 << 30)) | 1
            b = int(rng.integers(1 << 16, 1 << 30)) | 1
            c = int(rng.integers(1 << 16, 1 << 30)) | 1
            out.append((a, b, c))
    return tuple(out)


def _corner_offsets(spec: HashGridSpec):
    """[L, 8] additive index offset of each corner, mod the level size."""
    mults = level_multipliers(spec)
    offs = np.zeros((spec.n_levels, 8), np.int64)
    for lvl, (a, b, c) in enumerate(mults):
        size = spec.level_sizes[lvl]
        for corner in range(8):
            dx, dy, dz = corner & 1, (corner >> 1) & 1, (corner >> 2) & 1
            offs[lvl, corner] = (dx * a + dy * b + dz * c) % size
    return offs


def level_masks(spec: HashGridSpec) -> Tuple[int, ...]:
    """Per level, the AND mask that stands for ``% size``, or 0 where a
    real modulo is needed.  Dense levels never overflow their size
    (x + y*res + z*res^2 < res^3 <= size); power-of-two hashed levels mask
    with size-1 (`jnerf_tpu/ops/hash_nbr.py::_level_mask`)."""
    out = []
    for res, sz in zip(spec.resolutions, spec.level_sizes):
        if res ** 3 <= sz:
            out.append(0xFFFFFFFF)
        elif sz & (sz - 1) == 0:
            out.append(sz - 1)
        else:
            out.append(0)
    return tuple(out)

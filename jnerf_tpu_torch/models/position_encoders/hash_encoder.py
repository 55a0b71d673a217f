"""Multiresolution hash-grid encoder module.

Counterpart of `jnerf_tpu/models/position_encoders/hash_encoder.py`: the
table ``grid`` [n_entries, F] is an f32 parameter; the encoding is cast to
the owning network's compute dtype.  Every linear-hash indexing mode of the
JAX package (``linear_rows``, ``linear_nbr``, ``linear_rows_xla``) computes
the same encoding, so here all of them go to `ops.hash_nbr.hash_encode_nbr`
(kernel F forward, kernel B backward on the card).  ``indexing='xor'``, the
reference's hash at the reference's table sizes (no fast cap), goes to
`ops.hash_xor.hash_encode_xor` (kernels F and B in xor mode).
"""

from __future__ import annotations

import torch
from torch import nn

from jnerf_tpu_torch.ops.hash_grid import DEFAULT_HASH_FUNC, HashGridSpec
from jnerf_tpu_torch.ops.hash_nbr import hash_encode_nbr
from jnerf_tpu_torch.ops.hash_xor import hash_encode_xor
from jnerf_tpu_torch.utils.config import get_cfg
from jnerf_tpu_torch.utils.registry import ENCODERS

LINEAR_INDEXING = ("linear_rows", "linear_nbr", "linear_rows_xla")


@ENCODERS.register_module()
class HashEncoder(nn.Module):
    def __init__(
        self,
        n_pos_dims=3,
        n_features_per_level=2,
        n_levels=16,
        base_resolution=16,
        log2_hashmap_size=19,
        aabb_scale=None,
        hash_func=None,
        indexing=None,
    ):
        super().__init__()
        cfg = get_cfg()
        if aabb_scale is None:
            aabb_scale = (
                cfg.dataset_obj.aabb_scale if cfg.dataset_obj is not None else 1
            )
        if hash_func is None:
            hash_func = cfg.hash_func or DEFAULT_HASH_FUNC
        if indexing is None:
            indexing = cfg.hash_indexing or "linear_rows"
        if indexing != "xor" and indexing not in LINEAR_INDEXING:
            raise ValueError(f"unknown hash indexing {indexing!r}")
        if n_pos_dims != 3:
            raise ValueError("the hash grid is 3-D")
        self.indexing = indexing
        # The linear modes: the JAX package's hashed-level cap (its 8 MB
        # neighbourhood rows per level), so a table has the same geometry in
        # both; cfg.hashmap_fast_cap overrides it.  'xor' keeps the
        # reference's sizes.
        fast_cap = None
        if indexing != "xor":
            default_cap = (8 << 20) // (8 * n_features_per_level * 2)
            fast_cap = int(cfg.hashmap_fast_cap or default_cap)
        self.spec = HashGridSpec(
            n_levels=n_levels,
            n_features_per_level=n_features_per_level,
            base_resolution=base_resolution,
            log2_hashmap_size=log2_hashmap_size,
            aabb_scale=float(aabb_scale),
            hash_func=hash_func,
            max_level_size=fast_cap,
        )
        self.out_dim = self.spec.out_dim
        self.compute_dtype = None  # set by the owning network
        self.grid = nn.Parameter(
            torch.empty((self.spec.n_entries, n_features_per_level)))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        self.grid.copy_(self.spec.init_table(generator))

    def forward(self, x):
        if self.indexing == "xor":
            return hash_encode_xor(self.spec, self.grid, x, self.compute_dtype)
        return hash_encode_nbr(self.spec, self.grid, x, self.compute_dtype)

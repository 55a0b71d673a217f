"""Plain reference of `ngp_base.json`'s field: Instant-NGP.

A multiresolution hash encoding (16 levels of 2 features, base
resolution 16, finest 2048; a level holds min(res^3, its hashed size)
entries, each trilinearly interpolated from the 8 corners of the point's
cell), then a bias-free density MLP 32 -> 64 -> 16 and a colour MLP over
[the 16 density outputs, the degree-4 spherical harmonics of the view
direction] 32 -> 64 -> 64 -> 3, ReLU between layers.  The output is
[rgb logits, raw density] (the density MLP's first output).

The hashed levels use the program's linear hash, which this configuration
states: each level's corner entry is ``(gx A + gy B + gz C) mod 2^32 mod
size`` with (A, B, C) = (1, res, res^2) on a dense level and odd
constants drawn from ``numpy.random.default_rng(0x5F3759DF)`` on a hashed
one; the encoding is feature-major (feature f of level l at f * 16 + l).
"""

from __future__ import annotations

import math

import numpy as np
import torch

RENDER_TABLE_BOUND = 16.0

SH_C = (0.28209479177387814, 0.48860251190291987, 1.0925484305920792,
        0.94617469575755997, 0.31539156525251999, 0.54627421529603959,
        0.59004358992664352, 2.8906114426405538, 0.45704579946446572,
        0.3731763325901154, 1.4453057213202769)


def sh4(d):
    """Degree-4 real spherical harmonics [N, 16] of warped directions."""
    x, y, z = (d[:, i] * 2.0 - 1.0 for i in range(3))
    xy, xz, yz, x2, y2, z2 = x * y, x * z, y * z, x * x, y * y, z * z
    c = SH_C
    return torch.stack([
        torch.full_like(x, c[0]), -c[1] * y, c[1] * z, -c[1] * x,
        c[2] * xy, -c[2] * yz, c[3] * z2 - c[4], -c[2] * xz, c[5] * (x2 - y2),
        c[6] * y * (-3.0 * x2 + y2), c[7] * xy * z, c[8] * y * (1.0 - 5.0 * z2),
        c[9] * z * (5.0 * z2 - 3.0), c[8] * x * (1.0 - 5.0 * z2),
        c[10] * z * (x2 - y2), c[6] * x * (-x2 + 3.0 * y2)], dim=-1)


class HashGrid:
    def __init__(self, n_levels, n_features, base_res, log2_size, cap,
                 aabb_scale, finest=2048.0):
        pls = math.exp(math.log(finest * aabb_scale / base_res)
                       / max(n_levels - 1, 1))
        self.L, self.F = n_levels, n_features
        self.levels = []  # (scale f32, size, offset, (A, B, C))
        rng = np.random.default_rng(0x5F3759DF)
        offset = 0
        for lvl in range(n_levels):
            scale = 2.0 ** (lvl * math.log2(pls)) * base_res - 1.0
            res = int(math.ceil(scale)) + 1
            size = min(-(-res ** 3 // 8) * 8, min(1 << log2_size, cap))
            if res ** 3 <= size:
                mult = (1, res, res * res)
            else:
                mult = tuple(int(rng.integers(1 << 16, 1 << 30)) | 1
                             for _ in range(3))
            self.levels.append((float(np.float32(scale)), size, offset, mult))
            offset += size
        self.n_entries = offset

    def encode(self, table, pos, q):
        """[N, 3] in [0, 1] -> [N, F * L] f32, each feature the float32
        sum of its 8 corner weights times the table's rounded entries."""
        tbl = q.value(table)
        out = []
        for scale, size, offset, mult in self.levels:
            p = pos * scale + 0.5
            g = torch.floor(p)
            f = p - g
            g = g.long()
            acc = 0.0
            for c in range(8):
                bit = [(c >> d) & 1 for d in range(3)]
                h = sum(((g[:, d] + bit[d]) * mult[d]) & 0xFFFFFFFF
                        for d in range(3)) & 0xFFFFFFFF
                w = 1.0
                for d in range(3):
                    w = w * (f[:, d] if bit[d] else 1.0 - f[:, d])
                acc = acc + w[:, None] * tbl[offset + h % size]
            out.append(acc)
        return torch.stack(out, dim=2).reshape(pos.shape[0], self.F * self.L)


class Field:
    def __init__(self, cfg: dict, aabb_scale: float):
        enc = cfg["encoder"]["pos_encoder"]
        n_features = int(enc.get("n_features_per_level", 2))
        cap = int(cfg.get("hashmap_fast_cap") or (8 << 20) // (16 * n_features))
        self.grid = HashGrid(int(enc.get("n_levels", 16)), n_features,
                             int(enc.get("base_resolution", 16)),
                             int(enc.get("log2_hashmap_size", 19)), cap,
                             aabb_scale)
        width = self.grid.F * self.grid.L
        self.density_dims = [width, 64, 16]
        self.rgb_dims = [16 + 16, 64, 64, 3]
        self.leaves = [("pos_encoder.grid", (self.grid.n_entries, n_features),
                        1e-4)]
        for name, dims in (("density_mlp", self.density_dims),
                           ("rgb_mlp", self.rgb_dims)):
            for i in range(len(dims) - 1):
                self.leaves.append((f"{name}.weights.{i}", (dims[i], dims[i + 1]),
                                    math.sqrt(6.0 / dims[i])))
        # The field a render cell draws in place of a trained one: the
        # table's entries at U(-16, 16), not at their initial 1e-4.  The
        # bias-free ReLU MLPs scale with their input, so raw densities of a
        # few units make opaque and translucent solids, and every pixel
        # depends on the encoding.
        self.render_leaves = [(n, shape, RENDER_TABLE_BOUND
                               if n == "pos_encoder.grid" else b)
                              for n, shape, b in self.leaves]

    @staticmethod
    def _mlp(params, prefix, n, x, q):
        for i in range(n):
            x = q.linear(x, params[f"{prefix}.weights.{i}"])
            if i < n - 1:
                x = torch.relu(x)
        return x

    def _density_out(self, params, pos, q):
        feat = q.cast(self.grid.encode(params["pos_encoder.grid"], pos, q))
        return self._mlp(params, "density_mlp", 2, feat, q)

    def forward(self, params, pos, dirs, q):
        dens = self._density_out(params, pos, q)
        rgb = self._mlp(params, "rgb_mlp", 3,
                        torch.cat([q.cast(dens), q.cast(sh4(dirs))], -1), q)
        return torch.cat([rgb, dens[:, :1]], dim=-1)

    def density(self, params, pos, q):
        return self._density_out(params, pos, q)[:, 0]

    def mlp_flops(self) -> int:
        """Multiply-adds x 2 of one sample's forward through both MLPs."""
        return 2 * sum(a * b for dims in (self.density_dims, self.rgb_dims)
                       for a, b in zip(dims[:-1], dims[1:]))

    def train_flops(self) -> int:
        """A sample's forward, weight gradients and input gradients (the
        colour MLP's view-direction inputs have none)."""
        d_in = 2 * self.rgb_dims[0] * self.rgb_dims[1] // 2
        return 3 * self.mlp_flops() - d_in


def build(cfg: dict, aabb_scale: float) -> Field:
    return Field(cfg, aabb_scale)

"""Cascaded occupancy grid: lookups and the periodic density-grid update.

Same functions as `jnerf_tpu/ops/occupancy.py` (the reference's
`ray_sampler_header.h` mip/occupancy helpers, `mark_untrained_density_grid.h`,
`ema_grid_samples_nerf.h`, `update_bitfield.h`): the bitfield is a dense
[C, G, G, G] bool tensor in linear (x-major) layout, and the cascade
max-pool writes the 2x-downsampled finer level into the centre octant of
the next one.  The probe-mode refresh's cell choice and max-splat
(`generate_grid_samples_nerf_nonuniform.h`,
`splat_grid_samples_nerf_max_nearest_neighbor.h`) are here too.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from jnerf_tpu_torch.ops.composite import network_to_density

SQRT3 = math.sqrt(3.0)


@dataclass(frozen=True)
class GridConfig:
    grid_size: int = 128
    n_cascades: int = 5
    max_cascade: int = 0  # highest cascade actually used (aabb_scale dependent)
    aabb_min: float = -1.5
    aabb_max: float = 2.5
    min_optical_thickness: float = 0.01
    decay: float = 0.95
    max_steps: int = 1024  # NERF_STEPS()

    @property
    def stepsize(self) -> float:
        # STEPSIZE() == MIN_CONE_STEPSIZE() (`density_grid_sampler.py:103-104`)
        return SQRT3 / self.max_steps

    @property
    def max_cone_stepsize(self) -> float:
        return (
            self.stepsize
            * (1 << (self.n_cascades - 1))
            * self.max_steps
            / self.grid_size
        )

    @property
    def n_cells(self) -> int:
        return self.grid_size ** 3

    @property
    def aabb_diag(self) -> float:
        return self.aabb_max - self.aabb_min


def make_grid_config(aabb_range, grid_size=128, max_steps=1024):
    """Derive cascade counts from the dataset aabb, like
    `density_grid_sampler.py:56-64`."""
    aabb_min, aabb_max = aabb_range
    aabb_scale = aabb_max - aabb_min
    n_cascades = 5
    if aabb_scale > (1 << (n_cascades - 1)):
        n_cascades = int(math.ceil(math.log2(aabb_scale))) + 1
    max_cascade = 0
    while (1 << max_cascade) < aabb_scale:
        max_cascade += 1
    return GridConfig(
        grid_size=int(grid_size),
        n_cascades=n_cascades,
        max_cascade=max_cascade,
        aabb_min=float(aabb_min),
        aabb_max=float(aabb_max),
        max_steps=int(max_steps),
    )


# --------------------------------------------------------------------- mips
def _exp_of(x):
    """frexp-style exponent: e with x = m * 2^e, m in [0.5, 1)."""
    return torch.floor(torch.log2(torch.clamp(x, min=1e-10))).to(torch.int64) + 1


def mip_from_pos_xyz(px, py, pz, cfg: GridConfig):
    """Finest cascade containing the position — `ray_sampler_header.h:58-65`."""
    maxval = torch.maximum(
        torch.abs(px - 0.5),
        torch.maximum(torch.abs(py - 0.5), torch.abs(pz - 0.5)))
    return torch.clamp(_exp_of(maxval) + 1, 0, cfg.n_cascades - 1)


def mip_from_dt_xyz(dt, px, py, pz, cfg: GridConfig):
    """Cascade from step size and position — `ray_sampler_header.h:67-77`."""
    mip = mip_from_pos_xyz(px, py, pz, cfg)
    d = dt * (2 * cfg.grid_size)
    return torch.where(
        d < 1.0, mip,
        torch.clamp(torch.maximum(_exp_of(d), mip), 0, cfg.n_cascades - 1))


def occupancy_at_xyz(bitfield, px, py, pz, mip, cfg: GridConfig):
    """bitfield: [C, G, G, G] bool; p*: [...] components -> bool [...].

    `cascaded_grid_idx_at` + `density_grid_occupied_at`
    (`ray_sampler_header.h:826-848`).
    """
    g = cfg.grid_size
    mip_scale = torch.exp2(-mip.to(torch.float32))

    def cell(p):
        q = (p - 0.5) * mip_scale + 0.5
        return torch.clamp(torch.floor(q * g).to(torch.int64), 0, g - 1)

    ix, iy, iz = cell(px), cell(py), cell(pz)
    flat = ((mip * g + ix) * g + iy) * g + iz
    return bitfield.reshape(-1)[flat]


# ------------------------------------------------------------- grid updates
def _cell_centers_xyz(cfg: GridConfig, device):
    """([G^3], [G^3], [G^3]) cell-index components, x-major flat order."""
    g = cfg.grid_size
    lin = torch.arange(cfg.n_cells, dtype=torch.int64, device=device)
    return lin // (g * g), (lin // g) % g, lin % g


def mark_untrained_grid(poses, focal_lengths, resolution, cfg: GridConfig):
    """-1 for cells seen by zero training cameras, else 0.

    `mark_untrained_density_grid.h:12-47`: project each cell centre into
    every camera frustum with voxel-radius slack.  Returns [C, G, G, G] f32.
    """
    g = cfg.grid_size
    W, H = resolution
    dev = poses.device
    xs, ys, zs = _cell_centers_xyz(cfg, dev)

    def center(comp, level):
        return ((comp.to(torch.float32) + 0.5) / g - 0.5) * (2.0 ** level) + 0.5

    cx = torch.cat([center(xs, l) for l in range(cfg.n_cascades)])
    cy = torch.cat([center(ys, l) for l in range(cfg.n_cascades)])
    cz = torch.cat([center(zs, l) for l in range(cfg.n_cascades)])
    radii = torch.cat([
        torch.full((cfg.n_cells,), 0.5 * SQRT3 * (2.0 ** l) / g, device=dev)
        for l in range(cfg.n_cascades)
    ])

    seen = torch.zeros(cx.shape[0], dtype=torch.bool, device=dev)
    for j in range(poses.shape[0]):
        xform = poses[j]  # [3, 4]
        lx = cx - xform[0, 3]
        ly = cy - xform[1, 3]
        lz = cz - xform[2, 3]
        # dot with camera basis columns
        x = lx * xform[0, 0] + ly * xform[1, 0] + lz * xform[2, 0]
        y = lx * xform[0, 1] + ly * xform[1, 1] + lz * xform[2, 1]
        z = lx * xform[0, 2] + ly * xform[1, 2] + lz * xform[2, 2]
        fx, fy = focal_lengths[j, 0], focal_lengths[j, 1]
        seen |= (
            (z > 0)
            & (torch.abs(x) - radii < z / fx * (0.5 * W))
            & (torch.abs(y) - radii < z / fy * (0.5 * H))
        )
    grid = torch.where(seen, 0.0, -1.0)
    return grid.reshape(cfg.n_cascades, g, g, g)


def _probe_cells(i, step: int, n_samples: int, n_cells: int):
    """The reference's deterministic cell probe sequence for samples ``i``
    [n] (int64): [n, 10] cells, in uint32 arithmetic (every product and
    sum wraps at 2^32) as `generate_grid_samples_nerf_nonuniform.h` and
    the JAX package compute it."""
    m32 = 0xFFFFFFFF
    j = torch.arange(10, dtype=torch.int64, device=i.device)
    base = (i + (step * n_samples & m32)) & m32
    probe = ((base[:, None] * 56924617) & m32) + j[None, :] * 19349663
    return ((probe + 96925573) & m32) % n_cells


def generate_grid_samples(grid, step: int, n_samples: int, thresh: float,
                          cfg: GridConfig, generator=None, level=None,
                          jitter=None):
    """Pick ``n_samples`` cells and a jittered position inside each.

    A random cascade in [0, max_cascade], then up to 10 tries of the
    deterministic probe for a cell whose density exceeds ``thresh`` (the
    last probe if none does), then a uniform jitter inside the cell: the
    JAX package's ``generate_grid_samples`` (probe values read in the
    linear layout).  ``level`` [n] (int) and ``jitter`` [3, n] in [0, 1),
    if given, replace the draws from ``generator``.

    Returns (indices [n] int64 flat into [C*G^3], (x, y, z) [n] world
    position components).
    """
    g = cfg.grid_size
    dev = grid.device
    if level is None:
        level = torch.randint(0, cfg.max_cascade + 1, (n_samples,),
                              generator=generator, device=dev)
    if jitter is None:
        jitter = torch.rand((3, n_samples), generator=generator, device=dev)
    level = level.to(device=dev, dtype=torch.int64)
    i = torch.arange(n_samples, dtype=torch.int64, device=dev)
    idx_cand = _probe_cells(i, int(step), n_samples, cfg.n_cells) \
        + level[:, None] * cfg.n_cells  # [n, 10]
    ok = grid.reshape(-1)[idx_cand] > thresh
    # The first passing probe, else the last one, as the CUDA loop takes.
    first = torch.argmax(ok.to(torch.int32), dim=1)
    pick = torch.where(ok.any(dim=1), first, torch.full_like(first, 9))
    idx = torch.gather(idx_cand, 1, pick[:, None])[:, 0]

    pos_idx = idx % cfg.n_cells
    mip_scale = torch.exp2(level.to(torch.float32))
    comps = (pos_idx // (g * g), (pos_idx // g) % g, pos_idx % g)
    xyz = tuple(((c.to(torch.float32) + jitter[d]) / g - 0.5) * mip_scale + 0.5
                for d, c in enumerate(comps))
    return idx, xyz


def splat_density(indices, raw_density, grid_tmp, cfg: GridConfig):
    """Max-splat the exp-activated densities, scaled by the minimum step
    size, into ``grid_tmp`` at ``indices``: the reference's atomicMax as a
    deterministic scatter-max
    (`splat_grid_samples_nerf_max_nearest_neighbor.h:5-23`)."""
    thickness = network_to_density(raw_density.reshape(-1)) * cfg.stepsize
    flat = grid_tmp.reshape(-1).scatter_reduce(0, indices, thickness,
                                              reduce="amax")
    return flat.reshape(grid_tmp.shape)


def ema_grid_update(grid, grid_tmp, cfg: GridConfig):
    """Decay-max update preserving -1 "untrained" cells
    (`ema_grid_samples_nerf.h:23-25`)."""
    return torch.where(grid < 0, grid, torch.maximum(grid * cfg.decay, grid_tmp))


def density_grid_mean(grid, cfg: GridConfig):
    """Mean of ReLU'd cascade-0 densities (`update_bitfield.py:27-30`)."""
    return torch.mean(torch.relu(grid[0]))


def update_bitfield(grid, mean, cfg: GridConfig, pool_hi=None):
    """Threshold the grid into the occupancy bitfield + cascade max-pool.

    `update_bitfield.h:23-69`: bit = density > min(0.01, mean); then each
    coarser cascade's centre octant ORs in the 2x max-pool of the finer one.
    ``pool_hi`` bounds the pooling chain to the cascades the march can
    probe (None = the full chain).  Returns [C, G, G, G] bool.
    """
    g = cfg.grid_size
    thresh = torch.clamp(mean, max=cfg.min_optical_thickness)
    bits = grid > thresh  # [C, G, G, G]
    if pool_hi is None:
        pool_hi = cfg.n_cascades - 1
    q = g // 4
    levels = [bits[0]]
    for level in range(1, cfg.n_cascades):
        cur = bits[level]
        if level <= pool_hi:
            pooled = levels[-1].reshape(
                g // 2, 2, g // 2, 2, g // 2, 2).any(dim=5).any(dim=3).any(dim=1)
            cur = cur.clone()
            cur[q:3 * q, q:3 * q, q:3 * q] |= pooled
        levels.append(cur)
    return torch.stack(levels, dim=0)

"""Occupancy-guided ray sampling as fixed-budget candidate selection.

Same function as `jnerf_tpu/ops/ray_march.py` (a static-shape rebuild of
the reference's two-pass marcher, `ray_sampler.h:4-114`): every ray gets K
candidate steps along [max(tmin, near), tmax] by the reference's step
policy with a jittered start; occupancy is probed once per segment of
``probe_stride`` candidates; each ray keeps its first S occupied
candidates.  Candidate times come from the closed form of the
``t += calc_dt(t)`` recurrence (`ts_at`), so no sequential scan runs.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import torch

from .occupancy import GridConfig, mip_from_dt_xyz, occupancy_at_xyz


@dataclass(frozen=True)
class MarchConfig:
    grid: GridConfig
    near_distance: float = 0.2
    cone_angle: float = 0.0  # 0 => const_dt
    const_dt: bool = True
    n_candidates: int = 0  # K; 0 => derive from geometry
    # Occupancy is probed every `probe_stride` candidates (segment-centre
    # probe applied to the whole segment); 0 => ~one probe per voxel.
    probe_stride: int = 0

    def __post_init__(self):
        if self.n_candidates == 0:
            object.__setattr__(self, "n_candidates", self.default_candidates())
        if self.probe_stride == 0:
            if self.const_dt:
                voxel = self.grid.aabb_diag / self.grid.grid_size
                stride = max(1, int(round(voxel / self.dt_const)))
                stride = 1 << (stride.bit_length() - 1)  # pow2 for reshapes
            else:
                stride = 1  # cone-angle steps already track voxel scale
            object.__setattr__(self, "probe_stride", min(stride, 8))
        if self.n_candidates % self.probe_stride:
            raise ValueError("n_candidates must be a multiple of probe_stride")

    @property
    def dt_min(self) -> float:
        return self.grid.stepsize

    @property
    def dt_max(self) -> float:
        return self.grid.max_cone_stepsize

    @property
    def dt_const(self) -> float:
        # `calc_dt` with const_dt: MIN_CONE_STEPSIZE() * 0.5
        return self.grid.stepsize * 0.5

    def default_candidates(self) -> int:
        """K large enough to cover the longest aabb chord, capped at the
        reference's NERF_STEPS-bounded march length."""
        diag = self.grid.aabb_diag * math.sqrt(3.0)
        if self.const_dt:
            k = int(math.ceil(diag / self.dt_const))
        else:
            c = self.cone_angle
            t1 = self.dt_min / max(c, 1e-9)
            k_lin = int(math.ceil(min(t1, diag) / self.dt_min))
            k_geo = 0
            if diag > t1:
                k_geo = int(math.ceil(math.log(diag / t1) / math.log1p(c))) + 1
            k = k_lin + k_geo
        k = min(k, 4 * self.grid.max_steps)
        return max(-(-k // 128) * 128, 128)


class RaySamples(NamedTuple):
    """Fixed [R, S] sample batch."""

    positions: torch.Tensor  # [R, S, 3] warped (aabb-relative) positions
    dirs: torch.Tensor       # [R, S, 3] warped directions ((d+1)/2)
    dts: torch.Tensor        # [R, S] step sizes (world units)
    valid: torch.Tensor      # [R, S] bool
    numsteps: torch.Tensor   # [R] int64 = min(count, S)
    truncated: torch.Tensor  # [R] bool: ray had more than S occupied candidates
    count: torch.Tensor      # [R] int64 occupied candidates, capped at NERF_STEPS


def aabb_ray_intersect(rays_o, rays_d, aabb_min: float, aabb_max: float):
    """Slab test (`ray_sampler_header.h:408-470`). Returns (tmin, tmax)."""
    inv = 1.0 / rays_d  # inf for axis-parallel components is fine under IEEE
    t0 = (aabb_min - rays_o) * inv
    t1 = (aabb_max - rays_o) * inv
    tmin = torch.amax(torch.minimum(t0, t1), dim=-1)
    tmax = torch.amin(torch.maximum(t0, t1), dim=-1)
    tmin = torch.clamp(tmin, min=0.0)
    return tmin, torch.where(tmax >= tmin, tmax, tmin)


def dt_at(cfg: MarchConfig, t):
    """Step size at time t (calc_dt closed form)."""
    if cfg.const_dt:
        return torch.full_like(t, cfg.dt_const)
    return torch.clamp(t * cfg.cone_angle, cfg.dt_min, cfg.dt_max)


def ts_at(cfg: MarchConfig, t_start, k):
    """Candidate time at (fractional) step index k [R, X] from start [R]."""
    t0 = t_start[:, None]
    if cfg.const_dt:
        return t0 + k * cfg.dt_const
    c = cfg.cone_angle
    t_lin_end = cfg.dt_min / c  # below this, steps are dt_min
    t_geo_end = cfg.dt_max / c  # above this, steps are dt_max
    n1 = torch.ceil(torch.clamp(t_lin_end - t0, min=0.0) / cfg.dt_min)
    t_at_n1 = t0 + n1 * cfg.dt_min
    log1pc = math.log1p(c)
    n2 = torch.ceil(
        torch.clamp(torch.log(t_geo_end / torch.clamp(t_at_n1, min=1e-10)),
                    min=0.0) / log1pc)
    t_at_n2 = t_at_n1 * torch.exp(n2 * log1pc)
    in1 = k < n1
    in2 = (~in1) & (k < n1 + n2)
    return torch.where(
        in1,
        t0 + k * cfg.dt_min,
        torch.where(
            in2,
            t_at_n1 * torch.exp((k - n1) * log1pc),
            t_at_n2 + (k - n1 - n2) * cfg.dt_max,
        ),
    )


def candidate_ts(cfg: MarchConfig, t_start, n: int):
    """[R] start times -> ([R, n] candidate times, [R, n] step sizes)."""
    k = torch.arange(n, dtype=torch.float32, device=t_start.device)[None, :]
    t = ts_at(cfg, t_start, k)
    return t, dt_at(cfg, t)


def _first_s_indices(occ, s: int):
    """For each row of occ [R, K], indices of the first s True entries.

    Returns (idx [R, s] clamped to K-1, count [R]).  The j-th True entry
    sits at #(cum < j), the left insertion point of j in the row's
    monotone cumsum.
    """
    cum = torch.cumsum(occ.to(torch.int64), dim=1)  # [R, K]
    count = cum[:, -1]
    targets = torch.arange(1, s + 1, dtype=torch.int64, device=occ.device)
    idx = torch.searchsorted(cum, targets.expand(occ.shape[0], s).contiguous())
    return torch.clamp(idx, max=occ.shape[1] - 1), count


def sample_rays(
    cfg: MarchConfig,
    bitfield,
    rays_o,
    rays_d,
    generator: torch.Generator | None,
    n_samples: int,
    u: torch.Tensor | None = None,
) -> RaySamples:
    """March R rays against the occupancy grid into an [R, S] sample batch.

    ``u`` [R] is the start jitter in [0, 1) (`ray_sampler.h:46-48`); when
    None it is drawn from ``generator``.
    """
    g = cfg.grid
    tmin, tmax = aabb_ray_intersect(rays_o, rays_d, g.aabb_min, g.aabb_max)
    tmin = torch.clamp(tmin, min=cfg.near_distance)

    if u is None:
        u = torch.rand(tmin.shape, generator=generator, device=tmin.device)
    dt0 = (
        cfg.dt_const
        if cfg.const_dt
        else torch.clamp(tmin * cfg.cone_angle, cfg.dt_min, cfg.dt_max)
    )
    t_start = tmin + dt0 * u

    ox, oy, oz = rays_o.unbind(-1)
    dx, dy, dz = rays_d.unbind(-1)

    # Strided probing; the stride halves until it divides S rather than
    # falling back to probing every candidate.
    stride = cfg.probe_stride
    while stride > 1 and n_samples % stride:
        stride //= 2
    if stride > 1:
        kp = torch.arange(0, cfg.n_candidates, stride, dtype=torch.float32,
                          device=tmin.device)[None, :]
        tp = 0.5 * (ts_at(cfg, t_start, kp)
                    + ts_at(cfg, t_start, kp + (stride - 1)))  # [R, K/s]
        qx = ox[:, None] + tp * dx[:, None]
        qy = oy[:, None] + tp * dy[:, None]
        qz = oz[:, None] + tp * dz[:, None]
        dtp = dt_at(cfg, ts_at(cfg, t_start, kp))

        def _inp(p):
            return (p >= g.aabb_min) & (p <= g.aabb_max)

        inside_p = _inp(qx) & _inp(qy) & _inp(qz) & (tp <= tmax[:, None])
        mip = mip_from_dt_xyz(dtp, qx, qy, qz, g)
        occ_p = inside_p & occupancy_at_xyz(bitfield, qx, qy, qz, mip, g)

        sp = n_samples // stride
        pidx, pcount = _first_s_indices(occ_p, sp)  # [R, S/s], [R]
        within = torch.arange(stride, device=tmin.device)[None, None, :]
        idx = (pidx[:, :, None] * stride + within).reshape(-1, n_samples)
        count = pcount * stride
    else:
        t, dt = candidate_ts(cfg, t_start, cfg.n_candidates)  # [R, K]
        px = ox[:, None] + t * dx[:, None]
        py = oy[:, None] + t * dy[:, None]
        pz = oz[:, None] + t * dz[:, None]

        def _in(p):
            return (p >= g.aabb_min) & (p <= g.aabb_max)

        inside = _in(px) & _in(py) & _in(pz) & (t <= tmax[:, None])
        mip = mip_from_dt_xyz(dt, px, py, pz, g)
        occ = inside & occupancy_at_xyz(bitfield, px, py, pz, mip, g)
        idx, count = _first_s_indices(occ, n_samples)  # [R, S], [R]

    t_sel = ts_at(cfg, t_start, idx.to(torch.float32))
    dt_sel = dt_at(cfg, t_sel)
    s_range = torch.arange(n_samples, device=tmin.device)[None, :]
    valid = s_range < count[:, None]

    # Exact per-candidate clipping: segment probes judge inside-ness at
    # segment centres only, so trailing candidates of a boundary segment
    # can lie past tmax or outside the aabb.
    valid = valid & (t_sel <= tmax[:, None])

    def _rel(o, d):
        return (o[:, None] + t_sel * d[:, None] - g.aabb_min) / g.aabb_diag

    wx, wy, wz = _rel(ox, dx), _rel(oy, dy), _rel(oz, dz)
    for w in (wx, wy, wz):
        valid = valid & (w >= 0.0) & (w <= 1.0)

    # warp_position = aabb.relative_pos (`ray_sampler_header.h:852-858`).
    def _warp(w):
        return torch.where(valid, torch.clamp(w, 0.0, 1.0),
                           torch.full_like(w, 0.5))

    pos_warp = torch.stack([_warp(wx), _warp(wy), _warp(wz)], dim=-1)
    dir_warp = (rays_d * 0.5 + 0.5)[:, None, :].expand(pos_warp.shape)
    return RaySamples(
        positions=pos_warp,
        dirs=dir_warp,
        dts=torch.where(valid, dt_sel, torch.zeros_like(dt_sel)),
        valid=valid,
        numsteps=torch.clamp(count, max=n_samples),
        truncated=count > n_samples,
        count=torch.clamp(count, max=g.max_steps),
    )

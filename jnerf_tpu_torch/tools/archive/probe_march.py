"""The march split by stage: the counterpart of
`tools/archive/probe_march.py`.

    python3 -m jnerf_tpu_torch.tools.archive.probe_march [full noocc nofirst] [--cpu]

R = 4096 rays of S = 64 samples through ``ops/ray_march.py::sample_rays``
on a 128^3 grid (aabb [0, 1], ``max_steps`` 1024, ``const_dt``) whose
bitfield is a uniform draw of density 0.3, the archive's sizes:

  full     the march as it is
  noocc    every cell occupied: ``occupancy_at_xyz`` (in `ops/occupancy.py`
           and `ops/ray_march.py`) swapped for a constant, no gather
  nofirst  ``_first_s_indices`` swapped for ``arange`` indices

Each swap is put back in a ``finally``, as the archive does.  Each line
gives the section's mean ms (CUDA events) and, from ``torch.profiler``,
its kernel ms and kernel launches a call.
"""

from __future__ import annotations

import argparse

import torch

from jnerf_tpu_torch.tools.archive import common

R, S = 4096, 64
GRID, MAX_STEPS = 128, 1024
DENSITY = 0.3
SECTIONS = ("full", "noocc", "nofirst")
NAMES = {"full": "full sample_rays", "noocc": "no occupancy gather",
         "nofirst": "no first_s (arange idx)"}


def march_config():
    from jnerf_tpu_torch.ops.occupancy import make_grid_config
    from jnerf_tpu_torch.ops.ray_march import MarchConfig

    g = make_grid_config((0.0, 1.0), grid_size=GRID, max_steps=MAX_STEPS)
    return MarchConfig(grid=g, near_distance=0.05, cone_angle=0.0,
                       const_dt=True)


def inputs(cfg, seed: int = 0):
    """numpy (bitfield [C, G, G, G] bool, rays_o [R, 3], rays_d [R, 3],
    start jitter u [R]), the archive's draws made with numpy."""
    g = cfg.grid
    bits = common.uniform((g.n_cascades, GRID, GRID, GRID), seed=seed) \
        < DENSITY
    ro = common.uniform((R, 3), seed=seed + 1) * 0.2 + 0.1
    rd = common.unit_rows(R, seed=seed + 2)
    u = common.uniform((R,), seed=seed + 3)
    return bits, ro, rd, u


def full(cfg, bits, ro, rd, u):
    """The march: RaySamples of ``sample_rays``."""
    from jnerf_tpu_torch.ops import ray_march

    return ray_march.sample_rays(cfg, bits, ro, rd, None, S, u=u)


def _all_occupied(bitfield, px, py, pz, mip, cfg):
    return torch.ones_like(px, dtype=torch.bool)


def _arange_first(occ, s: int):
    idx = torch.arange(s, device=occ.device).expand(occ.shape[0], s)
    return idx, occ.sum(dim=1)


def swapped(name: str):
    """The (module, attribute, stand-in) swaps of a section."""
    from jnerf_tpu_torch.ops import occupancy, ray_march

    if name == "noocc":
        return [(occupancy, "occupancy_at_xyz", _all_occupied),
                (ray_march, "occupancy_at_xyz", _all_occupied)]
    if name == "nofirst":
        return [(ray_march, "_first_s_indices", _arange_first)]
    return []


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    common.section_arg(ap, SECTIONS, SECTIONS)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    from jnerf_tpu_torch.tools.tool_util import kernel_time

    p = common.start(args.cpu, "probe_march")
    cfg = march_config()
    print(f"K={cfg.n_candidates} stride={cfg.probe_stride}", flush=True)
    bits, ro, rd, u = (p.tensor(a) for a in inputs(cfg))

    def section(name):
        def run():
            swaps = swapped(name)
            real = [getattr(mod, attr) for mod, attr, _ in swaps]
            try:
                for mod, attr, fake in swaps:
                    setattr(mod, attr, fake)
                fn = lambda: full(cfg, bits, ro, rd, u)  # noqa: E731
                ms = p.time(fn)
                kms, launches = kernel_time(fn, p.reps, p.device)
                valid = int(fn().valid.sum())
            finally:
                for (mod, attr, _), r in zip(swaps, real):
                    setattr(mod, attr, r)
            dev = ("not measured" if kms is None else
                   f"kernels {kms:.4f} ms in {launches:.0f} launches")
            p.line(NAMES[name], f"{NAMES[name]}: {ms:.2f} ms", ms,
                   f"sample_rays{'' if not swaps else ', ' + name}; {dev}; "
                   f"{valid} valid samples", kernel_ms=kms, launches=launches,
                   valid=valid)
        return run

    common.run_sections(args.sections, SECTIONS,
                        {s: section(s) for s in SECTIONS}, {}, p)
    return p.lines


if __name__ == "__main__":
    main()

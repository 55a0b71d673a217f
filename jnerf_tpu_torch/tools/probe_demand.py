"""Steady-state sample demand and compaction-cap truncation: the port's
counterpart of `tools/probe_demand.py`.

    python3 -m jnerf_tpu_torch.tools.probe_demand [--encoder f8l4] \\
        [--scene hard] [--compact-m 16] [--march-factor 1] [--steps 1024]

The compacted path's background rule (``render_rays_compact``,
``apply_bg_on_truncated=False``, as the reference's ``calc_rgb.h``)
assumes that truncation by the cap M is rare.  This trains ``--steps``
steps, traces 24 more refresh windows (the rays R, samples a ray S,
probe stride and measured samples a step that the next adaptation acts
on), then marches four fresh batches at the steady shapes and prints,
for each, ``demand_stats``: slot occupancy, kept samples, demand, the
share of rays truncated by S and by the cap, the samples the cap drops
and their fraction of the kept ones.  One JSON line each, with the
card's name and power limit.  Runs on the card; without one it raises
unless given ``--cpu``.
"""

from __future__ import annotations

import argparse
import json

import torch

WINDOWS = 24


def demand_stats(valid: torch.Tensor, count: torch.Tensor, S: int,
                 m: int | None) -> dict:
    """Stats of one marched batch: ``valid`` [R, S] bool (a leading run a
    ray), ``count`` [R] the uncapped occupied candidates a ray, ``m`` the
    compaction cap (None: no compaction)."""
    from jnerf_tpu_torch.ops.compact import compact_indices

    kept = valid.to(torch.int64).cumprod(dim=1).sum(dim=1)
    total_kept = int(kept.sum())
    stats = {
        "slot_occupancy": round(float(valid.float().mean()), 4),
        "kept_samples": total_kept,
        "demand_sum": int(count.sum()),
        "rays_S_truncated": round(float((count > S).float().mean()), 4),
        "mean_demand_per_ray": round(float(count.float().mean()), 2),
    }
    if m:
        info = compact_indices(valid, m)
        dropped = max(0, int(info.offsets[-1]) - m)
        stats.update({
            "rays_cap_truncated": round(float(info.truncated.float().mean()),
                                        4),
            "samples_dropped_by_cap": dropped,
            "frac_samples_dropped": round(dropped / max(total_kept, 1), 4),
        })
    return stats


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--encoder", default="f8l4")
    ap.add_argument("--scene", default="hard")
    ap.add_argument("--compact-m", type=int, default=16)
    ap.add_argument("--march-factor", type=int, default=1)
    ap.add_argument("--steps", type=int, default=1024)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    from jnerf_tpu_torch.tools.tool_util import ENCODERS, card, device_for

    device = device_for(args.cpu, "probe_demand")
    from jnerf_tpu_torch.dataset.dataset import rays_from_pixels
    from jnerf_tpu_torch.runner import Runner
    from jnerf_tpu_torch.utils import bench_cfg

    hard = args.scene == "hard"
    cfg = bench_cfg.ngp_synthetic_cfg(
        n_images=16, H=512, W=512, tot_train_steps=1 << 30, scene=args.scene,
        ssaa=2 if hard else 1, n_val=4 if hard else 2,
        **ENCODERS[args.encoder])
    m = (1 << args.compact_m) if args.compact_m else None
    if m:
        cfg.compacted_batch = m
        cfg.march_budget_factor = args.march_factor
    runner = Runner(device=device)
    float(runner.train_range(0, args.steps))

    # Is the (R, S) loop converged or limit-cycling?  Each window's
    # measured demand is what the next adaptation acts on.
    sampler = runner.sampler
    freq = sampler.update_den_freq
    i = args.steps
    trace = []
    for w in range(WINDOWS):
        R, S = sampler.n_rays_per_batch, sampler.n_samples_per_ray
        float(runner.train_range(i, i + freq))
        i += freq
        measured = int(sampler.state["measured_batch_size"])
        trace.append({"R": R, "S": S, "measured_per_step": measured // freq})
        print(f"window {w}: R={R} S={S} "
              f"stride={sampler.march_config.probe_stride} "
              f"measured/step={measured // freq}", flush=True)
    R, S = sampler.n_rays_per_batch, sampler.n_samples_per_ray
    print(f"steady shapes: R={R} S={S} slots={R * S} M={m}", flush=True)
    on = card(device)

    ds = runner.dataset["train"]
    n_pixels = ds.n_images * ds.H * ds.W
    out = []
    for trial in range(4):
        gen = torch.Generator(device).manual_seed(1000 + trial)
        idx = torch.randint(0, n_pixels, (R,), generator=gen, device=device)
        _ids, rays_o, rays_d = rays_from_pixels(
            idx, ds.transforms_gpu, ds.focal_lengths, ds.principal_points,
            ds.W, ds.H)
        s = sampler.sample_fixed(sampler.state, rays_o, rays_d, gen, S)
        stats = demand_stats(s.valid, s.count, S, m)
        out.append(stats)
        print(json.dumps(dict(stats, card=on)), flush=True)
    return {"trace": trace, "trials": out}


if __name__ == "__main__":
    main()

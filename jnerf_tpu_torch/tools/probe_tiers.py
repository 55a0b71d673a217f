"""Where a compacted NGP training step spends its time, tier by tier: the
port's counterpart of `tools/probe_tiers.py`.

    python3 -m jnerf_tpu_torch.tools.probe_tiers [--encoder f8l4] \\
        [--compact-m 16] [--march-factor 1] [--fast-cap 0] [--steps 768]

After ``--steps`` steps of training (512^2 images, the runner's adapted
shapes) it times each tier at the runner's steady shapes:

  full      a refresh window's steps (``Runner.train_step``, no refresh)
  march     pixel draw, rays, ``sample_fixed`` (+ ``compact_indices``)
  model_f   the model's forward on the [M] compacted batch
  model_fb  the model's forward and backward on [M]
  comp_fb   compacted compositing and the loss, forward and backward, on
            fixed model outputs (compacted configs only)
  optim     the Adam update and the EMA step on fixed gradients

`tools/probe_tiers.py` chains its reps in one ``lax.scan`` because each
dispatch through its relay was dear; here the reps run eagerly, as
``Runner.train_step`` runs them (``train_range`` replays a window as a
CUDA graph: ``tools/window_time.py`` times that against the eager loop).
For each tier the final JSON gives the host ms a rep
(the median of 4 runs of 16 reps, each ending in a synchronize; one
refresh window for ``full``) under the tier's name, as
`tools/probe_tiers.py` does, and beside it, in ms a rep: ``event_ms``
(CUDA events around the same reps: the stream's span, idle gaps
included), ``kernel_ms`` (the sum of the CUDA kernels' own times under
``torch.profiler``, one more run of the reps), ``busy`` (kernel_ms over
the host ms: the device's busy share) and ``kernels`` (kernel launches a
rep).  The tiers re-run shared
prologues, so they do not sum to ``full``.  Runs on the card; without
one it raises unless given ``--cpu``, where no device time exists.
"""

from __future__ import annotations

import argparse
import json
import statistics

import torch

# Reps a timing, and timings a tier (the median is kept).
REPS, TRIALS = 16, 4


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--encoder", default="f8l4")
    ap.add_argument("--scene", default="spheres")
    ap.add_argument("--compact-m", type=int, default=16)
    ap.add_argument("--march-factor", type=int, default=1)
    ap.add_argument("--fast-cap", type=int, default=0,
                    help="hashed-level table cap in entries (0 = default; "
                         "524288 = the reference's 2^19)")
    ap.add_argument("--steps", type=int, default=768,
                    help="training steps before timing, to reach steady "
                         "shapes")
    ap.add_argument("--cpu", action="store_true")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from jnerf_tpu_torch.tools.tool_util import (
        ENCODERS, card, device_for, kernel_time, timed,
    )

    device = device_for(args.cpu, "probe_tiers")
    from jnerf_tpu_torch.dataset.dataset import rays_from_pixels
    from jnerf_tpu_torch.ops.compact import (
        compact_indices, render_rays_compact,
    )
    from jnerf_tpu_torch.runner import Runner
    from jnerf_tpu_torch.utils import bench_cfg

    hard = args.scene == "hard"
    cfg = bench_cfg.ngp_synthetic_cfg(
        n_images=16, H=512, W=512, tot_train_steps=1 << 30, scene=args.scene,
        ssaa=2 if hard else 1, n_val=4 if hard else 2,
        **ENCODERS[args.encoder])
    if args.compact_m:
        cfg.compacted_batch = 1 << args.compact_m
        cfg.march_budget_factor = args.march_factor
    if args.fast_cap:
        cfg.hashmap_fast_cap = args.fast_cap
    runner = Runner(device=device)
    float(runner.train_range(0, args.steps))

    sampler, model = runner.sampler, runner.model
    R, S = sampler.n_rays_per_batch, sampler.n_samples_per_ray
    m = sampler.compacted_batch
    compact = m is not None and R * S > m
    ds = runner.dataset["train"]
    n_pixels = ds.n_images * ds.H * ds.W
    params = runner.params
    gen = torch.Generator(device).manual_seed(7)
    results = {"shapes": f"R={R} S={S} M={m if compact else None}"}
    print(results["shapes"], flush=True)
    dev_stats = {k: {} for k in ("event_ms", "kernel_ms", "busy", "kernels")}

    def tier(name, fn, label, reps=REPS, per=1):
        """Time ``fn`` (``per`` steps a call) and print its line."""
        fn()  # first call: allocations, lazy set-up
        runs = [timed(fn, reps, device) for _ in range(TRIALS)]
        host = statistics.median(h for h, _ in runs) / per
        results[name] = host
        ev = [d for _, d in runs if d is not None]
        kms, nk = kernel_time(fn, reps, device)
        dev_stats["event_ms"][name] = (statistics.median(ev) / per
                                       if ev else None)
        dev_stats["kernel_ms"][name] = None if kms is None else kms / per
        dev_stats["busy"][name] = None if kms is None else kms / per / host
        dev_stats["kernels"][name] = None if nk is None else nk / per
        dev = ("device not measured" if kms is None else
               f"events {dev_stats['event_ms'][name]:.3f} ms, kernels "
               f"{kms / per:.3f} ms (busy {kms / per / host:.4f}, "
               f"{nk / per:.0f} launches)")
        print(f"{label}: {host:.3f} ms host; {dev}", flush=True)

    freq = sampler.update_den_freq

    def full():
        for _ in range(freq):
            runner.train_step()

    tier("full", full, f"full ({freq}-step window, per step)",
         reps=max(1, REPS // freq), per=freq)

    def march():
        idx = torch.randint(0, n_pixels, (R,), generator=gen, device=device)
        _ids, ro, rd = rays_from_pixels(idx, ds.transforms_gpu,
                                        ds.focal_lengths, ds.principal_points,
                                        ds.W, ds.H)
        s = sampler.sample_fixed(sampler.state, ro, rd, gen, S)
        return s, (compact_indices(s.valid, m) if compact else None)

    tier("march", march, "march(+compact)")

    # One fixed batch for the model tiers.
    s, info = march()
    if compact:
        pos_c = s.positions.reshape(-1, 3)[info.idx]
        dirs_c = s.dirs.reshape(-1, 3)[info.idx]
        dts_c = torch.where(info.slot_valid, s.dts.reshape(-1)[info.idx],
                            torch.zeros((), device=device))
    else:
        pos_c = s.positions.reshape(-1, 3)
        dirs_c = s.dirs.reshape(-1, 3)

    def model_f():
        with torch.no_grad():
            return model(pos_c, dirs_c)

    tier("model_f", model_f, f"model fwd [{pos_c.shape[0]}]")

    def model_fb():
        loss = model(pos_c, dirs_c).float().pow(2).mean()
        return torch.autograd.grad(loss, params)

    tier("model_fb", model_fb, f"model fwd+bwd [{pos_c.shape[0]}]")

    if compact:
        raw_fix = model_f().detach().requires_grad_(True)
        bg = torch.full((R, 3), 0.3, device=device)
        tgt = torch.full((R, 3), 0.5, device=device)

        def comp_fb():
            rgb, _ = render_rays_compact(raw_fix, dts_c, info, background=bg)
            return torch.autograd.grad(((rgb - tgt) ** 2).mean(), raw_fix)

        tier("comp_fb", comp_fb, "composite+loss fwd+bwd")

    zeros = [torch.zeros_like(p) for p in params]

    def optim():
        for p, z in zip(params, zeros):
            p.grad = z
        runner.optimizer.step()
        if runner.ema is not None:
            runner.ema.step(params, runner.ema_state)

    tier("optim", optim, "adam+ema")

    out = {k: (round(v, 4) if isinstance(v, float) else v)
           for k, v in results.items()}
    out.update({k: {t: (None if v is None else round(v, 4))
                    for t, v in d.items()} for k, d in dev_stats.items()})
    out.update(backend=device.type, card=card(device))
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()

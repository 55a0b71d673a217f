"""Train-step timing of the port: the counterpart of `tools/time_step.py`.

    python3 -m jnerf_tpu_torch.tools.time_step [--steps 20] [--cpu]

At `tools/time_step.py`'s shapes (``ngp_synthetic_cfg(n_images=8, H=256,
W=256)``: 16 levels x 2, 4096 rays, 2^18 target samples, no compaction)
it prints the first grid refresh, the first training step, three trials
of ``--steps`` steady steps, a refresh at step 1000 and one at 1016 (the
steady refresh, every 16 steps), the march alone and the model's forward
and backward alone on the march's samples.  Each timing ends in a
synchronize of the card and gives the host-clock ms and, beside it, the
device ms between CUDA events around the same launches.  Runs on the
card; without one it raises unless given ``--cpu``.
"""

from __future__ import annotations

import argparse

import torch


def log(msg):
    print(msg, flush=True)


def fmt(host_ms, dev_ms):
    dev = "not measured" if dev_ms is None else f"{dev_ms:.3f} ms"
    return f"{host_ms:.3f} ms host, device {dev}"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=20,
                    help="steps in each of the three steady trials")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    from jnerf_tpu_torch.tools.tool_util import card, device_for, timed

    device = device_for(args.cpu, "time_step")
    from jnerf_tpu_torch.dataset.dataset import rays_from_pixels
    from jnerf_tpu_torch.runner import Runner
    from jnerf_tpu_torch.utils import bench_cfg

    bench_cfg.ngp_synthetic_cfg(n_images=8, H=256, W=256)
    runner = Runner(device=device)
    sampler = runner.sampler
    log(f"backend={device.type} card={card(device)} "
        f"K={sampler.march_config.n_candidates} "
        f"stride={sampler.march_config.probe_stride}")
    out = {}

    out["first_refresh"] = timed(lambda: runner._update_grid(0), 1, device)
    occ = float(sampler.state["bitfield"][0].float().mean())
    log(f"first grid update: {fmt(*out['first_refresh'])} occ={occ:.3f}")
    out["first_step"] = timed(runner.train_step, 1, device)
    log(f"first train step: {fmt(*out['first_step'])}")
    R, S = sampler.n_rays_per_batch, sampler.n_samples_per_ray
    for trial in range(3):
        out[f"steady_{trial}"] = host, dev = timed(runner.train_step,
                                                   args.steps, device)
        log(f"steady train step ({R}x{S}): {fmt(host, dev)} -> "
            f"{1e3 / host:.1f} it/s")

    n_u, n_n = sampler.grid_update_counts(1000)
    out["refresh_1000"] = timed(lambda: runner._update_grid(1000), 1, device)
    log(f"grid update ({n_u}+{n_n}): {fmt(*out['refresh_1000'])}")
    out["refresh_steady"] = timed(lambda: runner._update_grid(1016), 1, device)
    log(f"grid update steady: {fmt(*out['refresh_steady'])} "
        "(every 16 steps)")

    ds = runner.dataset["train"]
    gen = torch.Generator(device).manual_seed(0)
    idx = torch.randint(0, ds.n_images * ds.H * ds.W, (R,), generator=gen,
                        device=device)
    _ids, rays_o, rays_d = rays_from_pixels(
        idx, ds.transforms_gpu, ds.focal_lengths, ds.principal_points, ds.W,
        ds.H)
    box = {}

    def march():
        box["s"] = sampler.sample_fixed(sampler.state, rays_o, rays_d, gen, S)

    march()
    out["march"] = timed(march, 10, device)
    log(f"march: {fmt(*out['march'])}")

    pos = box["s"].positions.reshape(-1, 3)
    dirs = box["s"].dirs.reshape(-1, 3)
    params = [p for p in runner.model.parameters() if p.requires_grad]

    def fwd_bwd():
        loss = runner.model(pos, dirs).float().pow(2).mean()
        torch.autograd.grad(loss, params)

    fwd_bwd()
    out["model_fwd_bwd"] = timed(fwd_bwd, 10, device)
    log(f"model fwd+bwd {pos.shape[0]}: {fmt(*out['model_fwd_bwd'])}")
    return out


if __name__ == "__main__":
    main()

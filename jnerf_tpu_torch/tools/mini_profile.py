"""Where a training step of a mini-project spends its device time.

    python -m jnerf_tpu_torch.tools.mini_profile --project pixelnerf
    python -m jnerf_tpu_torch.tools.mini_profile --project recursive_nerf

Builds the project's model at its script's default widths on the
script's analytic scene, takes ``--warmup`` steps, then ``--steps`` more
under ``torch.profiler`` (Recursive-NeRF at level 3, after a k-means
split of its anchors).  Prints the host time a step (host clock, each
step ending in a read of its loss), the device's busy share (the sum of
the CUDA kernels' times over the wall; the profiler's own host cost
lengthens the wall), the card's name and power limit,
and the operators that take the most device time.  Needs a card unless
given ``--device cpu``, where no device time exists.
"""

from __future__ import annotations

import argparse
import subprocess
import time

import numpy as np
import torch

from jnerf_tpu_torch.optims import AdamOptimizer


def _card(device) -> str:
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def pixelnerf_step(device):
    """A closure taking one pixelNeRF training step at the script's
    defaults; returns its loss."""
    from jnerf_tpu_torch.projects.pixelnerf import main as pix

    model = pix.build_model(device)
    images, poses, focal = pix.make_synthetic()
    rays = [torch.as_tensor(a, device=device)
            for a in pix.camera_rays(images[3:], poses[3:], focal)]
    refs = torch.as_tensor(images[:3], device=device)
    opt = AdamOptimizer(model.parameters(), pix.LR)
    draws = pix.uniform_draws(pix.N_SAMPLES, device)
    rng = np.random.default_rng(0)

    def step():
        sel = torch.as_tensor(rng.integers(0, len(rays[0]), 2048),
                              device=device)
        opt.zero_grad(set_to_none=True)
        loss = pix.loss_fn(model, refs, poses[:3], focal,
                           *(r[sel] for r in rays), next(draws))
        loss.backward()
        opt.step()
        return float(loss.detach())

    return step


def recursive_nerf_step(device):
    """A closure taking one Recursive-NeRF training step at level 3 at the
    script's defaults; returns its MSE."""
    from jnerf_tpu_torch.models.networks.recursive_nerf import split_anchors
    from jnerf_tpu_torch.projects.pixelnerf.main import (
        camera_rays, make_synthetic, uniform_draws,
    )
    from jnerf_tpu_torch.projects.recursive_nerf import main as rec

    model = rec.build_model(device)
    images, poses, focal = make_synthetic(n_images=16, H=80, W=80)
    rays = [torch.as_tensor(a, device=device)
            for a in camera_rays(images, poses, focal)]
    opt = AdamOptimizer(model.parameters(), 5e-4)
    draws = uniform_draws(64, device)
    rng = np.random.default_rng(0)
    sel = torch.as_tensor(rng.integers(0, len(rays[0]), rec.SPLIT_RAYS),
                          device=device)
    with torch.no_grad():
        _, unc, pts = rec.render(model, rays[0][sel], rays[1][sel],
                                 next(draws), 3)
    split_anchors(model, pts, unc.reshape(-1))

    def step():
        sel = torch.as_tensor(rng.integers(0, len(rays[0]), 1024),
                              device=device)
        opt.zero_grad(set_to_none=True)
        loss, mse = rec.loss_fn(model, *(r[sel] for r in rays), next(draws),
                                3)
        loss.backward()
        opt.step()
        return float(mse.detach())

    return step


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--project", choices=("pixelnerf", "recursive_nerf"),
                        default="pixelnerf")
    parser.add_argument("--warmup", type=int, default=3)
    parser.add_argument("--steps", type=int, default=5)
    parser.add_argument("--rows", type=int, default=12)
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    step = {"pixelnerf": pixelnerf_step,
            "recursive_nerf": recursive_nerf_step}[args.project](device)
    for _ in range(args.warmup):
        step()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step()
        wall = time.perf_counter() - t0
    ms = wall * 1e3 / args.steps
    busy = "device time not measured on the CPU"
    if device.type == "cuda":
        cuda = torch.autograd.DeviceType.CUDA
        # Kernels only: a range annotation (Optimizer.step) also shows on
        # the device's timeline, as a span.
        busy_ms = sum(e.time_range.elapsed_us() for e in prof.events()
                      if e.device_type == cuda
                      and not e.is_user_annotation) / 1e3
        busy = (f"device busy {busy_ms / args.steps:.3f} ms a step = "
                f"{busy_ms / (wall * 1e3):.4f} of the wall")
    print(f"{args.project}: {ms:.3f} ms a step (host clock, {args.steps} "
          f"steps), {busy}; on {_card(device)}")
    print(prof.key_averages().table(sort_by="self_device_time_total",
                                    row_limit=args.rows,
                                    max_name_column_width=70))


if __name__ == "__main__":
    main()

"""Recursive-NeRF mini-project: staged LOD training with anchor splitting.

    python -m jnerf_tpu_torch.projects.recursive_nerf.main --synthetic \\
        [--n-iters 3000] [--device cuda|cpu]

Counterpart of `projects/recursive_nerf/main.py`, with its flags plus
``--device`` (``cuda``, the default, refuses to run without a card):
stratified 64-sample rendering, deeper levels unlocked at
``--step1/2/3``, each stage ended by a k-means split of the anchors over
the points of high uncertainty, and the uncertainty supervised against
each ray's (detached) error at a weight of 0.1.  Batch rows are drawn on
the host with ``np.random.default_rng(0)``, as the JAX script draws them;
the stratified jitter of every step and split comes, in that order, from
a ``draws`` iterator, which a test fills with the JAX keys' draws.  It
prints the JAX script's ``iter`` and ``stage -> level`` lines and saves
``recursive_nerf.pkl`` in the JAX tree's layout (`utils/convert.py`).

``--datadir`` reads a blender scene as the JAX script does, identity poses
included: every ray then starts at the origin (ROADMAP §3 records this).
"""

from __future__ import annotations

import argparse
import os
import pickle
import time

import numpy as np
import torch

from jnerf_tpu_torch.models.networks.recursive_nerf import (
    RecursiveNeRF, split_anchors,
)
from jnerf_tpu_torch.ops.linspace import linspace
from jnerf_tpu_torch.optims import AdamOptimizer
from jnerf_tpu_torch.projects.pixelnerf.main import (
    camera_rays, make_synthetic, require_device, uniform_draws,
)
from jnerf_tpu_torch.utils.convert import state_dict_to_jax_params

NEAR, FAR = 2.0, 6.0
SEED = 0  # the JAX script's PRNGKey
SPLIT_RAYS = 2048  # rays rendered for a stage transition's k-means


def build_model(device="cuda", head_num=8, width=256, threshold=3e-2,
                seed=SEED) -> RecursiveNeRF:
    """A RecursiveNeRF initialised from a CPU generator seeded ``seed``,
    then moved to ``device``."""
    device = require_device(device)
    gen = torch.Generator().manual_seed(seed)
    return RecursiveNeRF(head_num=head_num, W=width, threshold=threshold,
                         generator=gen).to(device)


def render(model, ro, rd, u, max_level, n_samples=64):
    """(rgb [R, 3], uncertainty [R, S], points [R * S, 3]) of rays with the
    stratified jitter ``u`` [S] (uniform draws)."""
    S = n_samples
    z = NEAR + (FAR - NEAR) * (linspace(0, 1, S + 1, device=ro.device)[:-1]
                               + u / S)
    pts = ro[:, None, :] + rd[:, None, :] * z[None, :, None]
    views = torch.repeat_interleave(rd, S, dim=0)
    raw, uncert = model(pts.reshape(-1, 3), views, max_level=max_level)
    raw = raw.reshape(-1, S, 4)
    uncert = uncert.reshape(-1, S)
    delta = torch.cat([torch.diff(z), z.new_full((1,), 1e10)])
    delta = delta[None, :] * torch.sqrt((rd * rd).sum(-1, keepdim=True))
    alpha = 1 - torch.exp(-torch.relu(raw[..., 3]) * delta)
    trans = torch.cumprod(torch.cat(
        [torch.ones_like(alpha[:, :1]), 1 - alpha + 1e-7], -1), -1)[:, :-1]
    w = alpha * trans
    rgb = torch.sum(w[..., None] * torch.sigmoid(raw[..., :3]), -2)
    return rgb, uncert, pts.reshape(-1, 3)


def loss_fn(model, ro, rd, target, u, max_level, n_samples=64):
    """(mse + 0.1 * uncertainty loss, mse): each sample's uncertainty is
    pulled toward its ray's detached error."""
    rgb, uncert, _ = render(model, ro, rd, u, max_level, n_samples)
    err = torch.mean((rgb - target) ** 2, dim=-1)
    mse = err.mean()
    u_loss = torch.mean((uncert - err.detach()[:, None]) ** 2)
    return mse + 0.1 * u_loss, mse


def train(model, images, poses, focal, n_iters=3000, step1=500, step2=1000,
          step3=1500, n_rand=1024, n_samples=64, lrate=5e-4, draws=None):
    """Staged training of ``model`` on every view.  Prints the JAX script's
    lines and returns ``{"mse", "stages", "transitions"}``: ``stages``
    holds (level, steps, host seconds) a stage (each step reads its MSE
    back, which waits for the device), ``transitions`` the levels entered
    by the anchor splits."""
    device = next(model.parameters()).device
    rays = [torch.as_tensor(a, device=device)
            for a in camera_rays(images, poses, focal)]
    n_rays = rays[0].shape[0]
    opt = AdamOptimizer(model.parameters(), lrate)
    draws = uniform_draws(n_samples, device, SEED) if draws is None else draws

    rng = np.random.default_rng(0)
    stages = [(0, step1), (1, step2), (2, step3), (model.max_depth, n_iters)]
    i = 0
    mses, stage_times, transitions = [], [], []
    for lvl, until in stages:
        level = min(lvl, model.max_depth)
        t0, i0 = time.perf_counter(), i
        while i < until:
            sel = torch.as_tensor(rng.integers(0, n_rays, n_rand),
                                  device=device)
            ro, rd, target = (r[sel] for r in rays)
            opt.zero_grad(set_to_none=True)
            loss, mse = loss_fn(model, ro, rd, target,
                                next(draws).to(device), level, n_samples)
            loss.backward()
            opt.step()
            mses.append(float(mse.detach()))
            if i % 100 == 0:
                print(f"iter {i} (level {lvl}): mse={np.mean(mses[-50:]):.5f}",
                      flush=True)
            i += 1
        stage_times.append((lvl, i - i0, time.perf_counter() - t0))
        if until < n_iters:
            # Stage transition: split anchors by k-means on uncertain points.
            sel = torch.as_tensor(rng.integers(0, n_rays, SPLIT_RAYS),
                                  device=device)
            with torch.no_grad():
                _rgb, uncert, pts = render(model, rays[0][sel], rays[1][sel],
                                           next(draws).to(device), level,
                                           n_samples)
            split_anchors(model, pts, uncert.reshape(-1))
            transitions.append(lvl + 1)
            print(f"stage -> level {lvl + 1}: anchors updated", flush=True)
    return {"mse": mses, "stages": stage_times, "transitions": transitions}


def save(model, out) -> str:
    """Write ``recursive_nerf.pkl`` (the JAX tree, numpy leaves) into
    ``out``."""
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, "recursive_nerf.pkl")
    with open(path, "wb") as f:
        pickle.dump(state_dict_to_jax_params(model.state_dict()), f)
    print("saved", path)
    return path


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--datadir", default="")
    parser.add_argument("--synthetic", action="store_true")
    parser.add_argument("--head-num", type=int, default=8)
    parser.add_argument("--n-iters", type=int, default=3000)
    parser.add_argument("--step1", type=int, default=500)
    parser.add_argument("--step2", type=int, default=1000)
    parser.add_argument("--step3", type=int, default=1500)
    parser.add_argument("--n-rand", type=int, default=1024)
    parser.add_argument("--n-samples", type=int, default=64)
    parser.add_argument("--lrate", type=float, default=5e-4)
    parser.add_argument("--threshold", type=float, default=3e-2)
    parser.add_argument("--width", type=int, default=256)
    parser.add_argument("--out", default="./logs/recursive_nerf")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args(argv)

    model = build_model(args.device, args.head_num, args.width,
                        args.threshold)
    if args.synthetic or not args.datadir:
        images, poses, focal = make_synthetic(n_images=16, H=80, W=80)
    else:
        from jnerf_tpu_torch.dataset.mip_dataset import Blender

        ds = Blender(args.datadir, batch_size=args.n_rand, mode="train",
                     device="cpu")
        images = np.stack([im[..., :3] for im in ds._images])
        # The JAX script's poses, kept so that one invocation does the
        # same in both packages (ROADMAP §3).
        poses = np.stack([np.eye(4, dtype=np.float32)] * ds.n_images)
        focal = ds.focal
    hist = train(model, images, poses, focal, args.n_iters, args.step1,
                 args.step2, args.step3, args.n_rand, args.n_samples,
                 args.lrate)
    save(model, args.out)
    return model, hist


if __name__ == "__main__":
    main()

"""The step by component: the counterpart of `tools/archive/profile_step.py`.

    python3 -m jnerf_tpu_torch.tools.archive.profile_step [--rays 4096] [--samples 64] [--cpu]

The bench config at 8 images of 256^2 (16 levels x 2), a grid state whose
bitfield is a uniform draw of density 0.08 (numpy), and the first
``--rays`` rays of a pixel draw.  Lines, as the archive's:

  dispatch noop    ``x + 1`` on [8, 128]: the card's time and the host's
                   time a call (the launch path)
  march R x S      ``sample_fixed``
  model fwd        the model's forward on the march's R*S samples
  model fwd+bwd    forward + backward of mean(out^2) in the parameters
  full train step  the median host time of 10 steps, each ending in a read
                   of its loss (the archive's per-step
                   ``block_until_ready``), at R x S
  grid update      one refresh with the counts of step 1000, timed once
                   after a first one (host clock to a synchronize)
"""

from __future__ import annotations

import argparse
import statistics
import time

import torch

from jnerf_tpu_torch.tools.archive import common

N_IMAGES = 8
OCCUPANCY = 0.08
STEP_REPS = 10


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--rays", type=int, default=4096)
    ap.add_argument("--samples", type=int, default=64)
    args = ap.parse_args(argv)
    from jnerf_tpu_torch.dataset.dataset import rays_from_pixels
    from jnerf_tpu_torch.tools.tool_util import timed

    p = common.start(args.cpu, "profile_step")
    R, S = args.rays, args.samples
    runner = common.bench_runner(p, "f2l16", N_IMAGES, R, S,
                                 refresh_step=None)
    sampler, model = runner.sampler, runner.model
    dev = p.device

    x = torch.ones((8, 128), device=dev)
    host, evt = timed(lambda: x + 1, 100, dev)
    p.line("dispatch noop", f"dispatch noop:      {host:8.3f} ms", host,
           f"x + 1: host ms a call; card "
           f"{'not measured' if evt is None else f'{evt:.4f} ms'}",
           device_ms=evt, clock="host")

    state = dict(sampler.state)
    state["bitfield"] = p.tensor(common.uniform(
        tuple(state["bitfield"].shape)) < OCCUPANCY)
    ds = runner.dataset["train"]
    idx = p.tensor(common.uniform_idx(R, ds.n_images * ds.H * ds.W)).long()
    _ids, rays_o, rays_d = rays_from_pixels(
        idx, ds.transforms_gpu, ds.focal_lengths, ds.principal_points, ds.W,
        ds.H)
    gen = torch.Generator(dev).manual_seed(0)

    def march():
        return sampler.sample_fixed(state, rays_o, rays_d, gen, S)

    ms = p.time(march)
    p.line("march", f"march {R}x{S}:   {ms:8.2f} ms", ms, "sample_fixed")
    samples = march()
    n = R * S
    pos = samples.positions.reshape(n, 3)
    dirs = samples.dirs.reshape(n, 3)

    def fwd():
        with torch.no_grad():
            return model(pos, dirs)

    def fwd_bwd():
        out = model(pos, dirs).float()
        return torch.autograd.grad((out * out).mean(), runner.params)

    ms = p.time(fwd)
    p.line("model fwd", f"model fwd {n}:  {ms:8.2f} ms", ms,
           "NGPNetworks forward")
    ms = p.time(fwd_bwd)
    p.line("model fwd+bwd", f"model fwd+bwd:      {ms:8.2f} ms", ms,
           "forward + autograd")

    sampler.state = state
    float(runner.train_step())
    ts = []
    for _ in range(STEP_REPS):
        t0 = time.perf_counter()
        float(runner.train_step())
        ts.append((time.perf_counter() - t0) * 1e3)
    ms = statistics.median(ts)
    p.line("full train step", f"full train step:    {ms:8.2f} ms", ms,
           "Runner.train_step, median host ms to the loss's read",
           clock="host")

    n_u, n_n = sampler.grid_update_counts(1000)

    def refresh():
        sampler.state = sampler.update_density_grid_fn(
            sampler.state, False, runner.generator, n_uniform=n_u,
            n_nonuniform=n_n)

    refresh()
    host, _ = timed(refresh, 1, dev)
    p.line("grid update", f"grid update:        {host:8.2f} ms (every 16 "
           "steps)", host, f"update_density_grid_fn "
           f"({sampler.grid_update_mode}), host ms to a synchronize",
           clock="host")
    print("backend:", dev.type, flush=True)
    return p.lines


if __name__ == "__main__":
    main()

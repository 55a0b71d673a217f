"""The system under test: the port's `Runner`, driven through its entry
points.

This is the one module of the benchmark that imports the program
(`jnerf_tpu_torch`).  It builds a runner from a configuration file's
``cfg`` over the benchmark's scene, hands it the weights the benchmark
made, seeds its draws, and drives the two kinds of traffic:

- ``train``: ``Runner.train_range`` over the first steps (what the check
  compares), the warm-up, then refresh windows of ``update_den_freq`` steps
  for the measured window;
- ``render``: a field and an occupancy bitfield that the benchmark made,
  loaded as a checkpoint's are, then a closed loop of one client sending
  ``Runner.render_img_with_pose`` requests, one whole test view each,
  cycling through the test poses.

What the program produced and the check judges is kept in plain tensors
and arrays; the runner itself is dropped by ``release`` before the
reference runs.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from jnerf_tpu_torch.runner import Runner
from jnerf_tpu_torch.utils.config import Config, get_cfg


def build_runner(cfg: dict, scene_dir: str, seed: int, device) -> Runner:
    """A runner of ``cfg`` with its datasets at ``scene_dir``."""
    c = get_cfg()
    c.clear()
    for k, v in cfg.items():
        c[k] = Config._wrap(v)
    c.dataset.train.root_dir = scene_dir
    c.seed = seed
    return Runner(device=device)


def set_weights(runner: Runner, params: dict):
    """Copy the benchmark's weights into the runner's model (and the EMA's
    shadow); the names and shapes must be the model's own."""
    named = dict(runner.model.named_parameters())
    if set(named) != set(params):
        raise ValueError(f"the model's parameters {sorted(named)} are not "
                         f"the configuration's {sorted(params)}")
    with torch.no_grad():
        for name, p in named.items():
            if p.shape != params[name].shape:
                raise ValueError(f"{name}: {tuple(p.shape)} in the model, "
                                 f"{tuple(params[name].shape)} made")
            p.copy_(params[name])
        if runner.ema_state is not None:
            for p, s in zip(runner.params, runner.ema_state["shadow"]):
                s.copy_(p)


def set_occupancy(runner: Runner, bits):
    """Load the occupancy bitfield ``bits`` [C, G, G, G] into the runner's
    sampler, as a checkpoint's sampler state is loaded (the density grid
    reads 1 in the occupied cells)."""
    have = tuple(runner.sampler.state["bitfield"].shape)
    if tuple(bits.shape) != have:
        raise ValueError(f"bitfield {tuple(bits.shape)} made, {have} in the "
                         "program")
    b = bits.cpu().numpy()
    runner.sampler.load_state_dict({"density_grid": b.astype(np.float32),
                                    "bitfield": b,
                                    "mean": np.float32(b[0].mean()),
                                    "ema_step": 0})


def batch_shape(runner: Runner) -> tuple:
    """(rays, samples a ray) of the runner's next training step."""
    return (runner.sampler.n_rays_per_batch, runner.sampler.n_samples_per_ray)


def leaf_norms(runner: Runner, tensors_of) -> dict:
    """{parameter name: float64 norm of ``tensors_of(param)``}."""
    return {name: float(torch.linalg.vector_norm(tensors_of(p).double()))
            for name, p in runner.model.named_parameters()}


def first_steps(runner: Runner, params0: dict, n: int, b1: float) -> dict:
    """Train steps [0, n) through ``train_range``; returns the judged
    outputs: each step's main loss, each leaf's norm of the first gradient
    (Adam's first moment after one step over 1 - b1) and of its change
    after ``n`` steps."""
    runner.train_range(0, 1)
    losses = [float(runner.window_losses[0])]
    state = runner.optimizer.state
    # A leaf the optimizer holds no moment of got no gradient: it reads 0.
    grad = leaf_norms(runner, lambda p: state[p]["mu"] / (1.0 - b1)
                      if "mu" in state.get(p, {}) else torch.zeros(()))
    runner.train_range(1, n)
    losses += [float(x) for x in runner.window_losses]
    named = dict(runner.model.named_parameters())
    change = {k: float(torch.linalg.vector_norm(
        (named[k].detach() - params0[k]).double())) for k in named}
    return {"losses": losses, "grad": grad, "change": change}


def train_window(runner: Runner, start: int, seconds: float, trace_windows=0):
    """Refresh windows from step ``start`` for ``seconds`` of the host
    clock (or ``trace_windows`` windows when given), from a synchronize to
    a synchronize.  Returns (steps, seconds, the windows' losses, the
    demand each window counted, steps a window, the set of batch shapes
    that the windows ran and left)."""
    freq = runner.sampler.update_den_freq
    losses, demand, shapes = [], [], set()
    dev = runner.device
    sync(dev)
    t0 = time.perf_counter()
    i = start
    while (len(losses) < trace_windows if trace_windows
           else time.perf_counter() - t0 < seconds):
        shapes.add(batch_shape(runner))
        runner.train_range(i, i + freq)
        losses.append(runner.window_losses.clone())
        if trace_windows:
            demand.append(runner.sampler.state["measured_batch_size"].clone())
        i += freq
    sync(dev)
    shapes.add(batch_shape(runner))
    return (i - start, time.perf_counter() - t0, torch.cat(losses), demand,
            freq, shapes)


def render_window(runner: Runner, poses, u_table, seconds: float,
                  max_views=0):
    """A closed loop of one client: request k renders test pose k mod n
    with start jitter ``u_table[k mod n]`` and waits for the pixels on
    the host.  Runs while the host clock is under ``seconds`` (or for
    ``max_views`` requests when given).  Returns (latencies [s], images,
    window seconds)."""
    sync(runner.device)
    t0 = time.perf_counter()
    lat, imgs = [], []
    while (len(lat) < max_views if max_views
           else time.perf_counter() - t0 < seconds):
        k = len(lat) % len(poses)
        t = time.perf_counter()
        imgs.append(runner.render_img_with_pose(poses[k], u=u_table[k]))
        lat.append(time.perf_counter() - t)
    return lat, imgs, time.perf_counter() - t0


def release():
    """Free what the program's config still holds of a runner that the
    caller has dropped, and the memory the runner cached."""
    get_cfg().clear()
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)

"""Eager refresh windows against CUDA graph windows on an NGP training
run: host ms, kernel ms, busy share and kernel launches a step, and peak
memory, for each path.

    python3 -m jnerf_tpu_torch.tools.window_time [--encoder f8l4] \\
        [--compact-m 17] [--march-factor 2] [--fast-cap 524288] \\
        [--steps 768] [--windows 8] [--cpu]

Each path gets a fresh runner from one seed (the bench's config: 16
spheres images of 512^2), eager first (``Runner.train_range_eager``: every
window a loop of ``train_step``), then graph (``Runner.train_range``: a
CUDA graph replay a window after each shape's warm-up and capture).  It
trains ``--steps`` steps to reach the adapted shapes, then ``--windows``
refresh windows are timed on the host clock, from a synchronize to a
synchronize, refreshes included, and ``--windows`` more run under
``torch.profiler`` for the sum of the CUDA kernels' own times and their
count (``tool_util.kernel_time``).  busy = kernel ms over host ms.  Peak
memory is ``torch.cuda.max_memory_allocated`` from the runner's build to
its end (the graph path's captures allocate what its replays use), less
what was allocated before the build (``base_mib``).  The
two paths train the same bits (``chip_smoke.py`` phase 22 holds them to
it); each path's last loss is printed.  On the CPU (``--cpu``) only the
eager path runs, since graphs need the card, and no device time exists.
"""

from __future__ import annotations

import argparse
import gc
import json
import time

import torch


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--encoder", default="f8l4")
    ap.add_argument("--compact-m", type=int, default=17)
    ap.add_argument("--march-factor", type=int, default=2)
    ap.add_argument("--fast-cap", type=int, default=1 << 19,
                    help="hashed-level table cap in entries (0 = default)")
    ap.add_argument("--steps", type=int, default=768,
                    help="training steps before timing, to reach steady "
                         "shapes (a multiple of the refresh interval)")
    ap.add_argument("--windows", type=int, default=8,
                    help="refresh windows timed, and as many profiled")
    ap.add_argument("--cpu", action="store_true")
    return ap.parse_args(argv)


def run_path(args, device, graph: bool) -> dict:
    """Train, time and profile one path; returns its line."""
    from jnerf_tpu_torch.runner import Runner
    from jnerf_tpu_torch.tools.tool_util import ENCODERS, kernel_time, sync
    from jnerf_tpu_torch.utils import bench_cfg

    cfg = bench_cfg.ngp_synthetic_cfg(n_images=16, H=512, W=512,
                                      tot_train_steps=1 << 30,
                                      **ENCODERS[args.encoder])
    if args.compact_m:
        cfg.compacted_batch = 1 << args.compact_m
        cfg.march_budget_factor = args.march_factor
    if args.fast_cap:
        cfg.hashmap_fast_cap = args.fast_cap
    cuda = device.type == "cuda"
    base = 0
    if cuda:
        gc.collect()
        torch.cuda.empty_cache()
        sync(device)
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
    runner = Runner(device=device)
    train = runner.train_range if graph else runner.train_range_eager
    freq = runner.sampler.update_den_freq
    at = -(-args.steps // freq) * freq
    train(0, at)
    shapes = (runner.sampler.n_rays_per_batch,
              runner.sampler.n_samples_per_ray)
    steps = args.windows * freq

    def windows():
        nonlocal at
        loss = train(at, at + steps)
        at += steps
        return loss

    sync(device)
    t0 = time.perf_counter()
    windows()
    sync(device)
    host_ms = (time.perf_counter() - t0) * 1e3 / steps
    kms, nk = kernel_time(windows, 1, device)
    loss = float(windows())
    mib = 1 / 2**20
    out = {
        "path": "graph" if graph else "eager",
        "shapes": f"R={shapes[0]} S={shapes[1]}",
        "shapes_end": f"R={runner.sampler.n_rays_per_batch} "
                      f"S={runner.sampler.n_samples_per_ray}",
        "host_ms": host_ms, "steps_per_s": 1e3 / host_ms,
        "kernel_ms": None if kms is None else kms / steps,
        "busy": None if kms is None else kms / steps / host_ms,
        "launches": None if nk is None else nk / steps,
        "peak_mib": ((torch.cuda.max_memory_allocated(device) - base) * mib
                     if cuda else None),
        "base_mib": base * mib if cuda else None,
        "reserved_mib": (torch.cuda.memory_reserved(device) * mib
                         if cuda else None),
        "graphs": len(runner.windows.cache),
        "loss": loss, "steps": at,
    }
    del runner
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return out


def main(argv=None):
    args = parse_args(argv)
    from jnerf_tpu_torch.tools.tool_util import card, device_for

    device = device_for(args.cpu, "window_time")
    out = {}
    for graph in ((False, True) if device.type == "cuda" else (False,)):
        line = run_path(args, device, graph)
        out[line["path"]] = line
        dev = ("device not measured" if line["kernel_ms"] is None else
               f"kernels {line['kernel_ms']:.4f} ms (busy "
               f"{line['busy']:.4f}, {line['launches']:.1f} launches), peak "
               f"{line['peak_mib']:.1f} MiB, reserved "
               f"{line['reserved_mib']:.1f} MiB")
        print(f"{line['path']} ({line['shapes']}): {line['host_ms']:.4f} ms "
              f"host a step ({line['steps_per_s']:.2f} steps/s); {dev}; "
              f"{line['graphs']} graphs; loss {line['loss']:.8f} at step "
              f"{line['steps']}", flush=True)
    out.update(backend=device.type, card=card(device))
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()

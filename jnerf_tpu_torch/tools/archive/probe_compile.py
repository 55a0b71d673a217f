"""What the multi-rank dry run's start-up costs: the counterpart of
`tools/archive/probe_compile.py`.

    python3 -m jnerf_tpu_torch.tools.archive.probe_compile [--no-compact] \\
        [--nerf-steps N] [--levels N] [--features N] [--single-device] \\
        [--skip-grid] [--step-only] [--cpu]

The archive timed XLA's trace, lower and compile of the dry run's two
programs (the grid update and the train step) on an 8-device CPU mesh.
The port compiles no step: its kernels are built once by ``nvcc``
(`ops/cuda_lib.py`) and its steps run eagerly under a mesh.  So this times
what the start-up of `parallel/dryrun.py` costs instead, at the archive's
runner (2 images of 64^2, 4096 rays, 2^18 target samples, a 128^3 grid,
``--levels`` x ``--features``, log2 19, compacted with a x2 march budget
unless ``--no-compact``):

  [build]        each CUDA source's ``nvcc`` build into a fresh build
                 directory under a temporary directory, all started
                 together, and the lookup of the built libraries in the
                 checkout's (warm) build directory; not on the CPU
  [spawn]        from the spawn of ``RANKS`` ranks (gloo, sharing the
                 card) to each rank's entry into its case
  [setup]        the runner's construction in each rank
  [grid_update]  the first grid refresh (at step 300); none with
                 ``--skip-grid`` or ``--step-only``
  [train_step]   the first training step, then its loss

``--single-device`` runs the case in this process, with no mesh.  Each
lower/compile line of the archive prints that it has no counterpart.
"""

from __future__ import annotations

import argparse
import tempfile
import time
from pathlib import Path

import torch

from jnerf_tpu_torch.tools.archive import common

RANKS = 2
CFG = dict(n_images=2, H=64, W=64, n_rays_per_batch=4096,
           target_batch_size=1 << 18, grid_size=128, log2_hashmap_size=19)
REFRESH_STEP = 300
SOURCES = ("hash_encode", "fused_mlp", "envelope", "voxel_grid")


def startup_case(mesh, device, spec):
    """One rank's start-up: the runner, the first refresh and the first
    step, timed; ``entered`` is the wall clock at entry, for the spawn."""
    from jnerf_tpu_torch.parallel.dryrun import _clock, make_runner

    out = {"entered": time.time()}
    t0 = _clock(device)
    runner = make_runner(spec, device, mesh)
    out["setup_s"] = _clock(device) - t0
    if spec["grid"]:
        runner.cfg.m_training_step = REFRESH_STEP
        t0 = _clock(device)
        runner.sampler.update_density_grid(training_step=REFRESH_STEP,
                                           generator=runner.generator)
        out["grid_s"] = _clock(device) - t0
    sampler = runner.sampler
    out["shape"] = (sampler.n_rays_per_batch, sampler.n_samples_per_ray,
                    sampler.compacted_batch)
    t0 = _clock(device)
    out["loss"] = float(runner.train_step())
    out["step_s"] = _clock(device) - t0
    return out


def build_times() -> dict:
    """Seconds of each source's nvcc build into a fresh directory (all
    started together), their wall, and the warm lookup of all four."""
    from concurrent.futures import ThreadPoolExecutor

    from jnerf_tpu_torch.ops import cuda_lib

    preludes = [cuda_lib.hash_prelude() if s == "hash_encode" else ""
                for s in SOURCES]
    for s, pre in zip(SOURCES, preludes):  # the checkout's directory, warm
        cuda_lib.build(s, pre)
    t0 = time.perf_counter()
    for s, pre in zip(SOURCES, preludes):
        cuda_lib.build(s, pre)
    warm = time.perf_counter() - t0
    real = cuda_lib.BUILD_DIR

    def timed_build(args):
        t = time.perf_counter()
        cuda_lib.build(*args)
        return time.perf_counter() - t

    with tempfile.TemporaryDirectory(prefix="jnerf_build_") as tmp:
        cuda_lib.BUILD_DIR = Path(tmp)
        try:
            t0 = time.perf_counter()
            with ThreadPoolExecutor(len(SOURCES)) as pool:
                each = list(pool.map(timed_build, zip(SOURCES, preludes)))
            wall = time.perf_counter() - t0
        finally:
            cuda_lib.BUILD_DIR = real
    return dict(zip(SOURCES, each), wall=wall, warm=warm)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--no-compact", action="store_true")
    ap.add_argument("--nerf-steps", type=int, default=1024)
    ap.add_argument("--levels", type=int, default=16)
    ap.add_argument("--features", type=int, default=2)
    ap.add_argument("--single-device", action="store_true")
    ap.add_argument("--skip-grid", action="store_true")
    ap.add_argument("--step-only", action="store_true",
                    help="time only the train step (no grid refresh)")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    from jnerf_tpu_torch.parallel.dryrun import run_ranks

    p = common.start(args.cpu, "probe_compile")
    spec = {"cfg": dict(CFG, nerf_steps=args.nerf_steps,
                        hash_levels=args.levels, hash_features=args.features),
            "set": {} if args.no_compact else {"compacted_batch": True,
                                                "march_budget_factor": 2},
            "grid": not (args.skip_grid or args.step_only)}
    if p.device.type == "cuda":
        b = build_times()
        for s in SOURCES:
            p.line(f"build {s}", f"[build] {s}.cu fresh {b[s]:.1f}s", b[s] * 1e3,
                   "nvcc into a fresh build directory", clock="host")
        p.line("build", f"[build] fresh {b['wall']:.1f}s (together)  warm "
               f"{b['warm'] * 1e3:.2f}ms", b["wall"] * 1e3,
               "cuda_lib.build: nvcc, then the warm lookup", clock="host",
               warm_ms=b["warm"] * 1e3)
    else:
        print("[build] no nvcc build on the CPU: the kernels' plain twins "
              "run", flush=True)
    n_dev = 1 if args.single_device else RANKS
    t0 = time.time()
    if args.single_device:
        ranks = [startup_case(None, p.device, spec)]
    else:
        ranks = [r[0] for r in run_ranks(n_dev, [(startup_case, spec)],
                                         device=p.device.type)]
    first = ranks[0]
    spawn = max(r["entered"] for r in ranks) - t0
    setup = max(r["setup_s"] for r in ranks)
    p.line("setup", f"[setup] {setup:.1f}s  devices={n_dev}", setup * 1e3,
           "Runner construction (slowest rank)", clock="host")
    if not args.single_device:
        p.line("spawn", f"[spawn] {spawn:.1f}s  ranks={n_dev}", spawn * 1e3,
               "torch.multiprocessing spawn to each rank's case (last rank)",
               clock="host")
    missing = "XLA's lower and compile (the port compiles no step)"
    if spec["grid"]:
        p.no_counterpart("[grid_update] lower/compile", "jax.jit(...)"
                         ".lower().compile()", missing)
        g = max(r["grid_s"] for r in ranks)
        p.line("grid_update", f"[grid_update] run {g:.1f}s", g * 1e3,
               "the first sampler refresh (slowest rank)", clock="host")
    R, S, m = first["shape"]
    print(f"[step] shape R={R} S={S} compact={m}", flush=True)
    p.no_counterpart("[train_step] lower/compile",
                     "jax.jit(...).lower().compile()", missing)
    s = max(r["step_s"] for r in ranks)
    p.line("train_step", f"[train_step] run {s:.1f}s "
           f"loss={first['loss']:.5f}", s * 1e3,
           "the first Runner.train_step (slowest rank)", clock="host",
           losses=[r["loss"] for r in ranks])
    return p.lines


if __name__ == "__main__":
    main()

"""A NaN hunt on the hard scene: the counterpart of
`tools/archive/probe_nan_hard.py`.

    python3 -m jnerf_tpu_torch.tools.archive.probe_nan_hard [--encoder f8l4] \\
        [--scene hard] [--compact-m 16] [--march-factor 1] [--steps 1024] [--cpu]

Trains the bench config (16 images of 512^2; the hard scene at ssaa 2 with
4 val views) in windows of 128 steps through ``Runner.train_range``,
printing after each window the last loss and the health line (R, S,
``grid_nan``, ``grid_max``, the finest cascade's occupancy, whether every
parameter is finite); stops at a non-finite loss.  Then it lists the
non-finite parameters, renders val view 0 and prints whether the render
or the target holds a NaN, the render's range and its PSNR.  Exits with
status 1 if any loss, grid value, parameter or rendered value is not
finite.  ``--no-matmul`` has no counterpart (the JAX package's
``MATMUL_ROWS_MAX`` routed levels between TPU scatter kernels): it prints
its line and the run is the same.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from jnerf_tpu_torch.tools.archive import common

N_IMAGES, SIZE = 16, 512
WINDOW = 128


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--encoder", default="f8l4",
                    choices=("f4l8", "f8l4", "f2l16"))
    ap.add_argument("--scene", default="hard")
    ap.add_argument("--compact-m", type=int, default=16)
    ap.add_argument("--march-factor", type=int, default=1)
    ap.add_argument("--steps", type=int, default=1024)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--no-matmul", action="store_true",
                    help="no counterpart (the JAX package's MATMUL_ROWS_MAX)")
    args = ap.parse_args(argv)
    from jnerf_tpu_torch.runner import Runner
    from jnerf_tpu_torch.tools.tool_util import ENCODERS
    from jnerf_tpu_torch.utils import bench_cfg

    p = common.start(args.cpu, "probe_nan_hard")
    if args.no_matmul:
        p.no_counterpart("--no-matmul", "jnerf_tpu.ops.hash_nbr."
                         "MATMUL_ROWS_MAX", "a switch between the TPU "
                         "scatter kernels; the run below is unchanged")
    hard = args.scene == "hard"
    cfg = bench_cfg.ngp_synthetic_cfg(
        n_images=N_IMAGES, H=SIZE, W=SIZE, tot_train_steps=1 << 30,
        scene=args.scene, ssaa=2 if hard else 1, n_val=4 if hard else 2,
        **ENCODERS[args.encoder])
    if args.compact_m:
        cfg.compacted_batch = 1 << args.compact_m
        cfg.march_budget_factor = args.march_factor
    runner = Runner(device=p.device)

    def health():
        st = runner.sampler.state
        grid = st["density_grid"]
        finite = all(bool(torch.isfinite(q).all()) for q in runner.params)
        grid_nan = not bool(torch.isfinite(grid).all())
        return dict(
            R=runner.sampler.n_rays_per_batch,
            S=runner.sampler.n_samples_per_ray, grid_nan=grid_nan,
            grid_max=float(torch.nan_to_num(grid, nan=-np.inf).max()),
            occ=float(st["bitfield"][0].float().mean()),
            params_finite=finite)

    t0 = time.perf_counter()
    i, finite_run = 0, True
    while i < args.steps:
        nxt = min(args.steps, i + WINDOW)
        lv = float(runner.train_range(i, nxt))
        h = health()
        text = (f"step {nxt}: loss={lv:.6f} ({time.perf_counter() - t0:.0f}s) "
                f"R={h['R']} S={h['S']} grid_nan={h['grid_nan']} "
                f"grid_max={h['grid_max']:.3g} occ={h['occ']:.3f} "
                f"params_finite={h['params_finite']}")
        p.line(f"step {nxt}", text, None, "Runner.train_range", loss=lv,
               clock="host", **h)
        finite_run &= (np.isfinite(lv) and not h["grid_nan"]
                       and h["params_finite"])
        i = nxt
        if not np.isfinite(lv):
            break

    names = [k for k, q in runner.model.named_parameters()
             if not bool(torch.isfinite(q).all())]
    print("non-finite param leaves:", names or "none", flush=True)
    img, _alpha, tar = runner.render_img(dataset_mode="val", img_id=0)
    img, tar = np.asarray(img, np.float32), np.asarray(tar, np.float32)
    render_nan = bool(np.isnan(img).any())
    print("render nan:", render_nan, "tar nan:", bool(np.isnan(tar).any()),
          "img range:", float(img.min()), float(img.max()), flush=True)
    psnr = float(-10.0 * np.log10(np.mean((img - tar) ** 2)))
    print("psnr:", psnr, flush=True)
    ok = bool(finite_run and not names and np.isfinite(img).all()
              and np.isfinite(psnr))
    p.line("render", f"render: psnr {psnr:.3f} dB, all finite: {ok}", None,
           "Runner.render_img (val view 0)", psnr=psnr, ok=ok,
           non_finite_params=names, render_nan=render_nan)
    if not ok:
        raise SystemExit(1)
    return p.lines


if __name__ == "__main__":
    main()

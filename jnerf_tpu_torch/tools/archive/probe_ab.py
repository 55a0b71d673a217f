"""The training step under one toggled variant: the counterpart of
`tools/archive/probe_ab.py`.

    python3 -m jnerf_tpu_torch.tools.archive.probe_ab [encoder] [variant] [--cpu]

  encoder  f4l8 (default), f8l4 or f2l16
  variant  base       the config's defaults (plain-chain MLP, sweep refresh)
           pallasmlp  ``cfg.use_pallas_mlp``: F-MLP forward, B-MLP backward
           proberef   ``grid_update_mode = "probe"``: the refresh alone, timed
           sweepparts the sweep refresh in parts: ``_chunked_density`` over
                      the cascade's half-grid points (1.05M), the whole
                      refresh, and ``mean+bitfield``
           nocombine  no counterpart (the JAX package's ``RUN_COMBINE``)

The archive's bench runner: 16 images of 256^2, 4096 rays x 64 samples, the
grid refreshed as at step 300.  ``base`` and ``pallasmlp`` print the
per-step ms of a window of 4 steps: the counterpart of the archive's
``chain4`` scan is ``train_range`` over 4 steps that cross no refresh,
one CUDA graph replay (`runner/runner.py::_train_window`; a loop of
steps on the CPU), timed after its warm-up and capture windows.
"""

from __future__ import annotations

import argparse

from jnerf_tpu_torch.tools.archive import common

R, S = 4096, 64
N_IMAGES = 16
REFRESH_STEP = 300
WINDOW = 4
ENCODERS = ("f4l8", "f8l4", "f2l16")
VARIANTS = ("base", "pallasmlp", "nocombine", "proberef", "sweepparts")
MISSING = {"nocombine": ("jnerf_tpu.ops.hash_nbr.RUN_COMBINE",
                         "a switch between the TPU scatter kernels")}


def configure(variant: str):
    def apply(cfg):
        if variant == "pallasmlp":
            cfg.use_pallas_mlp = True
        if variant == "proberef":
            cfg.grid_update_mode = "probe"
    return apply


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("encoder", nargs="?", default="f4l8", choices=ENCODERS)
    ap.add_argument("variant", nargs="?", default="base", choices=VARIANTS)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    p = common.start(args.cpu, "probe_ab")
    enc, variant = args.encoder, args.variant
    if variant in MISSING:
        common.run_sections([variant], (), {}, MISSING, p)
    runner = common.bench_runner(p, enc, N_IMAGES, R, S, REFRESH_STEP,
                                 configure(variant), tot_train_steps=10 ** 9)
    sampler, gen = runner.sampler, runner.generator
    tag = f"AB {enc} {variant}"

    def line(name, fn, ran):
        ms = p.time(fn)
        p.line(f"{tag} {name}", f"{tag} {name}: {ms:.2f} ms", ms, ran)

    if variant == "proberef":
        n_u, n_n = sampler.grid_update_counts(REFRESH_STEP)
        line("refresh", lambda: sampler.update_density_grid_fn(
            sampler.state, False, gen, n_uniform=n_u, n_nonuniform=n_n),
            f"probe refresh, {n_u} + {n_n} cells")
        return p.lines
    if variant == "sweepparts":
        from jnerf_tpu_torch.ops.occupancy import (
            density_grid_mean, update_bitfield,
        )

        g = sampler.grid_config
        n = (g.n_cells // 2) * (g.max_cascade + 1)
        warped = p.tensor(common.uniform((n, 3)))
        line(f"chunked_density({n / 1e6:.2f}M)",
             lambda: sampler._chunked_density(warped),
             "the density chain in chunks (plain MLP, kernel F)")
        line("sweep refresh", lambda: sampler.update_density_grid_fn(
            sampler.state, False, gen), "sweep refresh")
        grid = sampler.state["density_grid"]
        line("mean+bitfield", lambda: update_bitfield(
            grid, density_grid_mean(grid, g), g, sampler._pool_hi),
            "density_grid_mean + update_bitfield")
        return p.lines

    def win():
        return runner.train_range(1, 1 + WINDOW)

    win()  # warm-up window
    win()  # capture
    ms = p.time(win)
    mode = "graph replay" if p.device.type == "cuda" else "loop of steps"
    ran = (("F-MLP + B-MLP, " if variant == "pallasmlp" else "")
           + f"one {WINDOW}-step window ({mode})")
    p.line(tag, f"{tag}: per-step {ms / WINDOW:.2f} ms", ms / WINDOW, ran,
           window_ms=ms)
    return p.lines


if __name__ == "__main__":
    main()

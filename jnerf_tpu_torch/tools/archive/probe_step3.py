"""The training step and its tiers in isolation: the counterpart of
`tools/archive/probe_step3.py`.

    python3 -m jnerf_tpu_torch.tools.archive.probe_step3 [f4l8|f2l16] [part ...] [--cpu]

Parts (all by default): step (a 4-step graph window of ``train_range``
that crosses no refresh, per step), window
(``train_range`` over 64 steps with the refresh and the batch
adaptation), march (``sample_fixed``), sh (``sh_encode`` of R*S
directions), comp (compositing and the MSE, forward and forward +
backward), opt (Adam + EMA on fixed gradients), refresh (one grid
refresh, and its share of a 16-step window), model (the model's forward,
and forward + backward, on R*S uniform samples).  The archive's bench
runner (`common.bench_runner`: 16 images of 256^2, 4096 x 64, the grid
refreshed as at step 300); the tiers as `tools/probe_tiers.py` runs
them, eagerly, timed by CUDA events (`common.Probe.time`).
"""

from __future__ import annotations

import argparse
import time

import torch

from jnerf_tpu_torch.tools.archive import common

R, S = 4096, 64
N_IMAGES = 16
REFRESH_STEP = 300
WINDOW = 4
RANGE = (304, 368)
PARTS = ("step", "window", "march", "sh", "comp", "opt", "refresh", "model")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("args", nargs="*", metavar="[f4l8|f2l16] part",
                    choices=("f4l8", "f2l16") + PARTS)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    enc = "f2l16" if args.args[:1] == ["f2l16"] else "f4l8"
    parts = [a for a in args.args if a not in ("f4l8", "f2l16")]
    p = common.start(args.cpu, "probe_step3")
    runner = common.bench_runner(p, enc, N_IMAGES, R, S, REFRESH_STEP,
                                 tot_train_steps=10 ** 9)
    dev, gen = p.device, torch.Generator(p.device).manual_seed(0)
    sampler, model = runner.sampler, runner.model
    n = R * S
    print(f"encoder={enc} R={R} S={S}", flush=True)

    def line(name, fn, ran, fmt="{name}: {ms:.2f} ms", **extra):
        ms = p.time(fn)
        p.line(name, fmt.format(name=name, ms=ms), ms, ran, **extra)
        return ms

    def step():
        def win():
            return runner.train_range(1, 1 + WINDOW)

        win()
        win()
        ms = line("full step (scan4, device-true)", win,
                  f"one {WINDOW}-step window of train_step (graph replay "
                  "on the card)")
        print(f"  -> per-step {ms / WINDOW:.2f} ms", flush=True)

    def window():
        start, end = RANGE
        p.sync()
        t0 = time.perf_counter()
        float(runner.train_range(start, end))
        ms = (time.perf_counter() - t0) * 1e3 / (end - start)
        p.line("train_range", f"train_range {end - start} steps incl "
               f"refresh+adapt: {ms:.2f} ms/step", ms,
               "Runner.train_range, host clock to the last loss's read",
               clock="host")

    def march():
        ro = p.tensor(common.uniform((R, 3), seed=1) * 0.4 + 0.3)
        rd = p.tensor(common.unit_rows(R, seed=2))
        line("march (sample_fixed)", lambda: sampler.sample_fixed(
            sampler.state, ro, rd, gen, S), "sample_fixed")

    def sh():
        from jnerf_tpu_torch.ops.sh import sh_encode

        dw = p.tensor(common.unit_rows(n, seed=3) * 0.5 + 0.5)
        line("SH encode", lambda: sh_encode(dw, 4), "sh_encode, degree 4")

    def comp():
        from jnerf_tpu_torch.ops.composite import render_rays

        raw = p.tensor(common.normal((R, S, 4), seed=4)).requires_grad_()
        dts = torch.full((R, S), 1e-3, device=dev)
        valid = torch.ones((R, S), dtype=torch.bool, device=dev)
        bg = p.tensor(common.uniform((R, 3), seed=5))
        tgt = p.tensor(common.uniform((R, 3), seed=6))

        def loss():
            rgb, _ = render_rays(raw, dts, valid, None, bg)
            return ((rgb - tgt) ** 2).mean()

        with torch.no_grad():
            line("composite+mse fwd", loss, "render_rays + MSE")
        line("composite+mse fwd+bwd",
             lambda: torch.autograd.grad(loss(), raw), "the same + autograd")

    def opt():
        params = runner.params
        grads = [q.detach() * 1e-3 for q in params]

        def step_once():
            for q, gq in zip(params, grads):
                q.grad = gq
            runner.optimizer.step()
            if runner.ema is not None:
                runner.ema.step(params, runner.ema_state)

        line("adam+ema", step_once, "AdamOptimizer.step + EMA.step")

    def refresh():
        n_u, n_n = sampler.grid_update_counts(REFRESH_STEP)
        ms = line("grid refresh", lambda: sampler.update_density_grid_fn(
            sampler.state, False, runner.generator, n_uniform=n_u,
            n_nonuniform=n_n), f"update_density_grid_fn "
            f"({sampler.grid_update_mode})")
        print(f"  -> amortized {ms / sampler.update_den_freq:.2f} ms/step",
              flush=True)

    def model_part():
        pos = p.tensor(common.uniform((n, 3), seed=7))
        dirs = p.tensor(common.uniform((n, 3), seed=8))

        def fwd():
            with torch.no_grad():
                return model(pos, dirs)

        def fwd_bwd():
            out = model(pos, dirs).float()
            return torch.autograd.grad((out * out).mean(), runner.params)

        line("model fwd", fwd, "NGPNetworks forward (kernel F)")
        line("model fwd+bwd", fwd_bwd, "forward + autograd (kernels F, B)")

    sections = dict(step=step, window=window, march=march, sh=sh, comp=comp,
                    opt=opt, refresh=refresh, model=model_part)
    common.run_sections(parts, PARTS, sections, {}, p)
    return p.lines


if __name__ == "__main__":
    main()

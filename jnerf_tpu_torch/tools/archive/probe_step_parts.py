"""The model's forward and backward at NGP scale in parts: the counterpart
of `tools/archive/probe_step_parts.py`.

    python3 -m jnerf_tpu_torch.tools.archive.probe_step_parts [efwd ekern egrad mfwd mgrad] [--cpu]

The bench config at 8 images of 256^2 (16 levels x 2, log2 19), its NGP
network built from the seed, N = 2^18 uniform positions and unit
directions drawn with numpy:

  efwd   the hash encode's forward (kernel F)
  ekern  the table gradient alone (kernel B, ``grad_table``, on a
         gradient N(0, 1e-4))
  egrad  the hash encode's forward and backward through autograd (F, B)
  mfwd   the model's forward
  mgrad  the model's forward and backward (mean(out^2) in every parameter)
"""

from __future__ import annotations

import argparse

import torch

from jnerf_tpu_torch.tools.archive import common

N = 1 << 18
N_IMAGES = 8
SECTIONS = ("efwd", "ekern", "egrad", "mfwd", "mgrad")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    common.section_arg(ap, SECTIONS, SECTIONS)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    from jnerf_tpu_torch.ops.hash_nbr import grad_table, hash_encode_nbr

    p = common.start(args.cpu, "probe_step_parts")
    runner = common.bench_runner(p, "f2l16", N_IMAGES, refresh_step=None)
    model = runner.model
    spec = model.pos_encoder.spec
    grid = next(model.pos_encoder.parameters())
    print(f"spec entries={spec.n_entries} sizes[5]={spec.level_sizes[5]}",
          flush=True)
    pos = p.tensor(common.uniform((N, 3)))
    dirs = p.tensor(common.unit_rows(N, seed=1))
    leaf = grid.detach().clone().requires_grad_()

    def line(name, fn, ran):
        ms = p.time(fn)
        p.line(name, f"{name}: {ms:.1f} ms", ms, ran)

    def ekern():
        gup = p.tensor(common.normal((N, spec.out_dim), 0.01, seed=2))
        line("hash grad kernel (direct)",
             lambda: grad_table(spec, pos, gup), "kernel B (grad_table)")

    def egrad():
        def fn():
            out = hash_encode_nbr(spec, leaf, pos)
            return torch.autograd.grad((out * out).mean(), leaf)[0]
        line("hash fwd+bwd (jax.grad)", fn, "kernel F + kernel B (autograd)")

    def mfwd():
        def fn():
            with torch.no_grad():
                return model(pos, dirs)
        line("model fwd", fn, "NGPNetworks forward")

    def mgrad():
        def fn():
            out = model(pos, dirs).float()
            return torch.autograd.grad((out * out).mean(), runner.params)
        line("model fwd+bwd", fn, "NGPNetworks forward + autograd")

    sections = {
        "efwd": lambda: line("hash encode fwd", lambda: hash_encode_nbr(
            spec, grid.detach(), pos), "kernel F"),
        "ekern": ekern, "egrad": egrad, "mfwd": mfwd, "mgrad": mgrad}
    common.run_sections(args.sections, SECTIONS, sections, {}, p)
    return p.lines


if __name__ == "__main__":
    main()

"""The hash encode's forward and backward at NGP scale: the counterpart of
`tools/archive/probe_nbr.py`.

    python3 -m jnerf_tpu_torch.tools.archive.probe_nbr [nbr_fwd nbr_bwd rows_fwd rows_bwd] [--cpu]

16 levels x 2 features, log2 19 (no extra cap), a table N(0, 0.01) and
N = 2^18 uniform positions (numpy):

  nbr_fwd   the forward, kernel F (`ops/hash_nbr.py::hash_encode_nbr`)
  nbr_bwd   forward and backward of mean(out^2) in the table (kernels F
            and B through autograd)
  rows_fwd, rows_bwd  no counterpart: the archive's round-1 packed-row
            path (`jnerf_tpu/ops/hash_grid_rows.py::hash_encode_rows`)
"""

from __future__ import annotations

import argparse

import torch

from jnerf_tpu_torch.tools.archive import common

N = 1 << 18
LEVELS, LOG2 = 16, 19
SECTIONS = ("nbr_fwd", "nbr_bwd", "rows_fwd", "rows_bwd")
ROWS = ("jnerf_tpu.ops.hash_grid_rows.hash_encode_rows",
        "the 128-lane packed-row layout")
MISSING = {"rows_fwd": ROWS, "rows_bwd": ROWS}


def spec_of():
    from jnerf_tpu_torch.ops.hash_grid import HashGridSpec

    return HashGridSpec(n_levels=LEVELS, log2_hashmap_size=LOG2)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    common.section_arg(ap, SECTIONS, SECTIONS)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    from jnerf_tpu_torch.ops.hash_nbr import hash_encode_nbr

    p = common.start(args.cpu, "probe_nbr")
    spec = spec_of()
    print(f"spec: {spec.n_entries} entries, {spec.n_levels} levels",
          flush=True)
    table = p.tensor(common.normal((spec.n_entries, 2), 0.1))
    pos = p.tensor(common.uniform((N, 3), seed=1))
    leaf = table.clone().requires_grad_()

    def line(name, fn, ran):
        ms = p.time(fn)
        per = ms * 1e6 / (N * spec.n_levels)
        p.line(name, f"{name}: {ms:.2f} ms ({per:.2f} ns per sample-level)",
               ms, ran)

    def fwd_bwd():
        out = hash_encode_nbr(spec, leaf, pos)
        return torch.autograd.grad((out * out).mean(), leaf)[0]

    sections = {
        "nbr_fwd": lambda: line("nbr fwd", lambda: hash_encode_nbr(
            spec, table, pos), "kernel F"),
        "nbr_bwd": lambda: line("nbr fwd+bwd", fwd_bwd,
                                "kernel F + kernel B (autograd)"),
    }
    common.run_sections(args.sections, SECTIONS, sections, MISSING, p)
    return p.lines


if __name__ == "__main__":
    main()

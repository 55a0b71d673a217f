"""The linear hash encode stage by stage at NGP scale: the counterpart of
`tools/archive/probe_nbr2.py`.

    python3 -m jnerf_tpu_torch.tools.archive.probe_nbr2 [build idxw gather fullpre full bwd] [--cpu]

16 levels x 2 features, log2 19, hashed levels capped at 2^18 entries, a
table N(0, 0.01) and N = 2^18 uniform positions (numpy):

  idxw     indices and weights: each level's base entry e0 and corner
           factors (`ops/hash_nbr.py::_cell`), the 8 corner weights
           (``_corner_weight``) and entries (``_corner_entry``): PyTorch
           calls
  gather   the bare gather of the 8 corner rows of each (sample, level)
           from the bf16 table at precomputed entries (``index_select``):
           the port reads the corners straight from the master table,
           where the archive gathered one neighbourhood row
  full     the forward, kernel F
  bwd      forward and backward of mean(out^2) in the table (F and B)
  build, fullpre  no counterpart: the neighbourhood table
           (``build_nbr_table``), built and prebuilt

Each line gives the archive's ms and ns a unit (a unit: a sample-level),
then what ran.
"""

from __future__ import annotations

import argparse

import torch

from jnerf_tpu_torch.tools.archive import common

N = 1 << 18
LEVELS, LOG2, CAP = 16, 19, 1 << 18
SECTIONS = ("build", "idxw", "gather", "fullpre", "full", "bwd")
NBR = ("jnerf_tpu.ops.hash_nbr.build_nbr_table",
       "the per-level neighbourhood table the TPU gathers one row of")
MISSING = {"build": NBR, "fullpre": NBR}


def spec_of():
    from jnerf_tpu_torch.ops.hash_grid import HashGridSpec

    return HashGridSpec(n_levels=LEVELS, log2_hashmap_size=LOG2,
                        max_level_size=CAP)


def index_weights(spec, pos):
    """The idxw stage: (e0 [N, L] int64, corner weights [N, L, 8] f32,
    corner entries [N, L, 8] int64 into the master table)."""
    from jnerf_tpu_torch.ops.hash_nbr import (
        _cell, _corner_entry, _corner_weight, level_consts,
    )

    consts = level_consts(spec)
    e0s, ws, entries = [], [], []
    for lvl in range(spec.n_levels):
        e0, X = _cell(consts, lvl, pos)
        e0s.append(e0)
        ws.append(torch.stack([_corner_weight(X, c) for c in range(8)], 1))
        entries.append(torch.stack([_corner_entry(consts, lvl, e0, c)
                                    for c in range(8)], 1))
    return torch.stack(e0s, 1), torch.stack(ws, 1), torch.stack(entries, 1)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    common.section_arg(ap, SECTIONS, SECTIONS)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    from jnerf_tpu_torch.ops.hash_nbr import hash_encode_nbr

    p = common.start(args.cpu, "probe_nbr2")
    spec = spec_of()
    L = spec.n_levels
    print(f"spec: {spec.n_entries} entries, {L} levels, N={N}", flush=True)
    print("level sizes:", list(spec.level_sizes), flush=True)
    table = p.tensor(common.normal((spec.n_entries, 2), 0.1))
    pos = p.tensor(common.uniform((N, 3), seed=1))
    leaf = table.clone().requires_grad_()

    def line(name, fn, ran):
        ms = p.time(fn)
        p.line(name, f"{name}: {ms:.2f} ms ({ms * 1e6 / (N * L):.2f} "
               "ns/unit)", ms, ran)

    def gather():
        entries = index_weights(spec, pos)[2].reshape(-1)
        tbl = table.bfloat16()
        line("bare row gather [N*L,16]", lambda: tbl.index_select(0, entries),
             "library: index_select of 8 corner rows a (sample, level)")

    def fwd_bwd():
        out = hash_encode_nbr(spec, leaf, pos)
        return torch.autograd.grad((out * out).mean(), leaf)[0]

    sections = {
        "idxw": lambda: line("index+weights", lambda: index_weights(
            spec, pos), "_cell, _corner_weight, _corner_entry (PyTorch "
            "calls)"),
        "gather": gather,
        "full": lambda: line("full fwd", lambda: hash_encode_nbr(
            spec, table, pos), "kernel F"),
        "bwd": lambda: line("fwd+bwd", fwd_bwd,
                            "kernel F + kernel B (autograd)"),
    }
    common.run_sections(args.sections, SECTIONS, sections, MISSING, p)
    return p.lines


if __name__ == "__main__":
    main()

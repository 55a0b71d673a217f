"""Variants of the packed hash-gradient scatter at the reference's f2l16
shapes: the counterpart of `tools/archive/probe_bwd_var.py`.

    python3 -m jnerf_tpu_torch.tools.archive.probe_bwd_var [noscat novals v2d alt2 v3d] [--cpu]

At 16 levels of 2 features, ``log2_hashmap_size`` 19 and a 2^18-entry
level cap (ROWS = 32768 packed rows of 8 entries a level), N = 2^18
uniform samples and g ~ 0.01 N(0, 1) (numpy, seed 0): the archive's
``make`` (``pallas_call`` at ``:101``, contributions from ``vals_phase``
``:40``) is K4 (`ops/envelope.py::packed_hash_scatter`) in its variants
``v2d``, ``alt2`` (two accumulators), ``novals`` (ones) and ``noscat``
(the contribution pass without the scatter).  Each (level, sample)'s row
and slot come from the port's own hash (``packed_rows_slots``).  ``v3d``
(the archive's library path) is the port's kernel B
(``hash_nbr.grad_table``) on the same samples.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from jnerf_tpu_torch.tools.archive import common

N = 1 << 18
BLK = 8192
SPEC = dict(n_levels=16, log2_hashmap_size=19, max_level_size=1 << 18)
VARIANTS = ("noscat", "novals", "v2d", "alt2", "v3d")


def inputs(p, spec):
    """pos [N, 3] uniform and g [N, 2L] ~ 0.01 N(0, 1), numpy at seed 0,
    and each (level, sample)'s packed row and slot [L, N]."""
    from jnerf_tpu_torch.ops.envelope import packed_rows_slots

    rng = np.random.default_rng(0)
    pos = p.tensor(rng.uniform(size=(N, 3)).astype(np.float32))
    g = p.tensor((rng.normal(size=(N, 2 * spec.n_levels)) * 0.01)
                 .astype(np.float32))
    rows, slots = packed_rows_slots(spec, pos)
    return pos, g, rows.contiguous(), slots.contiguous()


def k4_bytes(rows, slots, n_rows, n_acc, mode):
    """K4's least traffic: pos, g, rows and slots in (12 + 16 L bytes a
    sample), the zeroing of the output, one read and one write of each
    64-byte slot segment (a 512-byte row for novals) it adds into, and
    noscat's 64-byte contribution a (level, sample) written to scratch."""
    L, n = rows.shape
    nbytes = 12 * n + 16 * L * n + L * n_acc * n_rows * 512
    lvl = torch.arange(L, device=rows.device)[:, None]
    acc = torch.arange(n, device=rows.device)[None, :] % n_acc
    row = (lvl * n_acc + acc) * n_rows + rows.long()
    if mode == "novals":
        return nbytes + 2 * 512 * common.distinct(row)
    if mode == "noscat":
        first = slots[:, ::BLK].long() + 8 * lvl
        return nbytes + 64 * L * n + 2 * 64 * common.distinct(first)
    return nbytes + 2 * 64 * common.distinct(row * 8 + slots.long())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="*", metavar="variant",
                    help=f"any of {', '.join(VARIANTS)} (all but v3d by "
                    "default)")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    if set(args.variants) - set(VARIANTS):
        ap.error(f"variants are {', '.join(VARIANTS)}")
    from jnerf_tpu_torch.ops import hash_nbr
    from jnerf_tpu_torch.ops.envelope import packed_hash_scatter
    from jnerf_tpu_torch.ops.hash_grid import HashGridSpec

    p = common.start(args.cpu, "probe_bwd_var")
    spec = HashGridSpec(**SPEC)
    L, n_rows = spec.n_levels, max(spec.level_sizes) // 8
    scales = np.asarray(spec.scales, np.float32)
    pos, g, rows, slots = inputs(p, spec)
    for v in args.variants or VARIANTS[:4]:
        if v == "v3d":
            ms = p.time(lambda: hash_nbr.grad_table(spec, pos, g))
            F = spec.n_features_per_level
            p.emit(v, f"v3d (library): {ms:.1f} ms", ms, N * L,
                   12 * N + 4 * F * L * N + 4 * F * spec.n_entries,
                   "kernel B (hash_nbr.grad_table)")
            continue
        n_acc = 2 if v == "alt2" else 1
        mode = "v2d" if v == "alt2" else v
        ms = p.time(lambda: packed_hash_scatter(
            pos, g, rows, slots, scales, n_rows, n_acc, mode, BLK))
        p.emit(v, f"{v}: {ms:.1f} ms ({ms * 1e6 / (N * L):.2f} ns/row)", ms,
               N * L, k4_bytes(rows, slots, n_rows, n_acc, mode),
               f"K4 ({mode}, {n_acc} accumulator{'s' * (n_acc > 1)})")
    return p.lines


if __name__ == "__main__":
    main()

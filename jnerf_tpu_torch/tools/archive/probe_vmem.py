"""Big-table gathers: the two-sub-table select-gather split beside the
single gather, and the table-size knee: the counterpart of
`tools/archive/probe_vmem.py`.

    python3 -m jnerf_tpu_torch.tools.archive.probe_vmem [opt split knee] [--cpu]

N = 2^22 row fetches at uniform rows (numpy, seed 0):

  opt    no counterpart: the archive compiled one gather under XLA's
         ``xla_tpu_scoped_vmem_limit_kib`` option
  split  a [512K, W] bf16 table split in two 256K halves: both halves
         gathered at clamped rows and the right row selected
         (``torch.where``), beside one ``index_select`` of the whole
         table; at the archive's W = 16 (16 MB, halves of 8 MB) and at
         W = 128, where the whole table (128 MB) and each half (64 MB)
         exceed the H100's 50 MB L2
  knee   [320K, 16], [384K, 16] and [448K, 16] bf16 (10-14 MB)

These lines time PyTorch's calls on purpose, as the archive timed XLA's:
measurements of the library, not ports of a kernel.  Each gives the
archive's ms and ns a row, then the rate, the bytes (`common.py`) and the
bound.
"""

from __future__ import annotations

import argparse

import torch

from jnerf_tpu_torch.tools.archive import common

N = 1 << 22
KI = 1 << 10  # the names' K of table rows
SPLIT_WIDTHS = (16, 128)
SECTIONS = ("opt", "split", "knee")
MISSING = {"opt": ("jax.jit(..., compiler_options="
                   "{'xla_tpu_scoped_vmem_limit_kib': ...})",
                   "a TPU compiler option")}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    common.section_arg(ap, SECTIONS, SECTIONS)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    p = common.start(args.cpu, "probe_vmem")

    def table(n_rows, width=16):
        return (p.randn(n_rows, width) * 0.1).bfloat16()

    def emit(name, fn, nbytes, ran, **extra):
        ms = p.time(fn)
        p.emit(name, f"{name}: {ms:.2f} ms -> {ms * 1e6 / N:.2f} ns/row", ms,
               N, nbytes, ran, **extra)

    def knee():
        for k, label in ((320, "320K=10MB"), (384, "384K=12MB"),
                         (448, "448K=14MB")):
            tbl = table(k * KI)
            idx = p.tensor(common.uniform_idx(N, k * KI))
            emit(f"[{label},16] bf16", lambda: tbl.index_select(0, idx),
                 common.gather_bytes(N, 32, common.distinct(idx)),
                 "library: index_select", table_rows=k * KI)

    def split():
        rows, half = 512 * KI, 256 * KI
        idx = p.tensor(common.uniform_idx(N, rows))
        read = common.distinct(idx)
        lo_i = idx.clamp(max=half - 1)
        hi_i = (idx - half).clamp(min=0)
        sel = (idx < half)[:, None]
        for width in SPLIT_WIDTHS:
            ta, tb = table(half, width), table(half, width)
            whole = torch.cat([ta, tb])
            rb = 2 * width
            nbytes = common.gather_bytes(N, rb, read)
            emit(f"[512K,{width}] single gather",
                 lambda: whole.index_select(0, idx), nbytes,
                 "library: index_select", row_bytes=rb)
            emit(f"[512K,{width}] 2x256K select-split",
                 lambda: torch.where(sel, ta.index_select(0, lo_i),
                                     tb.index_select(0, hi_i)), nbytes,
                 "library: two index_select at clamped rows + torch.where",
                 row_bytes=rb)
            del ta, tb, whole

    common.run_sections(args.sections, SECTIONS,
                        {"split": split, "knee": knee}, MISSING, p)
    return p.lines


if __name__ == "__main__":
    main()

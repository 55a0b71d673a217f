"""Library row-gather rates by table rows, row width, dtype and index
order: the counterpart of `tools/archive/probe_gather.py`.

    python3 -m jnerf_tpu_torch.tools.archive.probe_gather [a b c d e] [--cpu]

N = 2^22 row fetches (``index_select``) from tables N(0, 0.01), indices
uniform (numpy, seed 0), as the archive's sections:

  a  [512K, 128], [512K, 16] and [6M, 16] bf16   (the default)
  b  [6M, 16] f32, [6M, 128] bf16, [6M, 16] bf16 with sorted indices
  c  [64K, 16], [64K, 128], [512K, 32], [512K, 64] bf16
  d  [128K, 16], [256K, 16] bf16, and [512K, 16] read in a 64K window
  e  the per-level forward pattern: 16 gathers of 2^18 rows from per-level
     tables (5 dense + 11 of 512K) of [size, 16] bf16, summed in f32

These lines time PyTorch's gather on purpose, as the archive timed XLA's:
they are measurements of the library, not ports of a kernel.  Each gives
the archive's ms and ns a row, then the rate, the bytes (`common.py`: the
indices, each distinct row once, the output) and the bound.
"""

from __future__ import annotations

import argparse

import torch

from jnerf_tpu_torch.tools.archive import common

N = 1 << 22
NS = 1 << 18
KI, MI = 1 << 10, 1 << 20  # the names' K and M of table rows
LEVEL_SIZES = [4096, 12168, 29792, 79512, 205384] + [1 << 19] * 11
SECTIONS = ("a", "b", "c", "d", "e")
BF16, F32 = torch.bfloat16, torch.float32


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    common.section_arg(ap, SECTIONS, ("a",))
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    p = common.start(args.cpu, "probe_gather")

    def table(n_rows, width, dtype):
        return (p.randn(n_rows, width) * 0.1).to(dtype)

    def emit(name, fn, idx, n_rows, width, dtype, items=None, nbytes=None):
        ms = p.time(fn)
        items = idx.numel() if items is None else items
        if nbytes is None:
            rb = width * dtype.itemsize
            nbytes = common.gather_bytes(items, rb, common.distinct(idx))
        p.emit(name, f"{name}: {ms:.2f} ms -> {ms * 1e6 / items:.2f} ns/row",
               ms, items, nbytes, "library: index_select", table_rows=n_rows,
               row_bytes=width * dtype.itemsize)

    def gtest(name, n_rows, width, dtype, sort=False, span=None):
        tbl = table(n_rows, width, dtype)
        idx = p.tensor(common.uniform_idx(N, span or n_rows))
        if sort:
            idx = torch.sort(idx).values
        emit(name, lambda: tbl.index_select(0, idx), idx, n_rows, width, dtype)

    def levels():
        tbls = [table(s, 16, BF16) for s in LEVEL_SIZES]
        idxs = [p.tensor(common.uniform_idx(NS, s, seed=i))
                for i, s in enumerate(LEVEL_SIZES)]

        def fn():
            acc = torch.zeros((NS, 16), device=p.device)
            for t, i in zip(tbls, idxs):
                acc += t.index_select(0, i).float()
            return acc

        nbytes = sum(common.gather_bytes(NS, 32, common.distinct(i),
                                         out_row_bytes=0) for i in idxs) \
            + NS * 16 * 4
        emit("per-level 16x gather [262K,16]", fn, None, None, 16, BF16,
             items=NS * len(LEVEL_SIZES), nbytes=nbytes)

    sections = {
        "a": lambda: (gtest("[512K,128] bf16 rand", 512 * KI, 128, BF16),
                      gtest("[512K, 16] bf16 rand", 512 * KI, 16, BF16),
                      gtest("[6M,   16] bf16 rand", 6 * MI, 16, BF16)),
        "b": lambda: (gtest("[6M,   16] f32  rand", 6 * MI, 16, F32),
                      gtest("[6M,  128] bf16 rand", 6 * MI, 128, BF16),
                      gtest("[6M,   16] bf16 sort", 6 * MI, 16, BF16,
                            sort=True)),
        "c": lambda: (gtest("[64K,  16] bf16 rand", 64 * KI, 16, BF16),
                      gtest("[64K, 128] bf16 rand", 64 * KI, 128, BF16),
                      gtest("[512K,32] bf16 rand", 512 * KI, 32, BF16),
                      gtest("[512K,64] bf16 rand", 512 * KI, 64, BF16)),
        "d": lambda: (gtest("[128K,16] bf16 rand", 128 * KI, 16, BF16),
                      gtest("[256K,16] bf16 rand", 256 * KI, 16, BF16),
                      gtest("[512K,16] 64K-window", 512 * KI, 16, BF16,
                            span=64 * KI)),
        "e": levels,
    }
    common.run_sections(args.sections, ("a",), sections, {}, p)
    return p.lines


if __name__ == "__main__":
    main()

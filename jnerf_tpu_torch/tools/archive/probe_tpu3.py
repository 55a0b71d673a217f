"""Library row-gather and scatter-add rates at hash-encode scale: the
counterpart of `tools/archive/probe_tpu3.py`.

    python3 -m jnerf_tpu_torch.tools.archive.probe_tpu3 [--cpu]

T = 2^19 rows of a packed [T, 128] table, N = 262144 x 16 (sample, level)
row fetches at uniform rows (numpy, seed 0), as the archive:

  row-gather 4.2M x128 f32 / bf16    ``index_select``
  row-gather+lane-reduce 4.2M        the gather, a lane mask picking one
                                     16-lane block of 8, summed to [N, 16]
                                     and weighted: PyTorch calls, unfused
                                     (XLA's fusion of them, which the
                                     archive checked, has no counterpart)
  row-scatter-add 4.2M x128 / x16    ``index_add_`` into [T, 128] and
                                     [8T, 16] f32 accumulators
  8 rolls of 12Mx2 table             ``torch.roll`` of an [11.9M, 2] table
  bool gather 1.2M                   ``torch.take`` of a 2M-cell bitfield
  vmapped searchsorted 4096x64       ``torch.searchsorted`` of 64 targets
                                     in each of 4096 sorted rows of 2368

These lines time PyTorch's calls on purpose, as the archive timed XLA's:
measurements of the library, not ports of a kernel.  Each gives the
archive's ms a call and rate, then the rate, the bytes (`common.py`) and
the bound.
"""

from __future__ import annotations

import argparse

import torch

from jnerf_tpu_torch.tools.archive import common

T = 1 << 19
N = 262144 * 16
ROLL_ROWS = 11_904_000
CELLS, PROBES = 2_097_152, 1_200_000
SS_ROWS, SS_COLS, SS_TARGETS = 4096, 2368, 64


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    p = common.start(args.cpu, "probe_tpu3")
    dev = p.device

    def line(name, fn, per_call, unit, nbytes, ran):
        ms = p.time(fn)
        p.emit(name, f"{name}: {ms:.2f} ms/call -> "
               f"{per_call / ms / 1e3:.1f} M{unit}/s", ms, per_call, nbytes,
               ran, unit=unit)

    tbl = p.randn(T, 128)
    tblb = tbl.bfloat16()
    ridx = p.tensor(common.uniform_idx(N, T))
    rows_read = common.distinct(ridx)
    line("row-gather 4.2M x128 f32", lambda: tbl.index_select(0, ridx), N,
         "rows", common.gather_bytes(N, 512, rows_read),
         "library: index_select")
    line("row-gather 4.2M x128 bf16", lambda: tblb.index_select(0, ridx), N,
         "rows", common.gather_bytes(N, 256, rows_read),
         "library: index_select")
    del tblb

    lane_sel = p.tensor(common.uniform_idx(N, 8, seed=1)).reshape(N, 1)
    w = p.tensor(common.normal((N, 16), seed=2))
    lane_ids = torch.arange(128, device=dev)[None, :] // 16

    def rg_reduce():
        rows = tbl.index_select(0, ridx)
        mask = (lane_ids == lane_sel).float()
        return (rows * mask).reshape(N, 8, 16).sum(dim=1) * w

    line("row-gather+lane-reduce 4.2M", rg_reduce, N, "rows",
         common.gather_bytes(N, 512, rows_read, out_row_bytes=64,
                             w_row_bytes=64 + 4),
         "library: index_select, mask, sum and scale (unfused)")
    del lane_sel, w

    vals = p.randn(N, 128)
    acc = torch.zeros((T, 128), device=dev)
    sidx = ((ridx.long() + 1) % T)
    line("row-scatter-add 4.2M x128", lambda: acc.index_add_(0, sidx, vals),
         N, "rows", common.scatter_bytes(N, 512, T), "library: index_add_")
    del vals, acc
    vals16 = p.randn(N, 16)
    acc16 = torch.zeros((T * 8, 16), device=dev)
    sidx16 = (ridx.long() * 8 + 3) % (T * 8)
    line("row-scatter-add 4.2M x16",
         lambda: acc16.index_add_(0, sidx16, vals16), N, "rows",
         common.scatter_bytes(N, 64, T * 8), "library: index_add_")
    del vals16, acc16, tbl

    master = p.randn(ROLL_ROWS, 2)
    roll_bytes = 8 * master.numel() * 4 * 2

    def rolls():
        return sum(torch.roll(master, k + 1, dims=0).sum() for k in range(8))

    line("8 rolls of 12Mx2 table", rolls, roll_bytes, "B", roll_bytes,
         "library: torch.roll and sum, 8 times")
    del master

    bf = p.tensor(common.uniform((CELLS,), seed=3) < 0.08)
    pidx = p.tensor(common.uniform_idx(PROBES, CELLS, seed=4)).long()
    line("bool gather 1.2M", lambda: torch.take(bf, pidx), PROBES, "elem",
         8 * PROBES + common.distinct(pidx) + PROBES,
         "library: torch.take")

    cum = p.tensor(common.uniform_idx(SS_ROWS * SS_COLS, 200, seed=5)
                   .reshape(SS_ROWS, SS_COLS))
    cum = torch.sort(cum, dim=1).values.contiguous()
    tgt = torch.arange(1, SS_TARGETS + 1, device=dev, dtype=cum.dtype) \
        .expand(SS_ROWS, SS_TARGETS).contiguous()
    line("vmapped searchsorted 4096x64",
         lambda: torch.searchsorted(cum, tgt), SS_ROWS * SS_TARGETS, "q",
         4 * cum.numel() + 4 * tgt.numel() + 8 * tgt.numel(),
         "library: torch.searchsorted")
    print("done", flush=True)
    return p.lines


if __name__ == "__main__":
    main()

"""Calibration and the gather formulations: the counterpart of
`tools/archive/probe_tpu.py`.

    python3 -m jnerf_tpu_torch.tools.archive.probe_tpu [--cpu]

1. calibration: a 4096^3 bf16 matmul and an elementwise scale of 256 MB
   (PyTorch calls);
2. the XLA gathers (an element take of [N, 128] from 512K, with indices
   sorted by column, and a row gather), as ``torch.take`` and
   ``index_select``: library yardsticks;
3. the Pallas gather bodies of ``probe_kernel`` (``pallas_call`` at
   ``:72``) on the card: ``k_flat`` (a flat take of [8, B] from a
   [4096, 128] table) as K2, ``k_rows`` (the rows' lane sums) as K1 with
   ``lane_sum`` (the [8, B] broadcast is a view), ``k_lane``
   (take_along_axis on lanes) as K2 on axis 1 and ``k_onehot`` (a one-hot
   matmul of a 128-row table; an index past it gives a zero row) as K1.
"""

from __future__ import annotations

import argparse

import torch

from jnerf_tpu_torch.tools.archive import common

MATMUL = 4096
SCALE_SHAPE = (256, 1024, 256)  # 256 MB of f32
N, M = 262144, 1 << 19
B = 32768
SMALL = 128


def _line(p, name, ms, items, nbytes, ran, unit="rows", **kw):
    return p.emit(name, f"{name}: {ms:.2f} ms", ms, items, nbytes, ran,
                  unit=unit, **kw)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    from jnerf_tpu_torch.ops.envelope import elem_gather, row_gather

    p = common.start(args.cpu, "probe_tpu")
    a = p.randn(MATMUL, MATMUL, dtype=torch.bfloat16)
    b = p.randn(MATMUL, MATMUL, dtype=torch.bfloat16)
    flops = 2 * MATMUL ** 3
    ms = p.time(lambda: torch.matmul(a, b))
    _line(p, f"matmul {MATMUL} bf16", ms, flops, 3 * MATMUL * MATMUL * 2,
          "library: torch.matmul", unit="FLOP", flops=flops)
    print(f"  -> {flops / ms / 1e9:.1f} TFLOP/s", flush=True)
    x = p.randn(*SCALE_SHAPE)
    nb = 2 * x.numel() * 4
    ms = p.time(lambda: x * 1.000001)
    _line(p, "scale 256MB", ms, nb, nb, "library: elementwise scale", unit="B")
    print(f"  -> {nb / ms / 1e6:.0f} GB/s", flush=True)
    del a, b, x

    tbl = p.randn(M)
    idx = p.tensor(common.uniform_idx(N * 128, M).reshape(N, 128))
    idx64 = idx.long()
    _line(p, "xla take [N,128] of [512k]",
          p.time(lambda: torch.take(tbl, idx64)), idx.numel(),
          common.elem_bytes(idx, common.distinct(idx)), "library: torch.take",
          unit="elem")
    srt = torch.sort(idx64, dim=0).values
    _line(p, "xla take col-sorted idx", p.time(lambda: torch.take(tbl, srt)),
          idx.numel(), common.elem_bytes(idx, common.distinct(idx)),
          "library: torch.take", unit="elem")
    del idx, idx64, srt
    tbl2d = tbl.reshape(-1, 128)
    ridx = p.tensor(common.uniform_idx(N, tbl2d.shape[0], seed=1))
    _line(p, "xla row-gather [N]x128",
          p.time(lambda: tbl2d.index_select(0, ridx)), N,
          common.gather_bytes(N, 512, common.distinct(ridx)),
          "library: index_select")

    pos_idx = p.tensor(common.uniform_idx(8 * B, M, seed=2).reshape(8, B))
    _line(p, "pallas take flat [8,B] of 512k",
          p.time(lambda: elem_gather(tbl2d, pos_idx, "flat")), 8 * B,
          common.elem_bytes(pos_idx, common.distinct(pos_idx)), "K2 (flat)",
          unit="elem")
    rowi = p.tensor(common.uniform_idx(B, tbl2d.shape[0], seed=3))
    _line(p, "pallas take rows [B] of [4096,128]",
          p.time(lambda: row_gather(tbl2d, rowi, lane_sum=True)
                 .expand(8, -1)), B,
          common.gather_bytes(B, 512, common.distinct(rowi), out_row_bytes=4),
          "K1 (lane sum)")
    vals = p.randn(B, 128)
    li = p.tensor(common.uniform_idx(B * 128, 128, seed=4).reshape(B, 128))
    _line(p, "pallas take_along_axis lanes [B,128]",
          p.time(lambda: elem_gather(vals, li, "axis1")), B * 128,
          common.elem_bytes(li, common.distinct_along(li, 1)), "K2 (axis 1)",
          unit="elem")
    small = p.randn(SMALL, 128)
    inside = rowi[rowi < SMALL]
    _line(p, "pallas one-hot matmul 128-table",
          p.time(lambda: row_gather(small, rowi)), B,
          common.gather_bytes(B, 512, common.distinct(inside)),
          "K1 (an index past the table gives a zero row)")
    print(f"probe complete; backend: {p.device.type}", flush=True)
    return p.lines


if __name__ == "__main__":
    main()

"""Chained calibration, the XLA gathers and the Mosaic 2-D gather forms:
the counterpart of `tools/archive/probe_tpu2.py`.

    python3 -m jnerf_tpu_torch.tools.archive.probe_tpu2 [--cpu]

1-6. a 4096^3 bf16 matmul, an elementwise scale of 128 MB, and the XLA
   row gather, element gather and take_along_axis on axes 1 and 0 at
   262,144 x 128 f32, as PyTorch calls (``index_select``, ``torch.take``,
   ``torch.gather``): library yardsticks;
7. the Pallas bodies of ``probe_pallas`` (``pallas_call`` at ``:93``) on
   the card: ``k_tala0`` (take_along_axis on axis 0, [8192, 128] from a
   [512, 128] and from a [4096, 128] table) and ``k_tala1`` (on axis 1)
   as K2, ``k_rowtake`` (a row take of [8192] from [4096, 128]) as K1.
"""

from __future__ import annotations

import argparse

import torch

from jnerf_tpu_torch.tools.archive import common

MATMUL = 4096
SCALE_SHAPE = (4096, 8192)
R, T = 262144, 8192
FLAT = 1 << 19
B = 8192
SMALL_T, BIG_T = 512, 4096


def _line(p, name, ms, items, nbytes, ran, unit, **kw):
    return p.emit(name, f"{name}: {ms:.3f} ms/call -> "
                  f"{items / ms / 1e6:.2f} G{unit}/s", ms, items, nbytes, ran,
                  unit=unit, **kw)


def _pallas(p, desc, ms, items, nbytes, ran, unit):
    return p.emit(f"pallas {desc}", f"pallas {desc}: OK ~{ms:.2f} ms/call",
                  ms, items, nbytes, ran, unit=unit)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    from jnerf_tpu_torch.ops.envelope import elem_gather, row_gather

    p = common.start(args.cpu, "probe_tpu2")
    a = p.randn(MATMUL, MATMUL, dtype=torch.bfloat16)
    flops = 2 * MATMUL ** 3
    _line(p, "matmul4096", p.time(lambda: torch.matmul(a, a)), flops,
          3 * MATMUL * MATMUL * 2, "library: torch.matmul", "FLOP",
          flops=flops)
    x = p.randn(*SCALE_SHAPE)
    nb = 2 * x.numel() * 4
    _line(p, "scale128MB", p.time(lambda: x * 1.000001), nb, nb,
          "library: elementwise scale", "B")
    del a, x

    tbl = p.randn(T, 128)
    ridx = p.tensor(common.uniform_idx(R, T))
    _line(p, "xla row-gather 262k x 128f32",
          p.time(lambda: tbl.index_select(0, ridx)), R * 512,
          common.gather_bytes(R, 512, common.distinct(ridx)),
          "library: index_select", "B(rows)")
    flat = p.randn(FLAT)
    eidx = p.tensor(common.uniform_idx(R * 128, FLAT, seed=1).reshape(R, 128))
    e64 = eidx.long()
    _line(p, "xla elem-gather 33.5M", p.time(lambda: torch.take(flat, e64)),
          R * 128, common.elem_bytes(eidx, common.distinct(eidx)),
          "library: torch.take", "elem")
    del eidx, e64
    vals = p.randn(R, 128)
    li = p.tensor(common.uniform_idx(R * 128, 128, seed=2).reshape(R, 128))
    l64 = li.long()
    _line(p, "xla tala axis1 33.5M",
          p.time(lambda: torch.gather(vals, 1, l64)), R * 128,
          common.elem_bytes(li, common.distinct_along(li, 1)),
          "library: torch.gather", "elem")
    del li, l64
    ri = p.tensor(common.uniform_idx(R * 128, R, seed=3).reshape(R, 128))
    r64 = ri.long()
    _line(p, "xla tala axis0 33.5M",
          p.time(lambda: torch.gather(vals, 0, r64)), R * 128,
          common.elem_bytes(ri, common.distinct_along(ri, 0)),
          "library: torch.gather", "elem")
    del ri, r64, vals

    tblp = p.randn(SMALL_T, 128)
    idx_r = p.tensor(common.uniform_idx(B * 128, SMALL_T, seed=4)
                     .reshape(B, 128))
    _pallas(p, f"tala axis0 [8k,128] from [{SMALL_T},128]",
            p.time(lambda: elem_gather(tblp, idx_r, "axis0")), B * 128,
            common.elem_bytes(idx_r, common.distinct_along(idx_r, 0)),
            "K2 (axis 0)", "elem")
    tblp2 = p.randn(B, 128)
    idx_l = p.tensor(common.uniform_idx(B * 128, 128, seed=5).reshape(B, 128))
    _pallas(p, "tala axis1 [8k,128] lanes",
            p.time(lambda: elem_gather(tblp2, idx_l, "axis1")), B * 128,
            common.elem_bytes(idx_l, common.distinct_along(idx_l, 1)),
            "K2 (axis 1)", "elem")
    tbl_big = p.randn(BIG_T, 128)
    idx_rb = p.tensor(common.uniform_idx(B * 128, BIG_T, seed=6)
                      .reshape(B, 128))
    _pallas(p, f"tala axis0 [8k,128] from [{BIG_T},128]",
            p.time(lambda: elem_gather(tbl_big, idx_rb, "axis0")), B * 128,
            common.elem_bytes(idx_rb, common.distinct_along(idx_rb, 0)),
            "K2 (axis 0)", "elem")
    col0 = idx_rb[:, 0].contiguous()
    _pallas(p, f"take rows [B] from [{BIG_T},128]",
            p.time(lambda: row_gather(tbl_big, col0)), B,
            common.gather_bytes(B, 512, common.distinct(col0)), "K1", "rows")
    print(f"done; backend: {p.device.type}", flush=True)
    return p.lines


if __name__ == "__main__":
    main()

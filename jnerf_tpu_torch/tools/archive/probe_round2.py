"""What random-access primitive the card offers: the counterpart of
`tools/archive/probe_round2.py`.

    python3 -m jnerf_tpu_torch.tools.archive.probe_round2 \
        [--section {stream,xla,pallas_rate,all}] [--cpu] \
        [--table-rows 19,20,21,22] [--row-bytes 16,32] \
        [--pattern uniform,clustered] [--l2 warm,flushed] [--accesses 22]

Sections, as in the archive:
- ``stream``: an elementwise scale of 128 MB and a 4096^3 bf16 matmul, as
  PyTorch calls (calibration yardsticks);
- ``xla``: the XLA row gathers (two widths, and with sorted indices), the
  row scatter-add, argsort + gather + segment sum, and argsort alone, as
  ``index_select``, ``index_add_`` and ``torch.sort`` (library
  yardsticks); 4M accesses into 2^16 bf16 rows of 256 and 32 bytes;
- ``pallas_rate``: the archive's Pallas kernels on the card: the
  scalar-loop row gather (``k_loop``, ``pallas_call`` at ``:138``) and the
  gather times w (``k_fused``, ``:177``) as K1, the read-modify-write
  scatter-add (``k_scat``, ``:212``) as K3 and the lane gather
  (``k_lane``, ``:240``) as K2 on axis 1; 2^20 accesses into a [4096, 128]
  f32 table.

The card's own shapes: ``--table-rows`` (log2 of the table's rows, a
list), ``--row-bytes`` (f32 rows of that many bytes, a multiple of 16),
``--pattern`` (``uniform``, or ``clustered``: probe_rmw's run-length
stream), ``--l2`` (``warm``: launches back to back; ``flushed``: each
launch after a write that clears the L2) and ``--accesses`` (log2 of N)
replace the row sections' shapes by every combination of their values;
without them the sections run at the archive's sizes.
"""

from __future__ import annotations

import argparse
import itertools
from typing import NamedTuple

import torch

from jnerf_tpu_torch.tools.archive import common

STREAM_SHAPE = (4096, 8192)  # 128 MB of f32
MATMUL = 4096
XLA_N, XLA_T = 1 << 22, 1 << 16
RATE_N, RATE_T = 1 << 20, 4096
LANE_M = 1 << 20


class Shape(NamedTuple):
    n: int
    t: int
    row_bytes: int
    dtype: torch.dtype
    pattern: str
    flush: bool
    tag: str  # "" at the archive's sizes

    @property
    def width(self):
        return self.row_bytes // (2 if self.dtype == torch.bfloat16 else 4)


def _line(p, name, ms, items, nbytes, ran, unit="rows", shape=None, **kw):
    rec = p.emit(name, f"{name}: {ms:.3f} ms/call -> "
                 f"{items / ms / 1e6:.3f} G{unit}/s", ms, items, nbytes, ran,
                 unit=unit, **kw)
    if shape is not None:
        rec.update(n=shape.n, table_rows=shape.t, row_bytes=shape.row_bytes,
                   pattern=shape.pattern,
                   l2="flushed" if shape.flush else "warm")
    return rec


def section_stream(p):
    print("== streaming / compute ==", flush=True)
    x = p.randn(*STREAM_SHAPE)
    nb = 2 * x.numel() * 4
    _line(p, "scale 128MB r+w", p.time(lambda: x * 1.000001), nb, nb,
          "library: elementwise scale", unit="B")
    a = p.randn(MATMUL, MATMUL, dtype=torch.bfloat16)
    flops = 2 * MATMUL ** 3
    _line(p, f"matmul {MATMUL} bf16", p.time(lambda: torch.matmul(a, a)),
          flops, 3 * MATMUL * MATMUL * 2, "library: torch.matmul",
          unit="FLOP", flops=flops)


def _idx(p, s: Shape):
    return p.tensor(common.index_stream(s.pattern, s.n, s.t))


def section_xla(p, shapes):
    print("== XLA gather/scatter at hash-step scale ==", flush=True)
    for s in shapes:
        idx = _idx(p, s)
        tbl = p.randn(s.t, s.width, dtype=s.dtype)
        tname = "bf16" if s.dtype == torch.bfloat16 else "f32"
        _line(p, f"row gather [{s.t},{s.width}] {tname}{s.tag}",
              p.time(lambda: tbl.index_select(0, idx).float().sum(dim=1),
                     s.flush), s.n,
              common.gather_bytes(s.n, s.row_bytes, common.distinct(idx),
                                  out_row_bytes=4),
              "library: index_select + row sum", shape=s)
    # The archive runs the rest at its first width only.
    for s in shapes if shapes[0].tag else shapes[:1]:
        idx = _idx(p, s)
        read = common.distinct(idx)
        tbl = p.randn(s.t, s.width, dtype=s.dtype)
        srt = torch.sort(idx).values
        _line(p, f"row gather sorted-flag{s.tag}",
              p.time(lambda: tbl.index_select(0, srt).float().sum(dim=1),
                     s.flush), s.n,
              common.gather_bytes(s.n, s.row_bytes, read, out_row_bytes=4),
              "library: index_select of sorted indices + row sum", shape=s)
        vals = torch.ones((s.n, s.width), dtype=s.dtype, device=p.device)
        scat = common.scatter_bytes(s.n, s.row_bytes, s.t)
        _line(p, f"row scatter-add{s.tag}",
              p.time(lambda: torch.zeros((s.t, s.width), dtype=s.dtype,
                                         device=p.device)
                     .index_add_(0, idx, vals).float(), s.flush), s.n, scat,
              "library: index_add_", shape=s)

        def seg():
            order = torch.argsort(idx)
            v = vals.index_select(0, order)
            return torch.zeros((s.t, s.width), dtype=s.dtype,
                               device=p.device).index_add_(
                0, idx.index_select(0, order), v).float()

        _line(p, f"argsort+gather+segsum scatter{s.tag}", p.time(seg, s.flush),
              s.n, scat, "library: argsort + index_select + index_add_",
              shape=s)
        _line(p, f"argsort {s.n >> 20}M int32 alone{s.tag}",
              p.time(lambda: torch.argsort(idx).float(), s.flush), s.n,
              8 * s.n, "library: argsort", unit="elem", shape=s)


def section_pallas_rate(p, shapes):
    from jnerf_tpu_torch.ops.envelope import (
        elem_gather, row_gather, row_gather_plain, row_scatter_add,
    )

    print("== pallas rates ==", flush=True)
    for k, s in enumerate(shapes):
        idx = _idx(p, s)
        read = common.distinct(idx)
        tbl = p.randn(s.t, s.width)
        if k == 0:
            ok = torch.equal(row_gather(tbl, idx), row_gather_plain(tbl, idx))
            print("ds-loop gather correct:", ok, flush=True)
            p.lines.append(dict(name="ds-loop gather correct", ok=ok))
        _line(p, f"pallas ds-loop row gather (VMEM tbl){s.tag}",
              p.time(lambda: row_gather(tbl, idx), s.flush), s.n,
              common.gather_bytes(s.n, s.row_bytes, read), "K1", shape=s)
        w = p.randn(s.n, s.width)
        _line(p, f"pallas ds-loop gather*w{s.tag}",
              p.time(lambda: row_gather(tbl, idx, w), s.flush), s.n,
              common.gather_bytes(s.n, s.row_bytes, read,
                                  w_row_bytes=s.row_bytes), "K1 (with w)",
              shape=s)
        del w
        vals = p.randn(s.n, s.width)
        _line(p, f"pallas ds-loop row scatter-add{s.tag}",
              p.time(lambda: row_scatter_add(idx, vals, s.t), s.flush), s.n,
              common.scatter_bytes(s.n, s.row_bytes, s.t), "K3", shape=s)
        del vals, tbl
    t4 = p.randn(LANE_M // 128, 128)
    i4 = p.tensor(common.uniform_idx(LANE_M, 128).reshape(-1, 128))
    _line(p, "pallas lane dyn-gather (128-wide)",
          p.time(lambda: elem_gather(t4, i4, "axis1")), LANE_M,
          common.elem_bytes(i4, common.distinct_along(i4, 1)), "K2 (axis 1)",
          unit="elem")


def _ints(text):
    return [int(v) for v in text.split(",")]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--section", type=str, default="all",
                    choices=["all", "stream", "xla", "pallas_rate"])
    ap.add_argument("--table-rows", type=_ints, default=None,
                    help="log2 of the table's rows, comma-separated")
    ap.add_argument("--row-bytes", type=_ints, default=None)
    ap.add_argument("--pattern", type=lambda t: t.split(","), default=None)
    ap.add_argument("--l2", type=lambda t: t.split(","), default=None)
    ap.add_argument("--accesses", type=int, default=None,
                    help="log2 of the accesses N")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    if any(v not in ("uniform", "clustered") for v in args.pattern or ()) \
            or any(v not in ("warm", "flushed") for v in args.l2 or ()) \
            or any(b % 16 or b < 16 for b in args.row_bytes or ()):
        ap.error("--pattern takes uniform,clustered; --l2 warm,flushed; "
                 "--row-bytes multiples of 16")
    sized = any(v is not None for v in (args.table_rows, args.row_bytes,
                                        args.pattern, args.l2, args.accesses))

    def shapes(n, t, widths, dtype):
        if not sized:
            return [Shape(n, t, b, dtype, "uniform", False, "")
                    for b in widths]
        n = 1 << args.accesses if args.accesses is not None else n
        return [Shape(n, 1 << lt if args.table_rows else t, b, torch.float32,
                      pat, l2 == "flushed",
                      f" [{n} x {b} B from 2^"
                      f"{lt if args.table_rows else t.bit_length() - 1} rows, "
                      f"{pat}, L2 {l2}]")
                for lt, b, pat, l2 in itertools.product(
                    args.table_rows or [None], args.row_bytes or [widths[0]],
                    args.pattern or ["uniform"], args.l2 or ["warm"])]

    p = common.start(args.cpu, "probe_round2")
    print(f"backend: {p.device.type}", flush=True)
    secs = {
        "stream": lambda: section_stream(p),
        "xla": lambda: section_xla(p, shapes(XLA_N, XLA_T, [256, 32],
                                             torch.bfloat16)),
        "pallas_rate": lambda: section_pallas_rate(
            p, shapes(RATE_N, RATE_T, [512], torch.float32)),
    }
    for name, f in secs.items():
        if args.section in ("all", name):
            f()
    return p.lines


if __name__ == "__main__":
    main()

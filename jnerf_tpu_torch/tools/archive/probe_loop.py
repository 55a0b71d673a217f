"""Row gather and row scatter-add rates over a [65536, 128] f32 table: the
counterpart of `tools/archive/probe_loop.py`.

    python3 -m jnerf_tpu_torch.tools.archive.probe_loop [--cpu]

The archive's scalar-loop Pallas gather (``mk_gather``, ``pallas_call`` at
``:52``) is K1 (`ops/envelope.py::row_gather`) and its read-modify-write
scatter (``mk_scatter``, ``:100``) is K3 (``row_scatter_add``), N = 2^20
rows each.  The TPU's manual unrolls compute one function: one launch,
printed under every unroll.  The correctness lines hold each kernel to its
plain twin.
"""

from __future__ import annotations

import argparse

import torch

from jnerf_tpu_torch.tools.archive import common

T = 65536  # a [T, 128] f32 table is 32 MB
N = 1 << 20


def _line(p, name, ms, nbytes, ran):
    return p.emit(name, f"{name}: {ms:.3f} ms -> {N / ms / 1e6:.3f} Grows/s "
                  f"({ms * 1e6 / N:.2f} ns/row)", ms, N, nbytes, ran)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    from jnerf_tpu_torch.ops.envelope import (
        row_gather, row_gather_plain, row_scatter_add, row_scatter_add_plain,
    )

    p = common.start(args.cpu, "probe_loop")
    tbl = p.randn(T, 128)
    idx0 = p.tensor(common.uniform_idx(N, T))
    ok = torch.equal(row_gather(tbl, idx0), row_gather_plain(tbl, idx0))
    print("unroll8 gather correct:", ok, flush=True)
    p.lines.append(dict(name="unroll8 gather correct", ok=ok))
    touched = common.distinct(idx0)
    ms = p.time(lambda: row_gather(tbl, idx0))
    for unroll in (1, 4, 8, 16):
        _line(p, f"gather unroll={unroll}", ms,
              common.gather_bytes(N, 512, touched),
              "K1 (one kernel for every unroll)")

    vals = p.randn(N, 128)
    ok = bool(torch.allclose(row_scatter_add(idx0, vals, T),
                             row_scatter_add_plain(idx0, vals, T), atol=1e-3))
    print("unroll8 scatter correct:", ok, flush=True)
    p.lines.append(dict(name="unroll8 scatter correct", ok=ok))
    ms = p.time(lambda: row_scatter_add(idx0, vals, T))
    for unroll in (1, 8):
        _line(p, f"scatter unroll={unroll}", ms,
              common.scatter_bytes(N, 512, T),
              "K3 (one kernel for every unroll)")
    return p.lines


if __name__ == "__main__":
    main()

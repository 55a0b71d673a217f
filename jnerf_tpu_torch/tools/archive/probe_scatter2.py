"""Interleaved-accumulator scatter and the packed forward blend: the
counterpart of `tools/archive/probe_scatter2.py`.

    python3 -m jnerf_tpu_torch.tools.archive.probe_scatter2 [--cpu]

The archive's ``mk_scatter_k`` (``pallas_call`` at ``:55``) spread a
scatter over K = 2 or 4 VMEM accumulators, summed at the last grid step,
to break the TPU's read-after-write hazard; it computes one scatter-add,
here one launch of K3 (`ops/envelope.py::row_scatter_add`), checked on
8192 rows into 1024 and timed at 1M rows into [16384, 128] f32, printed
under both K.  The XLA forward blends over a [2^19, 128] bf16 packed table
(4M samples) run as PyTorch calls, printed as library yardsticks.
"""

from __future__ import annotations

import argparse

import torch

from jnerf_tpu_torch.tools.archive import common

CHECK_ROWS, CHECK_N = 1024, 8192
NL2, TL2 = 1 << 20, 16384
T, N = 1 << 19, 1 << 22


def _line(p, name, ms, items, nbytes, ran):
    return p.emit(name, f"{name}: {ms:.2f} ms -> {ms * 1e6 / items:.2f} "
                  "ns/item", ms, items, nbytes, ran)


def blend_inputs(p, t, n):
    """The packed table [t, 128] bf16, rows [n], slot b [n] in [0, 8) and
    corner weights w [n, 8]."""
    tbl = p.randn(t, 128, dtype=torch.bfloat16)
    rows = p.tensor(common.uniform_idx(n, t))
    b = p.tensor(common.uniform_idx(n, 8, seed=1))
    w = torch.rand((n, 8), generator=p.gen, device=p.device)
    return tbl, rows, b, w


def fwd_mask(tbl, rows, b, w, both=True):
    """The archive's ``fwd``: lane = corner * 16 + slot * 2 + feature;
    feature 0 alone unless ``both`` (probe_final.py's mask blend)."""
    lane = torch.arange(128, device=tbl.device)
    g = tbl.index_select(0, rows).float()
    sel = ((lane >> 1) & 7)[None, :] == b[:, None]
    wl = w[:, lane >> 4]
    weighted = torch.where(sel, g * wl, 0.0)
    f0 = torch.where((lane & 1)[None, :] == 0, weighted, 0.0).sum(dim=1)
    if not both:
        return f0
    f1 = torch.where((lane & 1)[None, :] == 1, weighted, 0.0).sum(dim=1)
    return f0, f1


def fwd_reshape(tbl, rows, b, w):
    """The archive's ``fwd2``: the same blend as a reshape and a sum."""
    g = tbl.index_select(0, rows).float().reshape(-1, 8, 8, 2)
    selb = torch.nn.functional.one_hot(b.long(), 8).float()[:, None, :, None]
    return (g * w[:, :, None, None] * selb).sum(dim=(1, 2))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    from jnerf_tpu_torch.ops.envelope import (
        row_scatter_add, row_scatter_add_plain,
    )

    p = common.start(args.cpu, "probe_scatter2")
    i0 = p.tensor(common.uniform_idx(CHECK_N, CHECK_ROWS))
    v0 = p.randn(CHECK_N, 128)
    ok = torch.allclose(row_scatter_add(i0, v0, CHECK_ROWS),
                        row_scatter_add_plain(i0, v0, CHECK_ROWS), atol=1e-3)
    print("interleaved scatter correct:", bool(ok), flush=True)
    p.lines.append(dict(name="interleaved scatter correct", ok=bool(ok)))

    idx2 = p.tensor(common.uniform_idx(NL2, TL2))
    vals2 = torch.ones((NL2, 128), device=p.device)
    ms = p.time(lambda: row_scatter_add(idx2, vals2, TL2))
    nbytes = common.scatter_bytes(NL2, 512, TL2)
    for K in (2, 4):
        _line(p, f"pallas K={K} interleaved scatter [1M]->[16K,128]", ms, NL2,
              nbytes, "K3 (one kernel for every K)")

    tbl, rows, b, w = blend_inputs(p, T, N)
    read = common.distinct(rows)
    # rows, b and w in, each distinct table row once, two f32 outputs.
    blend = common.gather_bytes(N, 256, read, out_row_bytes=8,
                                w_row_bytes=4 + 32)
    _line(p, "XLA fused fwd gather+blend [4M rows]",
          p.time(lambda: fwd_mask(tbl, rows, b, w)), N, blend,
          "library: index_select + masked blend")
    _line(p, "XLA fused fwd reshape variant",
          p.time(lambda: fwd_reshape(tbl, rows, b, w)), N, blend,
          "library: index_select + reshape blend")
    _line(p, "XLA gather alone [4M,128] bf16",
          p.time(lambda: tbl.index_select(0, rows).float().sum(dim=1)), N,
          common.gather_bytes(N, 256, read, out_row_bytes=4),
          "library: index_select + row sum")
    return p.lines


if __name__ == "__main__":
    main()

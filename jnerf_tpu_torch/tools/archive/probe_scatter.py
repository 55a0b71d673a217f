"""Scatter-add at the hash backward's shapes: the counterpart of
`tools/archive/probe_scatter.py`.

    python3 -m jnerf_tpu_torch.tools.archive.probe_scatter [--cpu]

The archive's XLA scatters (4M rows into 1M rows of 16 or 128 lanes, f32
and bf16; 16 per-level scatters of 256K into 64K) run as ``index_add_``,
printed as library yardsticks.  Its Pallas read-modify-write scatter
(``mk_scatter``, ``pallas_call`` at ``:72``) is K3
(`ops/envelope.py::row_scatter_add`): checked against its twin on 8192
rows into 1024 (the archive's check) and timed at 1M rows into [65536,
128] f32; the archive's unroll 8 and 16 are one launch, printed under both.
"""

from __future__ import annotations

import argparse

import torch

from jnerf_tpu_torch.tools.archive import common

N = 1 << 22
T = 1 << 20
NL, TL = 1 << 18, 1 << 16
CHECK_ROWS, CHECK_N = 1024, 8192
NL2, TL2 = 1 << 20, 65536


def _line(p, name, ms, items, nbytes, ran):
    return p.emit(name, f"{name}: {ms:.2f} ms -> {items / ms / 1e6:.3f} "
                  f"Grows/s ({ms * 1e6 / items:.2f} ns/row)", ms, items,
                  nbytes, ran)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    from jnerf_tpu_torch.ops.envelope import (
        row_scatter_add, row_scatter_add_plain,
    )

    p = common.start(args.cpu, "probe_scatter")
    idx = p.tensor(common.uniform_idx(N, T))
    for W in (16, 128):
        for dt in (torch.float32, torch.bfloat16):
            vals = torch.ones((N, W), dtype=dt, device=p.device)
            name = f"XLA scatter [{N >> 20}M]->[{T >> 10}K,{W}] {str(dt)[6:]}"
            ms = p.time(lambda: torch.zeros((T, W), dtype=dt, device=p.device)
                        .index_add_(0, idx, vals))
            esz = vals.element_size()
            _line(p, name, ms, N, common.scatter_bytes(N, W * esz, T),
                  "library: index_add_")
            del vals
    idxl = p.tensor(common.uniform_idx(NL, TL))
    valsl = torch.ones((NL, 16), device=p.device)

    def per_level():
        return sum(torch.zeros((TL, 16), device=p.device)
                   .index_add_(0, (idxl + 37 * k) % TL, valsl)[:1]
                   for k in range(16))

    ms = p.time(per_level)
    _line(p, "XLA per-level scatter x16 [256K]->[64K,16] f32", ms, NL * 16,
          16 * common.scatter_bytes(NL, 64, TL),
          "library: 16 index_add_")

    i0 = p.tensor(common.uniform_idx(CHECK_N, CHECK_ROWS))
    v0 = p.randn(CHECK_N, 128)
    ok = torch.allclose(row_scatter_add(i0, v0, CHECK_ROWS),
                        row_scatter_add_plain(i0, v0, CHECK_ROWS), atol=1e-3)
    print("pallas scatter correct:", bool(ok), flush=True)
    p.lines.append(dict(name="pallas scatter correct", ok=bool(ok)))

    idx2 = p.tensor(common.uniform_idx(NL2, TL2))
    vals2 = torch.ones((NL2, 128), device=p.device)
    ms = p.time(lambda: row_scatter_add(idx2, vals2, TL2))
    nbytes = common.scatter_bytes(NL2, 512, TL2)
    for unroll in (8, 16):
        _line(p, f"pallas RMW scatter unroll={unroll} [1M]->[64K,128] f32", ms,
              NL2, nbytes, "K3 (one kernel for both unrolls)")
    return p.lines


if __name__ == "__main__":
    main()

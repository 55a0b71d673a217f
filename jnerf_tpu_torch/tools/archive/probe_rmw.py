"""The row scatter-add at the hash backward's shapes: the counterpart of
`tools/archive/probe_rmw.py`.

    python3 -m jnerf_tpu_torch.tools.archive.probe_rmw [plain slab unroll16 wide] [--cpu]

N = 2^21 rows of 128 f32 added into a [32768, 128] accumulator at the
archive's ray-coherent rows (its numpy stream from seed 0, the same rows).
The TPU modes (plain, slab, unroll16, wide) cut the vector ops the TPU
issued a row and compute one function: here each is one launch of K3
(`ops/envelope.py::row_scatter_add`), timed once and printed under every
mode asked for.
"""

from __future__ import annotations

import argparse

from jnerf_tpu_torch.tools.archive import common

N = 1 << 21
ROWS = 32768
MODES = ("plain", "slab", "unroll16", "wide")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("modes", nargs="*", metavar="mode",
                    help=f"any of {', '.join(MODES)} (all by default)")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    if set(args.modes) - set(MODES):
        ap.error(f"modes are {', '.join(MODES)}")
    from jnerf_tpu_torch.ops.envelope import row_scatter_add

    p = common.start(args.cpu, "probe_rmw")
    rows = p.tensor(common.clustered_rows(N, ROWS))
    vals = p.randn(N, 128)
    ms = p.time(lambda: row_scatter_add(rows, vals, ROWS))
    nbytes = common.scatter_bytes(N, 512, ROWS)
    for mode in args.modes or MODES:
        p.emit(f"rmw {mode}", f"rmw {mode}: {ms:.2f} ms -> "
               f"{ms * 1e6 / N:.2f} ns/row", ms, N, nbytes,
               "K3 (one kernel for every TPU mode)")
    return p.lines


if __name__ == "__main__":
    main()

"""Library scatter-add into small per-level operands: the counterpart of
`tools/archive/probe_scatter3.py`.

    python3 -m jnerf_tpu_torch.tools.archive.probe_scatter3 [f32 bf16 f32half] [--cpu]

L = 16 levels, each ``index_add_`` of N = 2^18 rows of 16 values into a
fresh [E, 16] accumulator at uniform rows (numpy, a seed a level):

  f32      E = 2^18, f32 (16 MB)
  bf16     E = 2^18, bf16 (8 MB)
  f32half  E = 2^17, f32 (8 MB)

These lines time PyTorch's scatter-add on purpose, as the archive timed
XLA's: measurements of the library, not ports of a kernel.  Each gives
the archive's ms for the 16 levels and ns a row, then the rate, the bytes
(`common.py`: each level's indices, values and accumulator) and the
bound.
"""

from __future__ import annotations

import argparse

import torch

from jnerf_tpu_torch.tools.archive import common

N = 1 << 18
L = 16
SECTIONS = {"f32": ("16x scatter [262K]->[262K,16] f32 (16MB)", 1 << 18,
                    torch.float32),
            "bf16": ("16x scatter [262K]->[262K,16] bf16 (8MB)", 1 << 18,
                     torch.bfloat16),
            "f32half": ("16x scatter [262K]->[128K,16] f32 (8MB)", 1 << 17,
                        torch.float32)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    common.section_arg(ap, tuple(SECTIONS), tuple(SECTIONS))
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    p = common.start(args.cpu, "probe_scatter3")

    def run(key):
        name, E, dtype = SECTIONS[key]
        idxs = [p.tensor(common.uniform_idx(N, E, seed=i)).long()
                for i in range(L)]
        vals = p.randn(N, 16).to(dtype)

        def levels():
            for i in idxs:
                torch.zeros((E, 16), dtype=dtype,
                            device=p.device).index_add_(0, i, vals)

        ms = p.time(levels)
        rb = 16 * dtype.itemsize
        p.emit(name, f"{name}: {ms:.1f} ms ({ms * 1e6 / (N * L):.2f} ns/row)",
               ms, N * L, L * common.scatter_bytes(N, rb, E),
               "library: index_add_, a fresh accumulator a level",
               dtype=str(dtype).split(".")[1], table_rows=E)

    common.run_sections(args.sections, tuple(SECTIONS),
                        {k: (lambda k=k: run(k)) for k in SECTIONS}, {}, p)
    return p.lines


if __name__ == "__main__":
    main()

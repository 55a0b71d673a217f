"""Kernel B called directly at several specs and sizes, between guard
zones: the counterpart of `tools/archive/probe_bwd_debug.py` (a hunt for
a crash of the TPU's backward kernel).

    python3 -m jnerf_tpu_torch.tools.archive.probe_bwd_debug [cap18-small cap18-full nocap-small] [--cpu]

Cases, 16 levels x 2 features, log2 19: cap18-small (hashed levels capped
at 2^18 entries, N = 2^15), cap18-full (the same, N = 2^18), nocap-small
(no extra cap, N = 2^15); positions uniform and the upstream gradient
N(0, 1e-4), drawn with numpy.  Kernel B (`ops/hash_nbr.py::grad_table`)
writes its output and its work space inside buffers with ``GUARD``
entries of a sentinel on both sides (as the card test of K4 does,
`tests/test_torch_cuda.py::test_packed_hash_scatter_writes_inside_its_buffers`).
A case is OK when every guard still holds the sentinel and the output
equals ``grad_table_plain`` on CPU copies bit for bit (kernel B sums in
its twin's order).  Each case prints the archive's line (``OK sum=...``
or ``FAILED ...``) and its seconds; any FAILED exits with status 1.
"""

from __future__ import annotations

import argparse
import time

import torch

from jnerf_tpu_torch.tools.archive import common

LEVELS, LOG2 = 16, 19
CASES = {"cap18-small": (1 << 18, 1 << 15), "cap18-full": (1 << 18, 1 << 18),
         "nocap-small": (None, 1 << 15)}
GUARD = 4096
SENTINEL = -7


def spec_of(case: str):
    from jnerf_tpu_torch.ops.hash_grid import HashGridSpec

    return HashGridSpec(n_levels=LEVELS, log2_hashmap_size=LOG2,
                        max_level_size=CASES[case][0])


def guarded(size: int, dtype, device):
    """(buffer, its inside view of ``size`` entries): ``GUARD`` entries of
    ``SENTINEL`` on each side."""
    buf = torch.full((size + 2 * GUARD,), SENTINEL, dtype=dtype,
                     device=device)
    return buf, buf[GUARD:GUARD + size]


def guards_hold(buf) -> bool:
    return bool((buf[:GUARD] == SENTINEL).all()
                and (buf[-GUARD:] == SENTINEL).all())


def run_case(p, case: str) -> dict:
    from jnerf_tpu_torch.ops.hash_nbr import (
        bwd_layout, grad_table, grad_table_plain,
    )

    spec = spec_of(case)
    n = CASES[case][1]
    F = spec.n_features_per_level
    pos = p.tensor(common.uniform((n, 3)))
    g = p.tensor(common.normal((n, F * spec.n_levels), 0.01, seed=1))
    t0 = time.perf_counter()
    out_buf, out = guarded(spec.n_entries * F, torch.float32, p.device)
    out = out.view(spec.n_entries, F)
    work_buf = work = None
    if p.device.type == "cuda":
        work_buf, work = guarded(bwd_layout(spec, n, False)[0], torch.int32,
                                 p.device)
    grad_table(spec, pos, g, out=out, work=work)
    p.sync()
    secs = time.perf_counter() - t0
    bufs = [b for b in (out_buf, work_buf) if b is not None]
    intact = all(guards_hold(b) for b in bufs)
    equal = torch.equal(out.cpu(), grad_table_plain(spec, pos.cpu(), g.cpu()))
    ok = intact and equal
    text = (f"{case}: OK sum={float(out.sum()):.4f} ({secs:.1f}s)" if ok else
            f"{case}: FAILED guards intact {intact}, equal to the twin "
            f"{equal} ({secs:.1f}s)")
    return p.line(case, text, secs * 1e3,
                  "kernel B (grad_table) into guarded buffers, held to "
                  "grad_table_plain on CPU copies", ok=ok, guards=intact,
                  equal=equal, n=n, n_entries=spec.n_entries, clock="host")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    common.section_arg(ap, tuple(CASES), tuple(CASES))
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    p = common.start(args.cpu, "probe_bwd_debug")
    common.run_sections(args.sections, tuple(CASES),
                        {c: (lambda c=c: run_case(p, c)) for c in CASES}, {},
                        p)
    if not all(ln["ok"] for ln in p.lines):
        raise SystemExit(1)
    return p.lines


if __name__ == "__main__":
    main()

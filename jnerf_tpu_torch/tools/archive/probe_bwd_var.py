"""Variants of the packed hash-gradient scatter at the reference's f2l16
shapes: the counterpart of `tools/archive/probe_bwd_var.py`.

    python3 -m jnerf_tpu_torch.tools.archive.probe_bwd_var [noscat novals v2d alt2 v3d]
        [--split] [--cpu]

At 16 levels of 2 features, ``log2_hashmap_size`` 19 and a 2^18-entry
level cap (ROWS = 32768 packed rows of 8 entries a level), N = 2^18
uniform samples and g ~ 0.01 N(0, 1) (numpy, seed 0): the archive's
``make`` (``pallas_call`` at ``:101``, contributions from ``vals_phase``
``:40``) is K4 (`ops/envelope.py::packed_hash_scatter`) in its variants
``v2d``, ``alt2`` (two accumulators), ``novals`` (ones) and ``noscat``
(the contribution pass without the scatter), at the tile height
``envelope.k4_tile_rows`` chooses for each.  Each (level, sample)'s row
and slot come from the port's own hash (``packed_rows_slots``).  ``v3d``
(the archive's library path) is the port's kernel B
(``hash_nbr.grad_table``) on the same samples.  ``--split`` prints each
variant's kernels, device µs a call (the profiler's sums over 10 calls;
on the card only).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from jnerf_tpu_torch.tools.archive import common

N = 1 << 18
BLK = 8192
SPEC = dict(n_levels=16, log2_hashmap_size=19, max_level_size=1 << 18)
VARIANTS = ("noscat", "novals", "v2d", "alt2", "v3d")


def inputs(p, spec):
    """pos [N, 3] uniform and g [N, 2L] ~ 0.01 N(0, 1), numpy at seed 0,
    and each (level, sample)'s packed row and slot [L, N]."""
    from jnerf_tpu_torch.ops.envelope import packed_rows_slots

    rng = np.random.default_rng(0)
    pos = p.tensor(rng.uniform(size=(N, 3)).astype(np.float32))
    g = p.tensor((rng.normal(size=(N, 2 * spec.n_levels)) * 0.01)
                 .astype(np.float32))
    rows, slots = packed_rows_slots(spec, pos)
    return pos, g, rows.contiguous(), slots.contiguous()


def k4_bytes(L, n, n_rows, n_acc, mode):
    """K4's least traffic, counted as kernel B's bound counts it: each
    input the mode's function reads, once, and its output written once.
    v2d reads pos, g, rows and slots (12 + 16 L bytes a sample); novals
    the rows alone (4 L); noscat pos and g (12 + 8 L) and the slots of each
    block's first sample, and writes its 64-byte contribution a (level,
    sample) to scratch beside the output.  The output is L * n_acc *
    n_rows rows of 512 bytes."""
    out = L * n_acc * n_rows * 512
    if mode == "novals":
        return 4 * L * n + out
    if mode == "noscat":
        return 12 * n + 8 * L * n + 4 * L * -(-n // BLK) + 64 * L * n + out
    return 12 * n + 16 * L * n + out


def kernel_split(fn, device, reps: int = 10) -> dict:
    """{kernel: device µs a call} of ``reps`` calls of ``fn`` under the
    profiler, in launch order; {} on the CPU."""
    if device.type != "cuda":
        return {}
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    fn()
    torch.cuda.synchronize(device)
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize(device)
    split = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA \
                and not e.is_user_annotation:
            name = e.name.replace("(anonymous namespace)::", "")
            name = name.replace("void ", "").split("(")[0]
            split[name] = split.get(name, 0.0) + e.time_range.elapsed_us() / reps
    return split


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="*", metavar="variant",
                    help=f"any of {', '.join(VARIANTS)} (all but v3d by "
                    "default)")
    ap.add_argument("--split", action="store_true",
                    help="print each variant's kernels' device time")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    if set(args.variants) - set(VARIANTS):
        ap.error(f"variants are {', '.join(VARIANTS)}")
    from jnerf_tpu_torch.ops import envelope, hash_nbr
    from jnerf_tpu_torch.ops.hash_grid import HashGridSpec

    p = common.start(args.cpu, "probe_bwd_var")
    spec = HashGridSpec(**SPEC)
    L, n_rows = spec.n_levels, max(spec.level_sizes) // 8
    scales = np.asarray(spec.scales, np.float32)
    pos, g, rows, slots = inputs(p, spec)
    for v in args.variants or VARIANTS[:4]:
        if v == "v3d":
            def run():
                return hash_nbr.grad_table(spec, pos, g)

            ms = p.time(run)
            F = spec.n_features_per_level
            p.emit(v, f"v3d (library): {ms:.1f} ms", ms, N * L,
                   12 * N + 4 * F * L * N + 4 * F * spec.n_entries,
                   "kernel B (hash_nbr.grad_table)")
        else:
            n_acc = 2 if v == "alt2" else 1
            mode = "v2d" if v == "alt2" else v

            def run():
                return envelope.packed_hash_scatter(
                    pos, g, rows, slots, scales, n_rows, n_acc, mode, BLK)

            ms = p.time(run)
            tile_rows = (None if mode == "noscat" else
                         envelope.k4_tile_rows(n_acc, mode))
            tile = f", {tile_rows}-row tiles" if tile_rows else ""
            p.emit(v, f"{v}: {ms:.1f} ms ({ms * 1e6 / (N * L):.2f} ns/row)",
                   ms, N * L, k4_bytes(L, N, n_rows, n_acc, mode),
                   f"K4 ({mode}, {n_acc} accumulator{'s' * (n_acc > 1)}"
                   f"{tile})", tile_rows=tile_rows)
        if args.split:
            split = kernel_split(run, p.device)
            p.lines[-1]["split_us"] = split
            print("  kernels, device us a call: " + ", ".join(
                f"{k} {x:.1f}" for k, x in split.items()), flush=True)
    return p.lines


if __name__ == "__main__":
    main()

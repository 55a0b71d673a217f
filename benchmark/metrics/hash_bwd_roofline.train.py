"""Kernel B's share of its roofline over the traced training window: the
least time its launches could take (one a step, over the step's model rows:
positions and float32 upstream gradient in, the whole table gradient out;
`work.hash_bwd_bound_s`) over the device time of its kernels (the prep,
bin, scan, gather, piece and sum kernels of the program's hash library)."""

from benchmark import work

KERNELS = ("hash_prep_kernel", "hash_gather_kernel", "hash_piece_kernel",
           "hash_sum_kernel", "bin_count", "bin_scatter", "scan_reduce",
           "scan_top", "scan_down", "key_runs")


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or not ctx.get("steps"):
        return None
    t = tr.op_seconds(lambda n: any(k in n for k in KERNELS))
    if t <= 0:
        return None
    grid = ctx["field"].grid
    rows = ctx["shape"][0] * ctx["shape"][1]
    bound = ctx["steps"] * work.hash_bwd_bound_s(rows, grid.L, grid.F,
                                                 grid.n_entries)
    return 100.0 * bound / t

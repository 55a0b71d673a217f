"""Kernel F's share of its roofline over the traced training window: the
least time its launches could take over the device time of
``hash_fwd_kernel``.  Kernel F runs once a step on the step's model rows
and, at each window's grid refresh, on the swept cells in chunks of 2^17.
A launch reads the positions, each table row its corners touch once, and
writes a bfloat16 encoding (`work.hash_fwd_bound_s`).  The rows a launch
touches are counted on inputs like the window's: one batch marched on the
program's occupancy bitfield at the window's end, and one refresh's chunks
of jittered cells, drawn from the run's seed."""

import torch

from benchmark import reference, work

CHUNK = 1 << 17


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or not ctx.get("steps") or ctx.get("bits") is None:
        return None
    t = tr.op_seconds(lambda n: "hash_fwd_kernel" in n)
    if t <= 0:
        return None
    grid, cfg, dev = ctx["field"].grid, ctx["cfg"], ctx["bits"].device
    geom = reference.geom_of(cfg)
    gen = torch.Generator(dev).manual_seed(ctx["seeds"]["sample"])
    rays, per_ray = ctx["shape"]
    scene = ctx["ref_scene"]
    idx = torch.randint(0, scene.pixels.shape[0], (rays,), generator=gen,
                        device=dev)
    o, d = reference.pixel_rays(scene, idx)
    u = torch.rand((rays,), generator=gen, device=dev)
    pos = reference.march(geom, ctx["bits"], o, d, u, per_ray)[0]
    step = work.hash_fwd_bound_s(rays * per_ray, grid.L, grid.F,
                                 work.rows_read(grid, pos.reshape(-1, 3)))
    g = geom.grid
    half = torch.arange(g ** 3 // 2, device=dev)
    refresh = 0.0
    for a in range(0, half.numel(), CHUNK):
        lin = half[a:a + CHUNK]
        cells = torch.stack([lin // (g * g), (lin // g) % g, lin % g], -1)
        pts = (cells.float() + torch.rand(cells.shape, generator=gen,
                                          device=dev)) / g
        refresh += work.hash_fwd_bound_s(lin.numel(), grid.L, grid.F,
                                         work.rows_read(grid, pts))
    windows = ctx["steps"] // ctx["steps_per_window"]
    return 100.0 * (ctx["steps"] * step + windows * refresh) / t

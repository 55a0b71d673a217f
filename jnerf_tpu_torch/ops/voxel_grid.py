"""Voxel-grid sampling and rendering for the Plenoxels family.

Counterpart of `jnerf_tpu/ops/voxel_grid.py`, function by function.  The
function is ported, not the TPU layout: the JAX code concatenates density
and SH into one [X, Y, Z, 28] grid at every call (a 1.9 GB copy a step at
256^3) to gather 28-channel rows; here the two tables are gathered apart
with the same corner indices and weights, which gives the same values.

The 8-corner trilinear gather is one autograd function, `corner_gather`:
its forward sums ``w_c * table[idx_c]`` over the corners in the JAX code's
order, and its backward is `corner_grad` (with plain indexing, autograd
would build one full-size gradient table per corner: eight 1.8 GB SH
tables at 256^3).  On the card that is kernel V (`csrc/voxel_grid.cu`),
the counterpart of the XLA scatter that autodiff makes of the JAX code's
``jnp.take``: the kept entries are compacted on the card, one stable sort
of them serves both tables, and each gradient row is summed from +0.0 in
item order and written once, so every launch gives the same bits and a
CUDA graph can capture it (no float atomics, no read of the device).
Items that add only zeros are left out: a weight of 0 (the sparse grid's
empty corners) or a sample whose gradient is 0 in every table (those past
a ray's exit).  The dense grid's gather passes its corners' row offsets
(`corner_offsets`), and kernel V then sorts the live samples by base row
instead of the items by row (the sample path: it hands over the base
rows alone, so the corner rows cannot disagree with the offsets); the
sparse grid's ``links`` give no such offsets (the item path).  On the
CPU `corner_grad` runs its plain version, `corner_grad_plain`, which sums
in the same order.

The sparse grid keeps svox2's ``links`` indirection: a [X, Y, Z] int32
volume (-1 = empty) indexes capacity-bounded ``density_data`` /
``sh_data`` tables, and ``cells`` maps each table row back to its flat cell
(-1 for padding).  ``build_sparse`` builds them on the tables' device.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from jnerf_tpu_torch.ops.composite import transmittance
from jnerf_tpu_torch.utils.common import device_const

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
CAP_QUANTUM = 1 << 15  # sparse tables are padded to a multiple of this


def eval_sh_basis(basis_dim: int, dirs):
    """Real SH basis values for unit dirs [N, 3] -> [N, basis_dim]
    (svox2's hard-coded basis)."""
    if basis_dim not in (1, 4, 9):
        raise ValueError(f"basis_dim {basis_dim}")
    out = [torch.full(dirs.shape[:-1], SH_C0, dtype=dirs.dtype,
                      device=dirs.device)]
    if basis_dim > 1:
        x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
        out += [-SH_C1 * y, SH_C1 * z, -SH_C1 * x]
    if basis_dim > 4:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        out += [
            SH_C2[0] * xy,
            SH_C2[1] * yz,
            SH_C2[2] * (2.0 * zz - xx - yy),
            SH_C2[3] * xz,
            SH_C2[4] * (xx - yy),
        ]
    return torch.stack(out, dim=-1)


@dataclass(frozen=True)
class VoxelGridSpec:
    reso: tuple  # (X, Y, Z)
    basis_dim: int = 9

    @property
    def n_cells(self):
        return self.reso[0] * self.reso[1] * self.reso[2]

    @property
    def sh_channels(self):
        return 3 * self.basis_dim


def sparse_capacity(n: int) -> int:
    """Rows of a sparse table holding ``n`` active cells."""
    return -(-max(n, 1) // CAP_QUANTUM) * CAP_QUANTUM


class _CornerGather(torch.autograd.Function):
    """out_t[n] = sum_c w[n, c] * table_t[row_c[n]] for each table t,
    differentiated with respect to the tables (as the JAX runner's step
    is), not to the weights.  The rows: idx [N, K], or with ``offsets``
    idx [N] base rows and row_c = idx + offsets[c] (see `corner_grad`)."""

    @staticmethod
    def forward(ctx, idx, w, offsets, *tables):
        ctx.save_for_backward(idx, w)
        ctx.offsets = offsets
        ctx.shapes = [table.shape for table in tables]
        rows = ([idx[:, c] for c in range(idx.shape[1])] if offsets is None
                else [idx + o for o in offsets])
        outs = []
        for table in tables:
            out = 0.0
            for c, row in enumerate(rows):
                out = out + w[:, c, None] * table[row]
            outs.append(out)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        idx, w = ctx.saved_tensors
        if ctx.needs_input_grad[1]:
            raise NotImplementedError("corner_gather: no gradient for w")
        want = [k for k in range(len(grads)) if ctx.needs_input_grad[3 + k]]
        g_tables = [None] * len(grads)
        if not want:
            return (None, None, None, *g_tables)
        outs = corner_grad(idx, w, [grads[k].float().contiguous()
                                    for k in want], ctx.shapes[want[0]][0],
                           ctx.offsets)
        for k, out in zip(want, outs):
            g_tables[k] = out.reshape(ctx.shapes[k])
        return (None, None, None, *g_tables)


def _live_samples(grads, n, device):
    """[N] bool: the samples some table's g of which is not 0."""
    live = torch.zeros(n, dtype=torch.bool, device=device)
    for g in grads:
        live |= (g != 0).any(dim=1)
    return live


def _live_items(idx, w, grads, n_rows):
    """[N * K] bool: the (sample, corner) items that add more than zeros:
    weight not 0, row in [0, n_rows), and some table's g of the sample not
    0."""
    live = _live_samples(grads, idx.shape[0], idx.device)
    keep = (w != 0) & live[:, None] & (idx >= 0) & (idx < n_rows)
    return keep.reshape(-1)


def corner_grad_plain(idx, w, grads, n_rows: int):
    """Plain version of kernel V: for each g [N, C_t] f32, the gradient
    [n_rows, C_t] f32 of ``corner_gather`` with respect to table t, each
    row the sum from +0.0 of w[n, c] * g[n] over its items (n, c) in item
    order (n * K + c; ``index_add_`` on the CPU adds in index order),
    leaving out the items that add only zeros (`_live_items`)."""
    K = idx.shape[1]
    items = torch.nonzero(_live_items(idx, w, grads, n_rows)).squeeze(1)
    rows, w_kept = idx.reshape(-1)[items], w.reshape(-1)[items, None]
    sample = items // K
    return [g.new_zeros((n_rows, g.shape[1])).index_add_(
        0, rows, w_kept * g[sample]) for g in grads]


def corner_rows(idx, n_rows: int, offsets=None):
    """`corner_grad`'s corner rows [N, K]: idx itself on the item path
    (``offsets`` None); on the sample path the base rows idx [N] plus each
    offset, every row -1 (left out) for a sample whose base row lies
    outside [0, n_rows), as kernel V leaves such a sample out."""
    if offsets is None:
        return idx
    rows = idx[:, None] + torch.tensor(offsets, dtype=idx.dtype,
                                       device=idx.device)
    on_grid = ((idx >= 0) & (idx < n_rows))[:, None]
    return torch.where(on_grid, rows, torch.full_like(rows, -1))


def corner_grad_entries_plain(idx, w, grads, n_rows: int, offsets=None):
    """Plain version of kernel V's compaction: (keys, payloads) int64 of
    the kept entries in entry order.  Item path (``offsets`` None): the
    kept items (`_live_items`) in item order, keyed by row, payload
    n * K + c.  Sample path (idx the [N] base rows): the live samples whose
    base row lies in [0, n_rows), in sample order, keyed by base row,
    payload n."""
    if offsets is None:
        items = torch.nonzero(_live_items(idx, w, grads, n_rows)).squeeze(1)
        return idx.reshape(-1)[items], items
    keep = _live_samples(grads, idx.shape[0], idx.device) & (idx >= 0) \
        & (idx < n_rows)
    samples = torch.nonzero(keep).squeeze(1)
    return idx[samples], samples


def corner_grad_plan_plain(idx, w, grads, n_rows: int, offsets=None):
    """Plain version of kernel V's sort: (start [n_rows + 1] int32, order
    [kept] int32), the compaction's entries (`corner_grad_entries_plain`:
    items, or on the sample path live samples) sorted stably by key and
    each key's first position; start[n_rows] is the number kept."""
    keys, pay = corner_grad_entries_plain(idx, w, grads, n_rows, offsets)
    order = pay[torch.sort(keys, stable=True).indices]
    start = torch.zeros(n_rows + 1, dtype=torch.int64, device=idx.device)
    start[1:] = torch.cumsum(torch.bincount(keys, minlength=n_rows), 0)
    return start.to(torch.int32), order.to(torch.int32)


@functools.lru_cache(maxsize=64)
def grad_layout(n: int, K: int, n_rows: int, samples: bool = False):
    """Kernel V's work space on the sample or item path: (int32s, where
    the key starts lie in it, where the sorted payloads lie in it, the
    rows a warp of the sum owns, the entries its window holds in shared
    memory, the most channels it takes)."""
    from .cuda_lib import voxel_grid_lib

    out = (ctypes.c_longlong * 6)()
    if voxel_grid_lib().voxel_grad_layout(n, K, n_rows, int(samples),
                                          out) < 0:
        raise ValueError(f"kernel V does not take {n} samples of {K} "
                         f"corners into {n_rows} rows")
    return tuple(out)


def _launch_grad(idx, w, grads, n_rows, outs, work, plan_only, offsets=None):
    from .cuda_lib import Launch, voxel_grid_lib

    global _VOXEL_GRAD
    if _VOXEL_GRAD is None:
        _VOXEL_GRAD = Launch(voxel_grid_lib, "voxel_grad")
    T = len(grads)
    g_ptrs = (ctypes.c_void_p * T)(*[g.data_ptr() for g in grads])
    o_ptrs = (ctypes.c_void_p * T)(*[o.data_ptr() for o in outs])
    widths = (ctypes.c_int * T)(*[g.shape[1] for g in grads])
    offs = None if offsets is None else (ctypes.c_int * len(offsets))(
        *offsets)
    n, K = w.shape
    _VOXEL_GRAD(idx.get_device(), idx.data_ptr(), w.data_ptr(), g_ptrs,
                o_ptrs, widths, T, offs, work.data_ptr(), n, K, n_rows,
                int(plan_only))


_VOXEL_GRAD = None


def _require_cuda_grad_inputs(idx, w, grads, n_rows, offsets):
    n = idx.shape[0]
    if offsets is None:
        if idx.dtype != torch.int64 or idx.dim() != 2 \
                or not 1 <= idx.shape[1] <= 8:
            raise ValueError(f"idx must be [N, K<=8] int64, got "
                             f"{tuple(idx.shape)} {idx.dtype}")
        K = idx.shape[1]
    else:
        if idx.dtype != torch.int64 or idx.dim() != 1:
            raise ValueError(f"with offsets, idx must be the [N] int64 base "
                             f"rows, got {tuple(idx.shape)} {idx.dtype}")
        K = len(offsets)
        if not 1 <= K <= 8 or offsets[0] != 0 or not all(
                isinstance(o, int) and 0 <= o < n_rows for o in offsets):
            raise ValueError(f"offsets must be 1 to 8 ints in [0, {n_rows}), "
                             f"the first 0, got {offsets}")
    if w.dtype != torch.float32 or tuple(w.shape) != (n, K):
        raise ValueError(f"w must be {(n, K)} float32, got "
                         f"{tuple(w.shape)} {w.dtype}")
    if not 1 <= len(grads) <= 4:
        raise ValueError(f"kernel V takes 1 to 4 tables, got {len(grads)}")
    for g in grads:
        if g.dtype != torch.float32 or g.dim() != 2 or g.shape[0] != n:
            raise ValueError(f"each g must be [{n}, C] float32, got "
                             f"{tuple(g.shape)} {g.dtype}")
    for t in (idx, w, *grads):
        if t.device != idx.device:
            raise ValueError("kernel V takes tensors on one device")
        if not t.is_contiguous():
            raise ValueError("kernel V takes contiguous tensors")
    if n:
        most = grad_layout(n, K, n_rows, offsets is not None)[5]
        if sum(g.shape[1] for g in grads) > most:
            raise ValueError(f"kernel V takes at most {most} channels")


def corner_grad(idx, w, grads, n_rows: int, offsets=None):
    """Kernel V: the gradients of `corner_gather` with respect to its
    tables, one [n_rows, C_t] f32 a g [N, C_t], each row summed in
    `corner_grad_plain`'s order, so equal to it bit for bit on every
    launch.  idx [N, K] the corner rows (the item path); or, with
    ``offsets`` (K ints, the first 0: the dense grid's `corner_offsets`),
    idx [N] the base rows, corner c's row idx + offsets[c] (the sample
    path; a sample whose base row lies outside [0, n_rows) adds nothing,
    `corner_rows`).  On CPU tensors, the plain version."""
    if idx.device.type == "cpu":
        return corner_grad_plain(corner_rows(idx, n_rows, offsets), w, grads,
                                 n_rows)
    _require_cuda_grad_inputs(idx, w, grads, n_rows, offsets)
    outs = [torch.empty((n_rows, g.shape[1]), dtype=torch.float32,
                        device=idx.device) for g in grads]
    if idx.numel() == 0:
        return [o.zero_() for o in outs]
    work = torch.empty(grad_layout(*w.shape, n_rows, offsets is not None)[0],
                       dtype=torch.int32, device=idx.device)
    _launch_grad(idx, w, grads, n_rows, outs, work, False, offsets)
    corner_grad.launches += 1
    return outs


corner_grad.launches = 0


def corner_grad_plan(idx, w, grads, n_rows: int, offsets=None):
    """Kernel V's sort alone, as `corner_grad_plan_plain` returns it (on
    CPU tensors, that plain version).  Not counted."""
    if idx.device.type == "cpu":
        return corner_grad_plan_plain(idx, w, grads, n_rows, offsets)
    _require_cuda_grad_inputs(idx, w, grads, n_rows, offsets)
    total, at_start, at_order = grad_layout(*w.shape, n_rows,
                                            offsets is not None)[:3]
    work = torch.empty(total, dtype=torch.int32, device=idx.device)
    outs = [torch.empty((0,), dtype=torch.float32, device=idx.device)
            for _ in grads]
    _launch_grad(idx, w, grads, n_rows, outs, work, True, offsets)
    start = work[at_start:at_start + n_rows + 1]
    return start, work[at_order:at_order + int(start[-1])]


def corner_gather(idx, w, *tables, offsets=None):
    """Trilinear gather of [n_rows, C_t] tables at corner rows ``idx``
    [N, 8] with weights ``w`` [N, 8]; returns one [N, C_t] per table.
    With ``offsets``, idx is the [N] base rows (see `corner_grad`)."""
    return _CornerGather.apply(idx, w, offsets, *tables)


def corners(spec: VoxelGridSpec, pos):
    """Flat cell ids [N, 8] and trilinear weights [N, 8] of grid-space
    positions [N, 3], corners clamped to the grid (svox2 clamps at
    borders)."""
    X, Y, Z = spec.reso
    hi = device_const((X - 1, Y - 1, Z - 1), pos.device)
    p = torch.clamp(pos, min=torch.zeros_like(hi), max=hi)
    g0f = torch.floor(torch.clamp(p, min=torch.zeros_like(hi), max=hi - 1))
    fr = p - g0f
    g0 = g0f.to(torch.int64)
    idx, w = [], []
    for c in range(8):
        dx, dy, dz = c & 1, (c >> 1) & 1, (c >> 2) & 1
        idx.append(((g0[:, 0] + dx) * Y + (g0[:, 1] + dy)) * Z + (g0[:, 2] + dz))
        w.append((fr[:, 0] if dx else 1 - fr[:, 0])
                 * (fr[:, 1] if dy else 1 - fr[:, 1])
                 * (fr[:, 2] if dz else 1 - fr[:, 2]))
    return torch.stack(idx, 1), torch.stack(w, 1)


def corner_offsets(spec: VoxelGridSpec):
    """The rows of `corners`' eight corners less its corner 0's: its
    corner c is row idx[:, 0] + offsets[c] (it clamps the base cell to
    reso - 2 on each axis)."""
    X, Y, Z = spec.reso
    return tuple((c & 1) * Y * Z + ((c >> 1) & 1) * Z + ((c >> 2) & 1)
                 for c in range(8))


def trilinear_sample(spec: VoxelGridSpec, density, sh, pos):
    """Sample density [X, Y, Z] and SH [X, Y, Z, C] at grid-space positions
    [N, 3] (0..reso-1); returns (sigma [N], sh_coeffs [N, C])."""
    idx, w = corners(spec, pos)
    sigma, sh_c = corner_gather(idx[:, 0].contiguous(), w,
                                density.reshape(spec.n_cells, 1),
                                sh.reshape(spec.n_cells, -1),
                                offsets=corner_offsets(spec))
    return sigma[:, 0], sh_c


def trilinear_sample_sparse(spec: VoxelGridSpec, links, density_data,
                            sh_data, pos):
    """Sparse-table `trilinear_sample`: each corner's link picks its table
    row; empty links contribute zeros (svox2's semantics)."""
    idx, w = corners(spec, pos)
    lk = links.reshape(-1)[idx]
    w = torch.where(lk >= 0, w, torch.zeros_like(w))
    sigma, sh_c = corner_gather(torch.clamp(lk, min=0).to(torch.int64), w,
                                density_data[:, None], sh_data)
    return sigma[:, 0], sh_c


def _composite(spec, sample_fn, rays_o, rays_d, n_samples, step_size,
               background_brightness, sigma_thresh, delta_scale):
    """Fixed ``n_samples`` per ray at ``step_size`` over the grid's box,
    sampled by ``sample_fn(pos [N, 3]) -> (sigma, sh)``; returns rgb [R, 3]."""
    X, Y, Z = spec.reso
    dev = rays_o.device
    hi = device_const((X - 1, Y - 1, Z - 1), dev)
    inv = 1.0 / torch.where(torch.abs(rays_d) > 1e-9, rays_d,
                            torch.full_like(rays_d, 1e-9))
    t0 = (0.0 - rays_o) * inv
    t1 = (hi - rays_o) * inv
    tmin = torch.clamp(torch.amax(torch.minimum(t0, t1), -1), min=0.0)
    tmax = torch.amin(torch.maximum(t0, t1), -1)

    r = rays_o.shape[0]
    ts = tmin[:, None] + step_size * torch.arange(
        n_samples, dtype=torch.float32, device=dev)[None, :]
    valid = ts <= tmax[:, None]

    pos = rays_o[:, None, :] + ts[..., None] * rays_d[:, None, :]
    sigma, sh_c = sample_fn(pos.reshape(-1, 3))
    zero = torch.zeros((), dtype=sigma.dtype, device=dev)
    sigma = torch.where(valid.reshape(-1), sigma, zero).reshape(r, n_samples)
    sigma = torch.where(sigma > sigma_thresh, sigma, zero)

    viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    basis = eval_sh_basis(spec.basis_dim, viewdirs)  # [R, B]
    sh_c = sh_c.reshape(r, n_samples, 3, spec.basis_dim)
    rgb = torch.sigmoid(torch.einsum("rscb,rb->rsc", sh_c, basis))

    delta = (step_size if delta_scale is None
             else step_size * delta_scale[:, None])
    alpha = 1.0 - torch.exp(-sigma * delta)
    trans = transmittance(alpha)
    t_excl = torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]], -1)
    weights = alpha * t_excl
    out = torch.sum(weights[..., None] * rgb, dim=1)
    return out + background_brightness * trans[..., -1:]


def render_rays_grid(spec: VoxelGridSpec, density, sh, rays_o, rays_d,
                     n_samples: int, step_size: float,
                     background_brightness: float = 1.0,
                     sigma_thresh: float = 1e-8, delta_scale=None):
    """Composite rays through the dense grid.

    rays_o / rays_d [R, 3] are in grid coordinates; ``delta_scale`` ([R] or
    None) turns grid-space step lengths into world units for the
    attenuation.  Returns rgb [R, 3]."""
    return _composite(
        spec, lambda p: trilinear_sample(spec, density, sh, p), rays_o,
        rays_d, n_samples, step_size, background_brightness, sigma_thresh,
        delta_scale)


def render_rays_grid_sparse(spec: VoxelGridSpec, links, density_data, sh_data,
                            rays_o, rays_d, n_samples: int, step_size: float,
                            background_brightness: float = 1.0,
                            sigma_thresh: float = 1e-8, delta_scale=None):
    """Sparse-table `render_rays_grid` (the same compositing)."""
    return _composite(
        spec, lambda p: trilinear_sample_sparse(spec, links, density_data,
                                                sh_data, p),
        rays_o, rays_d, n_samples, step_size, background_brightness,
        sigma_thresh, delta_scale)


def total_variation(grid, mask=None, logalpha: bool = False):
    """Mean squared difference between neighbour cells along each of the
    first three axes (exact TV over the dense grid)."""
    tv = 0.0
    n = 0
    for axis in range(3):
        m = grid.shape[axis] - 1
        d2 = (grid.narrow(axis, 1, m) - grid.narrow(axis, 0, m)) ** 2
        tv = tv + torch.sum(d2)
        n += d2.numel()
    return tv / n


def upsample_grid(density, sh, new_reso):
    """Trilinear resize of density [X, Y, Z] and SH [X, Y, Z, C] to
    ``new_reso`` (half-pixel centres, as ``jax.image.resize``'s
    "trilinear" upsampling)."""
    d = F.interpolate(density[None, None], size=tuple(new_reso),
                      mode="trilinear", align_corners=False)[0, 0]
    s = F.interpolate(sh.permute(3, 0, 1, 2)[None], size=tuple(new_reso),
                      mode="trilinear", align_corners=False)[0]
    return d, s.permute(1, 2, 3, 0).contiguous()


def dilate_mask(mask, iters: int = 2):
    """6-connected binary dilation by shifted ORs (svox2's ``dilate``)."""
    m = mask
    for _ in range(iters):
        grown = m.clone()
        for axis in range(3):
            n = m.shape[axis] - 1
            grown.narrow(axis, 1, n).logical_or_(m.narrow(axis, 0, n))
            grown.narrow(axis, 0, n).logical_or_(m.narrow(axis, 1, n))
        m = grown
    return m


def sparse_links(mask, cap=None):
    """An active mask [X, Y, Z] -> (links [X, Y, Z] int32, cells [cap]
    int32, active flat ids [n] int64) on the mask's device."""
    X, Y, Z = mask.shape
    active = torch.nonzero(mask.reshape(-1)).reshape(-1)
    n = active.numel()
    cap = sparse_capacity(n) if cap is None else cap
    if n > cap:
        raise ValueError(f"{n} active cells exceed the capacity {cap}")
    dev = mask.device
    links = torch.full((X * Y * Z,), -1, dtype=torch.int32, device=dev)
    links[active] = torch.arange(n, dtype=torch.int32, device=dev)
    cells = torch.full((cap,), -1, dtype=torch.int32, device=dev)
    cells[:n] = active.to(torch.int32)
    return links.reshape(X, Y, Z), cells, active


def build_sparse(density, sh, mask, cap=None):
    """Dense grids + active mask -> (links, density_data, sh_data, cells),
    the tables padded to ``cap`` rows (default: the active count rounded up
    to a multiple of 2^15)."""
    links, cells, active = sparse_links(mask, cap)
    cap, n = cells.shape[0], active.numel()
    ddata = torch.zeros((cap,), dtype=torch.float32, device=density.device)
    sdata = torch.zeros((cap, sh.shape[-1]), dtype=torch.float32,
                        device=sh.device)
    ddata[:n] = density.reshape(-1)[active]
    sdata[:n] = sh.reshape(-1, sh.shape[-1])[active]
    return links, ddata, sdata, cells


def total_variation_sparse(spec: VoxelGridSpec, links, cells, data, n_subset,
                           ridx=None, generator=None):
    """Subset TV over active cells: ``ridx`` [n_subset] table rows (drawn
    uniformly from [0, cap) with ``generator`` when not given) are
    differenced against their +1 neighbours along each axis (a missing
    neighbour counts as 0, svox2's sparse convention); returns the mean
    squared difference."""
    X, Y, Z = spec.reso
    cap = cells.shape[0]
    flat_links = links.reshape(-1)
    if ridx is None:
        ridx = torch.randint(0, cap, (n_subset,), generator=generator,
                             device=data.device)
    ridx = ridx.to(torch.int64)
    cell = cells[ridx].to(torch.int64)
    active = cell >= 0
    cell = torch.clamp(cell, min=0)
    base = data[ridx]
    if base.ndim == 1:
        base = base[:, None]
    z = cell % Z
    y = (cell // Z) % Y
    x = cell // (Y * Z)
    zero = torch.zeros((), dtype=base.dtype, device=base.device)
    tv = 0.0
    cnt = 0
    for cc, lim, stride in ((x, X, Y * Z), (y, Y, Z), (z, Z, 1)):
        nb_ok = cc + 1 < lim
        lk = flat_links[torch.clamp(cell + stride, max=X * Y * Z - 1)]
        nb = data[torch.clamp(lk, min=0).to(torch.int64)]
        if nb.ndim == 1:
            nb = nb[:, None]
        nb = torch.where((nb_ok & (lk >= 0))[:, None], nb, zero)
        d2 = torch.where((active & nb_ok)[:, None], (nb - base) ** 2, zero)
        tv = tv + torch.sum(d2)
        cnt = cnt + torch.sum(active & nb_ok) * base.shape[1]
    return tv / torch.clamp(cnt.to(base.dtype), min=1.0)

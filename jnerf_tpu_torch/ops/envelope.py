"""The envelope kernels: the card's counterparts of the thirteen
``pallas_call``s of the archived TPU envelope probes (``tools/archive/``).

Four CUDA kernels (`jnerf_tpu_torch/csrc/envelope.cu`, whose head note
names every site each replaces and what bounds it):

- **K1** ``row_gather(table, idx, w=None, lane_sum=False)``: ``table[idx]``
  (f32 or bf16 rows of a multiple of 16 bytes), times ``w`` (f32), or each
  f32 row summed over its lanes;
- **K2** ``elem_gather(src, idx, mode)``: a flat take, or
  ``take_along_axis`` on axis 0 or axis 1 (f32);
- **K3** ``row_scatter_add(idx, vals, n_rows)``: ``out[idx[n]] += vals[n]``,
  [n_rows, W] f32 (W a multiple of 4): the indices sorted stably by row,
  then each row's sources summed in index order and the row written once
  (``row_scatter_plan``: the sort alone; ``row_scatter_plan_plain``: its
  plain twin);
- **K4** ``packed_hash_scatter(pos, g, rows, slots, scales, n_rows, ...)``:
  the packed hash-gradient scatter of ``probe_bwd_var.py`` (f2 levels, 128
  lanes a row: slot * 16 + corner * 2 + feature), binned by tile of rows
  and summed in sample order (``packed_hash_bins``: its bins alone;
  ``packed_bin_plan`` / ``packed_bins_plain``: their plain twins).

Indices are int32, as in the archive, and the wrappers refuse any other
type.  An index outside its table gives a zero (gathers) or is dropped
(scatters), in the kernels and in their twins alike; a one-hot gather of a
128-row table (``probe_tpu.py``'s ``k_onehot``) is K1 under that rule.

Each kernel has a plain PyTorch twin here (``*_plain``).  A wrapper runs
its twin only for CPU tensors; for CUDA tensors it launches the kernel or
raises, and counts the launch in ``.launches``.  K1-K4 (but K4's noscat)
equal their twins bit for bit; noscat adds its few sums with f32 atomics,
whose order varies from run to run.  The wrappers launch through
`cuda_lib.Launch`, each check done once.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .cuda_lib import Launch, envelope_lib
from .hash_grid import HashGridSpec

MODES = {"flat": 0, "axis0": 1, "axis1": 2}
K4_MODES = {"v2d": 0, "novals": 1, "noscat": 2}
# probe_bwd_var.py's BLK: noscat adds the first sample of each block.
NOSCAT_BLK = 8192
LANES = 128  # a packed row: 8 slots x 8 corners x 2 features
SIZE_LIMIT = 1 << 31  # the kernels index with 32-bit integers

_ROW_GATHER = Launch(envelope_lib, "env_row_gather")
_ELEM_GATHER = Launch(envelope_lib, "env_elem_gather")
_ROW_SCATTER = Launch(envelope_lib, "env_row_scatter_add")
_PACKED_BINS = Launch(envelope_lib, "env_packed_bins")
_PACKED_ACC = Launch(envelope_lib, "env_packed_accumulate")
_PACKED_NOSCAT = Launch(envelope_lib, "env_packed_noscat")


def k4_tile_rows(n_acc: int, mode: str) -> int:
    """K4's tile height in packed rows: 64 for v2d with one accumulator
    (the sums held in registers: three blocks an SM) and 128 for alt2
    (twice the tiles a level, so twice the bin pass's tile tables at 64)
    and novals (integer counts, no sums held); csrc/envelope.cu's note
    says why."""
    return 64 if mode == "v2d" and n_acc == 1 else 128


def _zero_outside(x: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    shape = ok.shape + (1,) * (x.dim() - ok.dim())
    return torch.where(ok.reshape(shape), x, torch.zeros((), dtype=x.dtype,
                                                         device=x.device))


def _check_idx(idx: torch.Tensor, dim: int):
    if idx.dtype != torch.int32:
        raise TypeError(f"indices must be int32, got {idx.dtype}")
    if idx.dim() != dim:
        raise ValueError(f"indices must have {dim} dimensions, got "
                         f"{tuple(idx.shape)}")


def _cuda_check(what: str, dev: int, *tensors: torch.Tensor, vectors=()):
    """The tensors on card ``dev``, contiguous; those in ``vectors`` (read
    or added as 16-byte vectors) 16-byte aligned."""
    for t in tensors + vectors:
        if t.get_device() != dev:
            raise ValueError(f"{what}: tensors on cuda:{dev} and {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what} takes contiguous tensors")
    for t in vectors:
        if t.data_ptr() % 16:
            raise ValueError(f"{what} reads 16-byte vectors: a tensor is not "
                             "16-byte aligned")


def _check_sizes(what: str, *counts: int):
    """The kernels index with 32-bit integers: each count of elements (or
    16-byte chunks) a launch walks must be below 2^31."""
    for c in counts:
        if c >= SIZE_LIMIT:
            raise ValueError(f"{what}: a size reaches 2^31 ({counts})")


# ------------------------------------------------------------------- K1
def row_gather_plain(table, idx, w=None, lane_sum=False):
    """Plain twin of K1: [N, W] rows (zero for an index outside the
    table), times ``w``, or [N] lane sums in K1's order: each 4-lane chunk
    left to right, then the chunks by halves."""
    i = idx.long()
    ok = (i >= 0) & (i < table.shape[0])
    rows = _zero_outside(table[i.clamp(0, table.shape[0] - 1)], ok)
    if w is not None:
        rows = rows * w
    if not lane_sum:
        return rows
    s = rows.reshape(rows.shape[0], -1, 4)
    s = ((s[..., 0] + s[..., 1]) + s[..., 2]) + s[..., 3]
    while s.shape[1] > 1:
        h = s.shape[1] // 2
        s = s[:, :h] + s[:, h:]
    return s[:, 0]


def row_gather(table: torch.Tensor, idx: torch.Tensor, w=None,
               lane_sum: bool = False) -> torch.Tensor:
    """K1: ``table[idx]`` [N, W] in the table's type; with ``w`` [N, W]
    f32 the rows times ``w``; with ``lane_sum`` [N] f32 row sums."""
    _check_idx(idx, 1)
    if table.dim() != 2 or table.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError("K1 takes a 2-D f32 or bf16 table, got "
                         f"{tuple(table.shape)} {table.dtype}")
    row_bytes = table.shape[1] * table.element_size()
    if row_bytes % 16 or table.shape[0] < 1:
        raise ValueError(f"K1 reads 16-byte vectors: rows of {row_bytes} "
                         "bytes (not a multiple of 16) or an empty table")
    chunks = row_bytes // 16
    if (w is not None or lane_sum) and table.dtype != torch.float32:
        raise ValueError("K1 multiplies and sums f32 rows only")
    if w is not None and (lane_sum or w.dtype != torch.float32
                          or tuple(w.shape) != (idx.shape[0], table.shape[1])):
        raise ValueError(f"w must be [N, W] f32, got {tuple(w.shape)} "
                         f"{w.dtype}, and not with lane_sum")
    if lane_sum and (chunks > 32 or chunks & (chunks - 1)):
        raise ValueError("K1 sums rows of 4 x 2^k lanes, k <= 5")
    if table.device.type == "cpu":
        return row_gather_plain(table, idx, w, lane_sum)
    dev = table.get_device()
    _cuda_check("row_gather", dev, idx,
                vectors=(table,) if w is None else (table, w))
    n = idx.shape[0]
    _check_sizes("row_gather", n * chunks, table.shape[0] * chunks)
    if lane_sum:
        out = torch.empty((n,), dtype=torch.float32, device=table.device)
    else:
        out = torch.empty((n, table.shape[1]), dtype=table.dtype,
                          device=table.device)
    mode = 2 if lane_sum else (1 if w is not None else 0)
    _ROW_GATHER(dev, table.data_ptr(), idx.data_ptr(),
                None if w is None else w.data_ptr(), out.data_ptr(), n, chunks,
                table.shape[0], mode)
    if n:
        row_gather.launches += 1
    return out


row_gather.launches = 0


# ------------------------------------------------------------------- K2
def _elem_shapes(src_shape, idx_shape, mode) -> int:
    """The mode's number, after its shape checks."""
    code = MODES.get(mode)
    if code is None:
        raise ValueError(f"mode must be one of {sorted(MODES)}, got {mode!r}")
    if code:
        if len(src_shape) != 2 or len(idx_shape) != 2:
            raise ValueError(f"{mode} takes 2-D src and indices")
        k = 2 - code  # the axis the two must share
        if src_shape[k] != idx_shape[k]:
            raise ValueError(f"{mode}: src {tuple(src_shape)} and indices "
                             f"{tuple(idx_shape)} differ on axis {k}")
    return code


def elem_gather_plain(src, idx, mode):
    """Plain twin of K2 (zero for an index outside its axis)."""
    i = idx.long()
    if mode == "flat":
        flat = src.reshape(-1)
        ok = (i >= 0) & (i < flat.numel())
        return _zero_outside(flat[i.clamp(0, flat.numel() - 1)], ok)
    ax = 0 if mode == "axis0" else 1
    ok = (i >= 0) & (i < src.shape[ax])
    return _zero_outside(torch.gather(src, ax, i.clamp(0, src.shape[ax] - 1)),
                         ok)


def elem_gather(src: torch.Tensor, idx: torch.Tensor, mode: str) -> torch.Tensor:
    """K2: ``flat`` (``src.reshape(-1)[idx]``, any shapes), ``axis0``
    (``out[i, j] = src[idx[i, j], j]``) or ``axis1`` (``out[i, j] =
    src[i, idx[i, j]]``); f32, the output shaped as ``idx``."""
    if idx.dtype != torch.int32:
        raise TypeError(f"indices must be int32, got {idx.dtype}")
    size = src.numel()
    if src.dtype != torch.float32 or size < 1:
        raise ValueError(f"K2 takes a non-empty f32 src, got {src.dtype}")
    src_shape, idx_shape = src.shape, idx.shape
    code = _elem_shapes(src_shape, idx_shape, mode)
    dev = src.get_device()
    if dev < 0:
        return elem_gather_plain(src, idx, mode)
    _cuda_check("elem_gather", dev, src, idx)
    n = idx.numel()
    _check_sizes("elem_gather", n, size)
    out = torch.empty_like(idx, dtype=torch.float32)
    if code:
        _ELEM_GATHER(dev, src.data_ptr(), idx.data_ptr(), out.data_ptr(), n,
                     code, idx_shape[1], src_shape[0], src_shape[1])
    else:
        _ELEM_GATHER(dev, src.data_ptr(), idx.data_ptr(), out.data_ptr(), n,
                     0, 1, size, 1)
    if n:
        elem_gather.launches += 1
    return out


elem_gather.launches = 0


# ------------------------------------------------------------------- K3
def row_scatter_add_plain(idx, vals, n_rows, dtype=torch.float32):
    """Plain twin of K3: ``index_add_`` into zeros, indices outside
    [0, n_rows) dropped; summed in ``dtype`` (float64: the exact sum a
    check holds the kernel to)."""
    i = idx.long()
    ok = (i >= 0) & (i < n_rows)
    out = torch.zeros((n_rows, vals.shape[1]), dtype=dtype, device=vals.device)
    return out.index_add_(0, i[ok], vals[ok].to(dtype))


def row_scatter_plan_plain(idx, n_rows):
    """Plain twin of K3's sort: (start [n_rows + 1] int32, order [N]
    int32): the source indices sorted stably by row, indices outside
    [0, n_rows) after every row; start[r] the first position of row r,
    start[n_rows] the number kept."""
    i = idx.long()
    ok = (i >= 0) & (i < n_rows)
    key = torch.where(ok, i, torch.full_like(i, n_rows))
    order = torch.sort(key, stable=True).indices
    start = torch.zeros(n_rows + 1, dtype=torch.int64, device=idx.device)
    start[1:] = torch.cumsum(torch.bincount(i[ok], minlength=n_rows), 0)
    return start.to(torch.int32), order.to(torch.int32)


@functools.lru_cache(maxsize=64)
def row_scatter_layout(n: int, n_rows: int):
    """K3's work space: (int32s, where the row starts lie in it, where
    the sorted source indices lie in it)."""
    out = (ctypes.c_longlong * 3)()
    if envelope_lib().env_row_scatter_layout(n, n_rows, out) < 0:
        raise ValueError(f"row_scatter_add: K3 does not take N={n} into "
                         f"{n_rows} rows (a size reaches 2^31)")
    return tuple(out)


def _k3_args(idx, vals, n_rows):
    _check_idx(idx, 1)
    if vals.dtype != torch.float32 or vals.dim() != 2 \
            or vals.shape[0] != idx.shape[0] or vals.shape[1] % 4 \
            or vals.shape[1] == 0 or n_rows < 1:
        raise ValueError(f"K3 takes vals [N, 4k] f32 beside idx [N] and "
                         f"n_rows >= 1, got {tuple(vals.shape)} {vals.dtype}")


def _k3(idx, vals, n_rows, plan_only):
    """Launch K3 (plan_only: its sort alone): (out, work)."""
    dev = vals.get_device()
    _cuda_check("row_scatter_add", dev, idx, vectors=(vals,))
    _check_sizes("row_scatter_add", vals.numel() // 4, n_rows * vals.shape[1])
    work = torch.empty(row_scatter_layout(idx.shape[0], n_rows)[0],
                       dtype=torch.int32, device=vals.device)
    out = torch.empty((0 if plan_only else n_rows, vals.shape[1]),
                      dtype=torch.float32, device=vals.device)
    _ROW_SCATTER(dev, idx.data_ptr(), vals.data_ptr(), out.data_ptr(),
                 work.data_ptr(), idx.shape[0], vals.shape[1] // 4, n_rows,
                 int(plan_only))
    return out, work


def row_scatter_add(idx: torch.Tensor, vals: torch.Tensor,
                    n_rows: int) -> torch.Tensor:
    """K3: [n_rows, W] f32 with ``out[idx[n]] += vals[n]``, each row's
    sources summed from +0.0 in index order, as the twin's ``index_add_``
    adds them: equal to the twin bit for bit."""
    _k3_args(idx, vals, n_rows)
    if vals.device.type == "cpu":
        return row_scatter_add_plain(idx, vals, n_rows)
    if idx.shape[0] == 0:  # nothing to sum
        return torch.zeros((n_rows, vals.shape[1]), dtype=torch.float32,
                           device=vals.device)
    out, _ = _k3(idx, vals, n_rows, False)
    row_scatter_add.launches += 1
    return out


row_scatter_add.launches = 0


def row_scatter_plan(idx: torch.Tensor, vals: torch.Tensor, n_rows: int):
    """K3's sort alone, as `row_scatter_plan_plain` returns it (on CPU
    tensors, that twin).  Not counted."""
    _k3_args(idx, vals, n_rows)
    if vals.device.type == "cpu" or idx.shape[0] == 0:
        return row_scatter_plan_plain(idx, n_rows)
    _, at_start, at_order = row_scatter_layout(idx.shape[0], n_rows)
    _, work = _k3(idx, vals, n_rows, True)
    return (work[at_start:at_start + n_rows + 1],
            work[at_order:at_order + idx.shape[0]])


# ------------------------------------------------------------------- K4
def packed_rows_slots(spec: HashGridSpec, pos: torch.Tensor):
    """Each (level, sample)'s packed row and slot [L, N] int32: the
    level-local base entry e0 of the port's own hash (``hash_nbr._cell``)
    split as e0 >> 3, e0 & 7, as probe_bwd_var.py splits the JAX
    package's."""
    from . import hash_nbr

    consts = hash_nbr.level_consts(spec)
    e0 = torch.stack([hash_nbr._cell(consts, lvl, pos)[0]
                      for lvl in range(spec.n_levels)])
    return (e0 >> 3).to(torch.int32), (e0 & 7).to(torch.int32)


def packed_contributions(pos, g, scale, lvl, n_levels):
    """The 16 non-zero lanes [N, 16] (corner * 2 + feature) of each
    sample's packed row at one level, as vals_phase rounds them: X * Y * Z
    * G left to right, X = (1 - f) + b (2f - 1), G = g0 + f (g1 - g0)."""
    s = torch.tensor(scale, dtype=torch.float32, device=pos.device)
    X = []
    for d in range(3):
        q = pos[:, d] * s + 0.5
        f = q - torch.floor(q)
        x0 = 1.0 - f
        X.append((x0, x0 + (2.0 * f - 1.0)))
    g0, g1 = g[:, lvl], g[:, n_levels + lvl]
    G = (g0, g0 + (g1 - g0))
    out = torch.empty((pos.shape[0], 16), dtype=torch.float32,
                      device=pos.device)
    for c in range(8):
        xyz = (X[0][c & 1] * X[1][(c >> 1) & 1]) * X[2][(c >> 2) & 1]
        out[:, 2 * c] = xyz * G[0]
        out[:, 2 * c + 1] = xyz * G[1]
    return out


def packed_hash_scatter_plain(pos, g, rows, slots, scales, n_rows, n_acc=1,
                              mode="v2d", blk=NOSCAT_BLK, dtype=torch.float32):
    """Plain twin of K4: [L * n_acc * n_rows, 128], the f32 contributions
    summed in ``dtype`` (float64: the exact sum) by ``index_add_``, which
    adds each segment's in sample order from zero, as K4 does."""
    L, n = rows.shape
    out = torch.zeros((L * n_acc * n_rows, LANES), dtype=dtype,
                      device=pos.device)
    seg = out.view(-1, 8, 16)
    sample = torch.arange(n, device=pos.device)
    for lvl in range(L):
        r, s = rows[lvl].long(), slots[lvl].long()
        base = (lvl * n_acc + sample % n_acc) * n_rows + r
        row_ok = (r >= 0) & (r < n_rows)
        slot_ok = (s >= 0) & (s < 8)
        if mode == "novals":
            out.index_add_(0, base[row_ok],
                           torch.ones((int(row_ok.sum()), LANES), dtype=dtype,
                                      device=pos.device))
            continue
        v = packed_contributions(pos, g, float(scales[lvl]), lvl, L).to(dtype)
        if mode == "noscat":
            first = slot_ok & (sample % blk == 0)
            seg[lvl * n_rows].index_add_(0, s[first], v[first])
            continue
        ok = row_ok & slot_ok
        seg.view(-1, 16).index_add_(0, (base * 8 + s)[ok], v[ok])
    return out


def packed_bin_plan(rows, slots, n_rows, n_acc=1, mode="v2d",
                    tile_rows=None):
    """K4's bins, plainly: each (level, sample) entry's tile [L, N] int64
    ((l * n_acc + n % n_acc) * ceil(n_rows / tile_rows) + row // tile_rows;
    -1 for an entry K4 drops), the kept entries' flat indices l * N + n in
    bin order (by tile, in sample order within one: the key tile * L * N +
    index is unique, so any sort of it is stable) and each tile's first
    position [n_tiles + 1]."""
    L, n = rows.shape
    tile_rows = tile_rows or k4_tile_rows(n_acc, mode)
    tps = -(-n_rows // tile_rows)
    r = rows.long()
    ok = (r >= 0) & (r < n_rows)
    if mode != "novals":
        ok &= (slots >= 0) & (slots < 8)
    lvl = torch.arange(L, device=rows.device)[:, None]
    acc = torch.arange(n, device=rows.device)[None, :] % n_acc
    tile = (lvl * n_acc + acc) * tps + r.clamp(min=0) // tile_rows
    tile = torch.where(ok, tile, torch.full_like(tile, -1))
    flat = tile.reshape(-1)
    kept = torch.nonzero(flat >= 0).squeeze(1)
    order = kept[torch.argsort(flat[kept] * (L * n) + kept)]
    start = torch.zeros(L * n_acc * tps + 1, dtype=torch.int64,
                        device=rows.device)
    start[1:] = torch.cumsum(torch.bincount(flat[kept],
                                            minlength=L * n_acc * tps), 0)
    return tile, order, start


def packed_bins_plain(pos, g, rows, slots, scales, n_rows, n_acc=1,
                      mode="v2d", tile_rows=None):
    """Plain twin of K4's bin pass: (tile_start [n_tiles + 1] int32, recA
    [M, 4] f32 (the fractions fract(p * scale + 0.5) and g0; None in
    novals), recB [M, 2] int32 (g1's bits, or 0 in novals, and row-in-tile
    * 8 + slot)), the M kept entries in bin order."""
    L, n = rows.shape
    tile_rows = tile_rows or k4_tile_rows(n_acc, mode)
    _, order, start = packed_bin_plan(rows, slots, n_rows, n_acc, mode,
                                      tile_rows)
    lvl, s = order // n, order % n
    seg = (rows.reshape(-1)[order].long() % tile_rows) * 8
    if mode == "novals":
        recB = torch.stack([torch.zeros_like(seg), seg], 1)
        return start.to(torch.int32), None, recB.to(torch.int32)
    seg = seg + slots.reshape(-1)[order].long()
    sc = torch.as_tensor(np.asarray(scales, np.float32), device=pos.device)
    q = pos[s] * sc[lvl][:, None] + 0.5
    recA = torch.cat([q - torch.floor(q), g[s, lvl][:, None]], 1)
    g1 = g[s, L + lvl].contiguous().view(torch.int32).long()
    recB = torch.stack([g1, seg], 1).to(torch.int32)
    return start.to(torch.int32), recA, recB


def _k4_args(pos, g, rows, slots, scales, n_rows, n_acc, mode, blk):
    """K4's checks (the card's rules, also for a CPU caller): returns
    (L, n, scales as f32 numpy)."""
    _check_idx(rows, 2)
    _check_idx(slots, 2)
    L, n = rows.shape
    scales = np.ascontiguousarray(np.asarray(scales, np.float32).reshape(-1))
    if mode not in K4_MODES or n_acc not in (1, 2) \
            or (mode == "noscat" and n_acc != 1) or blk < 1:
        raise ValueError(f"K4 takes mode in {sorted(K4_MODES)}, n_acc 1 or 2 "
                         f"(1 for noscat), got {mode!r}, {n_acc}")
    if tuple(slots.shape) != (L, n) or scales.shape != (L,) or n_rows < 1 \
            or tuple(pos.shape) != (n, 3) or tuple(g.shape) != (n, 2 * L) \
            or pos.dtype != torch.float32 or g.dtype != torch.float32 \
            or not 1 <= L <= 32:
        raise ValueError(
            f"K4 takes pos [N, 3], g [N, 2L] f32, rows and slots [L, N], "
            f"L <= 32 scales: got pos {tuple(pos.shape)}, g {tuple(g.shape)}, "
            f"rows {tuple(rows.shape)}, slots {tuple(slots.shape)}, "
            f"scales {scales.shape}")
    return L, n, scales


def _k4_bins(dev, pos, g, rows, slots, scales, n_rows, n_acc, mode):
    """Launch K4's bin pass on card ``dev``: (work, recA, recB).  work
    holds each (tile, chunk)'s first position in the bins, tile-major
    (work[t * n_chunks] is tile t's first record, work[n_tiles * n_chunks]
    the number kept); the records' arrays are sized for every entry."""
    L, n = rows.shape
    _check_sizes("packed_hash_scatter", 16 * L * n, L * n_acc * n_rows * LANES)
    tile_rows = k4_tile_rows(n_acc, mode)
    ints = envelope_lib().env_packed_work(n, L, n_rows, n_acc, K4_MODES[mode],
                                          tile_rows)
    if ints < 0:
        raise ValueError(f"packed_hash_scatter: K4 does not take {L} levels "
                         f"of {n_rows} rows at N={n} (too many tiles)")
    work = torch.empty(ints, dtype=torch.int32, device=pos.device)
    recA = (None if mode == "novals" else
            torch.empty((L * n, 4), dtype=torch.float32, device=pos.device))
    recB = torch.empty((L * n, 2), dtype=torch.int32, device=pos.device)
    _PACKED_BINS(dev, pos.data_ptr(), g.data_ptr(), rows.data_ptr(),
                 slots.data_ptr(), scales.ctypes.data, work.data_ptr(),
                 None if recA is None else recA.data_ptr(), recB.data_ptr(),
                 n, L, n_rows, n_acc, K4_MODES[mode], tile_rows)
    return work, recA, recB


def packed_hash_bins(pos, g, rows, slots, scales, n_rows, n_acc=1,
                     mode="v2d"):
    """K4's bin pass alone (v2d or novals), as `packed_bins_plain`
    returns it; on CUDA tensors the kernels' bins, cut to the kept
    entries.  Not counted: K4's launches are counted by
    `packed_hash_scatter`."""
    _, n, scales = _k4_args(pos, g, rows, slots, scales, n_rows, n_acc, mode,
                            NOSCAT_BLK)
    if mode == "noscat":
        raise ValueError("noscat has no bins")
    dev = pos.get_device()
    if dev < 0:
        return packed_bins_plain(pos, g, rows, slots, scales, n_rows, n_acc,
                                 mode)
    _cuda_check("packed_hash_bins", dev, pos, g, rows, slots)
    if n == 0:
        return packed_bins_plain(pos, g, rows, slots, scales, n_rows, n_acc,
                                 mode)
    work, recA, recB = _k4_bins(dev, pos, g, rows, slots, scales, n_rows,
                                n_acc, mode)
    n_tiles = rows.shape[0] * n_acc * -(-n_rows // k4_tile_rows(n_acc, mode))
    n_chunks = -(-n // envelope_lib().env_packed_chunk())
    tile_start = work[:n_tiles * n_chunks + 1:n_chunks]
    m = int(tile_start[-1])
    return tile_start, None if recA is None else recA[:m], recB[:m]


def packed_hash_scatter(pos: torch.Tensor, g: torch.Tensor, rows: torch.Tensor,
                        slots: torch.Tensor, scales, n_rows: int,
                        n_acc: int = 1, mode: str = "v2d",
                        blk: int = NOSCAT_BLK) -> torch.Tensor:
    """K4: per level l and sample n, the 16 lanes slot * 16 + corner * 2 +
    feature of row (l * n_acc + n % n_acc) * n_rows + rows[l, n] get the
    sample's trilinear corner weights times its two upstream gradients.

    pos [N, 3] f32, g [N, 2L] f32 (column f * L + l), rows / slots [L, N]
    int32, scales L floats.  ``mode``: ``v2d`` (``n_acc`` 2 is the
    archive's alt2), ``novals`` (ones into all 128 lanes of the row) or
    ``noscat`` (each level's row 0 gets the first sample of each
    ``blk``-sample block; every contribution is also stored to scratch).
    Returns [L * n_acc * n_rows, 128] f32: on the card v2d and novals sum
    in tiles, in sample order, equal to the twin bit for bit; noscat adds
    its few sums with f32 atomics."""
    L, n, scales = _k4_args(pos, g, rows, slots, scales, n_rows, n_acc, mode,
                            blk)
    dev = pos.get_device()
    if dev < 0:
        return packed_hash_scatter_plain(pos, g, rows, slots, scales, n_rows,
                                         n_acc, mode, blk)
    _cuda_check("packed_hash_scatter", dev, pos, g, rows, slots)
    if n == 0:
        return torch.zeros((L * n_acc * n_rows, LANES), dtype=torch.float32,
                           device=pos.device)
    if mode == "noscat":
        _check_sizes("packed_hash_scatter", 16 * L * n, L * n_rows * LANES)
        out = torch.zeros((L * n_rows, LANES), dtype=torch.float32,
                          device=pos.device)
        scratch = torch.empty((L * n, 16), dtype=torch.float32,
                              device=pos.device)
        _PACKED_NOSCAT(dev, pos.data_ptr(), g.data_ptr(), slots.data_ptr(),
                       scales.ctypes.data, out.data_ptr(), scratch.data_ptr(),
                       n, L, n_rows, blk)
    else:
        work, recA, recB = _k4_bins(dev, pos, g, rows, slots, scales,
                                    n_rows, n_acc, mode)
        out = torch.empty((L * n_acc * n_rows, LANES), dtype=torch.float32,
                          device=pos.device)
        _PACKED_ACC(dev, work.data_ptr(),
                    None if recA is None else recA.data_ptr(),
                    recB.data_ptr(), out.data_ptr(), n, L, n_rows, n_acc,
                    K4_MODES[mode], k4_tile_rows(n_acc, mode))
    packed_hash_scatter.launches += 1
    return out


packed_hash_scatter.launches = 0

KERNELS = {"K1": row_gather, "K2": elem_gather, "K3": row_scatter_add,
           "K4": packed_hash_scatter}

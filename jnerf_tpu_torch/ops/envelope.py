"""The envelope kernels: the card's counterparts of the thirteen
``pallas_call``s of the archived TPU envelope probes (``tools/archive/``).

Four CUDA kernels (`jnerf_tpu_torch/csrc/envelope.cu`, whose head note
names every site each replaces and what bounds it):

- **K1** ``row_gather(table, idx, w=None, lane_sum=False)``: ``table[idx]``
  (f32 or bf16 rows of a multiple of 16 bytes), times ``w`` (f32), or each
  f32 row summed over its lanes;
- **K2** ``elem_gather(src, idx, mode)``: a flat take, or
  ``take_along_axis`` on axis 0 or axis 1 (f32);
- **K3** ``row_scatter_add(idx, vals, n_rows)``: ``out[idx[n]] += vals[n]``
  into a zeroed [n_rows, W] f32 (W a multiple of 4);
- **K4** ``packed_hash_scatter(pos, g, rows, slots, scales, n_rows, ...)``:
  the packed hash-gradient scatter of ``probe_bwd_var.py`` (f2 levels, 128
  lanes a row: slot * 16 + corner * 2 + feature).

Indices are int32, as in the archive, and the wrappers refuse any other
type.  An index outside its table gives a zero (gathers) or is dropped
(scatters), in the kernels and in their twins alike; a one-hot gather of a
128-row table (``probe_tpu.py``'s ``k_onehot``) is K1 under that rule.

Each kernel has a plain PyTorch twin here (``*_plain``).  A wrapper runs
its twin only for CPU tensors; for CUDA tensors it launches the kernel or
raises, and counts the launch in ``.launches``.  K1 and K2 equal their
twins bit for bit; K3 and K4 add with f32 atomics, whose order varies from
run to run.
"""

from __future__ import annotations

import numpy as np
import torch

from .hash_grid import HashGridSpec

MODES = {"flat": 0, "axis0": 1, "axis1": 2}
K4_MODES = {"v2d": 0, "novals": 1, "noscat": 2}
# probe_bwd_var.py's BLK: noscat adds the first sample of each block.
NOSCAT_BLK = 8192
LANES = 128  # a packed row: 8 slots x 8 corners x 2 features


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


def _cuda_check(what: str, *tensors: torch.Tensor, vectors=()):
    """One device, contiguous; the tensors in ``vectors`` (read or added
    as 16-byte vectors) 16-byte aligned."""
    dev = tensors[0].device
    for t in tensors + tuple(vectors):
        if t.device != dev:
            raise ValueError(f"{what}: tensors on {dev} and {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what} takes contiguous tensors")
    for t in vectors:
        if t.data_ptr() % 16:
            raise ValueError(f"{what} reads 16-byte vectors: a tensor is not "
                             "16-byte aligned")


def _check_sizes(what: str, *counts: int):
    """The kernels index with 32-bit integers: each count of elements (or
    16-byte chunks) a launch walks must be below 2^31."""
    if any(c >= 1 << 31 for c in counts):
        raise ValueError(f"{what}: a size reaches 2^31 ({counts})")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


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
    _cuda_check("row_gather", idx, vectors=(table,) + (() if w is None else (w,)))
    n = idx.shape[0]
    _check_sizes("row_gather", n * chunks, table.shape[0] * chunks)
    from .cuda_lib import check, envelope_lib

    if lane_sum:
        out = torch.empty((n,), dtype=torch.float32, device=table.device)
    else:
        out = torch.empty((n, table.shape[1]), dtype=table.dtype,
                          device=table.device)
    mode = 2 if lane_sum else (1 if w is not None else 0)
    with torch.cuda.device(table.device):
        status = envelope_lib().env_row_gather(
            table.data_ptr(), idx.data_ptr(),
            None if w is None else w.data_ptr(), out.data_ptr(), n, chunks,
            table.shape[0], mode, _stream(table))
    check(status, "env_row_gather")
    if n:
        row_gather.launches += 1
    return out


row_gather.launches = 0


# ------------------------------------------------------------------- K2
def _elem_shapes(src, idx, mode):
    if mode not in MODES:
        raise ValueError(f"mode must be one of {sorted(MODES)}, got {mode!r}")
    if mode == "flat":
        return
    if src.dim() != 2 or idx.dim() != 2:
        raise ValueError(f"{mode} takes 2-D src and indices")
    k = 1 if mode == "axis0" else 0
    if src.shape[k] != idx.shape[k]:
        raise ValueError(f"{mode}: src {tuple(src.shape)} and indices "
                         f"{tuple(idx.shape)} differ on axis {k}")


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
    if src.dtype != torch.float32 or src.numel() < 1:
        raise ValueError(f"K2 takes a non-empty f32 src, got {src.dtype}")
    _elem_shapes(src, idx, mode)
    if src.device.type == "cpu":
        return elem_gather_plain(src, idx, mode)
    _cuda_check("elem_gather", src, idx)
    _check_sizes("elem_gather", idx.numel(), src.numel())
    from .cuda_lib import check, envelope_lib

    out = torch.empty(idx.shape, dtype=torch.float32, device=src.device)
    w = 1 if mode == "flat" else idx.shape[1]
    rows, cols = ((src.numel(), 1) if mode == "flat"
                  else (src.shape[0], src.shape[1]))
    with torch.cuda.device(src.device):
        status = envelope_lib().env_elem_gather(
            src.data_ptr(), idx.data_ptr(), out.data_ptr(), idx.numel(),
            MODES[mode], w, rows, cols, _stream(src))
    check(status, "env_elem_gather")
    if idx.numel():
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


def row_scatter_add(idx: torch.Tensor, vals: torch.Tensor,
                    n_rows: int) -> torch.Tensor:
    """K3: [n_rows, W] f32 with ``out[idx[n]] += vals[n]`` (f32 atomics;
    the last bits vary with their order)."""
    _check_idx(idx, 1)
    if vals.dtype != torch.float32 or vals.dim() != 2 \
            or vals.shape[0] != idx.shape[0] or vals.shape[1] % 4 \
            or vals.shape[1] == 0 or n_rows < 1:
        raise ValueError(f"K3 takes vals [N, 4k] f32 beside idx [N] and "
                         f"n_rows >= 1, got {tuple(vals.shape)} {vals.dtype}")
    if vals.device.type == "cpu":
        return row_scatter_add_plain(idx, vals, n_rows)
    _cuda_check("row_scatter_add", idx, vectors=(vals,))
    _check_sizes("row_scatter_add", vals.numel() // 4, n_rows * vals.shape[1])
    from .cuda_lib import check, envelope_lib

    out = torch.zeros((n_rows, vals.shape[1]), dtype=torch.float32,
                      device=vals.device)
    with torch.cuda.device(vals.device):
        status = envelope_lib().env_row_scatter_add(
            idx.data_ptr(), vals.data_ptr(), out.data_ptr(), idx.shape[0],
            vals.shape[1] // 4, n_rows, _stream(vals))
    check(status, "env_row_scatter_add")
    if idx.shape[0]:
        row_scatter_add.launches += 1
    return out


row_scatter_add.launches = 0


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
    summed in ``dtype`` (float64: the exact sum)."""
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
    Returns [L * n_acc * n_rows, 128] f32 (f32 atomics on the card)."""
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
    if pos.device.type == "cpu":
        return packed_hash_scatter_plain(pos, g, rows, slots, scales, n_rows,
                                         n_acc, mode, blk)
    _cuda_check("packed_hash_scatter", pos, g, rows, slots)
    _check_sizes("packed_hash_scatter", 16 * L * n, L * n_acc * n_rows * LANES)
    from .cuda_lib import check, envelope_lib

    out = torch.zeros((L * n_acc * n_rows, LANES), dtype=torch.float32,
                      device=pos.device)
    scratch = (torch.empty((L * n, 16), dtype=torch.float32, device=pos.device)
               if mode == "noscat" else None)
    with torch.cuda.device(pos.device):
        status = envelope_lib().env_packed_hash_scatter(
            pos.data_ptr(), g.data_ptr(), rows.data_ptr(), slots.data_ptr(),
            scales.ctypes.data, out.data_ptr(),
            None if scratch is None else scratch.data_ptr(), n, L, n_rows,
            n_acc, K4_MODES[mode], blk, _stream(pos))
    check(status, "env_packed_hash_scatter")
    if n:
        packed_hash_scatter.launches += 1
    return out


packed_hash_scatter.launches = 0

KERNELS = {"K1": row_gather, "K2": elem_gather, "K3": row_scatter_add,
           "K4": packed_hash_scatter}

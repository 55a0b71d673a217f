"""Linear-hash grid encode: forward gather, table gradient, autograd.

Same semantics as `jnerf_tpu/ops/hash_nbr.py` (`_encode_nbr_core`
:939-956, `_encode_from_nbr` :261-304, `_grad_table_pallas` :651-768).
For each sample n and level l, with e0 the level-local base entry of the
sample's cell and w_c the trilinear weight of corner c:

    out[n, f*L + l]    = sum_c bf16(bf16(table[off_l + (e0 + coff_lc) % E_l, f]) * w_c)
    dtable[entry, f]  += w_c * g[n, f*L + l]            (f32)

The JAX package builds a per-level neighbourhood table so that a TPU
gathers one row per (sample, level); here each corner is read straight
from the master table, so that layout and its adjoint have no
counterpart.

Two CUDA kernels (`jnerf_tpu_torch/csrc/hash_encode.cu`) compute these:
`encode_fwd` (kernel F; 16-byte row loads, the output written in the
encoder's compute dtype, bf16 or f32, as 16-byte stores) and `grad_table`
(kernel B; each level's samples sorted stably by base entry, then each
gradient row's contributions summed in the twin's order and the row
written once, so every launch gives the twin's bits; `grad_table_plan`
returns the sort, `grad_table_plan_plain` its plain twin).  Each wrapper
runs its plain PyTorch twin (`hash_encode_plain`, `grad_table_plain`)
only when given CPU tensors; for CUDA tensors it launches the kernel or
raises.  Each wrapper counts its launches in ``.launches``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from .cuda_lib import Launch, hash_encode_lib
from .hash_grid import (
    HashGridSpec,
    _corner_offsets,
    hash_grid_indices,
    level_masks,
    level_multipliers,
    live_rows,
    piece_plan,
    piece_sums,
)

_U32 = 0xFFFFFFFF
_KERNEL_FEATURES = (1, 2, 4, 8)
_KERNEL_MAX_LEVELS = 32


class LevelConsts(NamedTuple):
    """Host constants of a spec, laid out as the CUDA entry points take
    them (and kept alive here while a launch reads them)."""

    scales: np.ndarray       # [L] f32
    mults: np.ndarray        # [L, 3] u32 (A, B, C)
    sizes: np.ndarray        # [L] u32
    masks: np.ndarray        # [L] u32, 0 = real modulo
    offsets: np.ndarray      # [L] u32
    corner_offs: np.ndarray  # [L, 8] u32


@functools.lru_cache(maxsize=32)
def level_consts(spec: HashGridSpec) -> LevelConsts:
    return LevelConsts(
        scales=np.asarray(spec.scales, np.float32),
        mults=np.ascontiguousarray(level_multipliers(spec), np.uint32),
        sizes=np.asarray(spec.level_sizes, np.uint32),
        masks=np.asarray(level_masks(spec), np.uint32),
        offsets=np.asarray(spec.level_offsets[:-1], np.uint32),
        corner_offs=np.ascontiguousarray(_corner_offsets(spec), np.uint32),
    )


# ------------------------------------------------------------ plain twins
def _cell(consts: LevelConsts, lvl: int, pos: torch.Tensor):
    """Level-local base entry e0 [N] (int64) and per-axis corner factors
    X[d][b] = (1 - f_d) + b * (2 f_d - 1), rounded op by op as the JAX
    package rounds them."""
    scale = float(consts.scales[lvl])
    g, X = [], []
    for d in range(3):
        q = pos[:, d] * scale + 0.5
        gq = torch.floor(q)
        fr = q - gq
        g.append(gq.to(torch.int64) & _U32)
        x0 = 1.0 - fr
        X.append((x0, x0 + (2.0 * fr - 1.0)))
    a, b, c = (int(m) for m in consts.mults[lvl])
    # uint32 wrap of gx*A + gy*B + gz*C, as the JAX package's uint32 math.
    raw = ((g[0] * a & _U32) + (g[1] * b & _U32) + (g[2] * c & _U32)) & _U32
    mask = int(consts.masks[lvl])
    e0 = raw & mask if mask else raw % int(consts.sizes[lvl])
    return e0, X


def _corner_weight(X, c: int) -> torch.Tensor:
    return (X[0][c & 1] * X[1][(c >> 1) & 1]) * X[2][(c >> 2) & 1]


def _corner_entry(consts: LevelConsts, lvl: int, e0, c: int):
    size = int(consts.sizes[lvl])
    return int(consts.offsets[lvl]) + (e0 + int(consts.corner_offs[lvl, c])) % size


def hash_encode_plain(spec: HashGridSpec, table: torch.Tensor,
                      pos: torch.Tensor, e0_out: torch.Tensor | None = None):
    """Plain PyTorch twin of kernel F: [N, 3] -> [N, F*L] f32."""
    consts = level_consts(spec)
    L, F = spec.n_levels, spec.n_features_per_level
    tbl = table.to(torch.bfloat16).float()
    out = torch.empty((pos.shape[0], F, L), dtype=torch.float32,
                      device=pos.device)
    for lvl in range(L):
        e0, X = _cell(consts, lvl, pos)
        if e0_out is not None:
            e0_out[:, lvl] = e0.to(torch.int32)
        acc = torch.zeros((pos.shape[0], F), dtype=torch.float32,
                          device=pos.device)
        for c in range(8):
            w = _corner_weight(X, c)
            rows = tbl[_corner_entry(consts, lvl, e0, c)]
            acc = acc + (rows * w[:, None]).to(torch.bfloat16).float()
        out[:, :, lvl] = acc
    return out.reshape(pos.shape[0], F * L)


def grad_table_plain(spec: HashGridSpec, pos: torch.Tensor, g: torch.Tensor):
    """Plain PyTorch twin of kernel B: dL/dtable [n_entries, F] f32 from
    pos [N, 3] and the f32 upstream gradient g [N, F*L], in kernel B's
    order: each level's samples (those of `hash_grid.live_rows`) sorted
    stably by base entry e0 and cut in pieces (`hash_grid.piece_plan`);
    for corner c each piece's sum of w_c * g goes to entry (e0 +
    corner_off_c) mod size, and each entry adds its pieces from +0.0,
    corner by corner, in sorted order (``index_add_`` adds in index
    order)."""
    consts = level_consts(spec)
    L, F = spec.n_levels, spec.n_features_per_level
    grad = torch.zeros((spec.n_entries, F), dtype=torch.float32,
                       device=pos.device)
    g3 = g.reshape(pos.shape[0], F, L)
    live = live_rows(spec, g)
    for lvl in range(L):
        keep = live[:, lvl]
        e0, X = _cell(consts, lvl, pos[keep])
        gl = g3[keep, :, lvl]
        plan = piece_plan(e0)
        for c in range(8):
            w = _corner_weight(X, c)
            grad.index_add_(0, _corner_entry(consts, lvl, plan[1], c),
                            piece_sums(plan, w[:, None] * gl))
    return grad


def grad_table_plan_plain(spec: HashGridSpec, pos: torch.Tensor,
                          g: torch.Tensor, xor: bool = False):
    """Plain twin of kernel B's sort: (start [n_entries + L + 1] int32,
    order [L * M] int32).  Each level's M items (linear: the samples,
    keyed by their base entry e0; xor: sample * 8 + corner, keyed by the
    corner's entry; an item of a sample left out by `live_rows` keyed by
    the level's size) sorted stably by key, level after level; order holds
    the items' indices within their level, start[off_l + l + k] the first
    position of level l's key k, for k up to the level's size, and
    start[n_entries + L] = L * M."""
    L = spec.n_levels
    n = pos.shape[0]
    offs = torch.tensor(spec.level_offsets[:-1], device=pos.device)
    sizes = torch.tensor(spec.level_sizes, device=pos.device)
    live = live_rows(spec, g).t()  # [L, N]
    if xor:
        idx = hash_grid_indices(spec, pos)[0].long().reshape(n, L, 8)
        keys = (idx - offs[None, :, None]).permute(1, 0, 2).reshape(L, n * 8)
        live = live.repeat_interleave(8, dim=1)
    else:
        consts = level_consts(spec)
        keys = torch.stack([_cell(consts, lvl, pos)[0] for lvl in range(L)])
    keys = torch.where(live, keys, sizes[:, None])
    order = torch.sort(keys, dim=1, stable=True).indices
    rows = keys + (offs + torch.arange(L, device=pos.device))[:, None]
    n_starts = spec.n_entries + L
    start = torch.zeros(n_starts + 1, dtype=torch.int64, device=pos.device)
    start[1:] = torch.cumsum(torch.bincount(rows.reshape(-1),
                                            minlength=n_starts), 0)
    return start.to(torch.int32), order.reshape(-1).to(torch.int32)


# ---------------------------------------------------------- kernel wrappers
_HASH_BWD = Launch(hash_encode_lib, "hash_encode_bwd")


@functools.lru_cache(maxsize=64)
def bwd_layout(spec: HashGridSpec, n: int, xor: bool):
    """Kernel B's work space for n samples: (int32s, where the row starts
    lie in it, where the sorted items lie in it)."""
    sizes = np.asarray(spec.level_sizes, np.uint32)
    out = (ctypes.c_longlong * 3)()
    total = hash_encode_lib().hash_encode_bwd_layout(
        n, spec.n_levels, spec.n_features_per_level, int(xor),
        sizes.ctypes.data, out)
    if total < 0:
        raise ValueError(f"kernel B does not take N={n} samples of "
                         f"{spec.n_levels} levels ({spec.n_entries} entries): "
                         "a size reaches 2^31")
    return tuple(out)


def _require_cuda_inputs(spec: HashGridSpec, pos: torch.Tensor, **named):
    if pos.device.type != "cuda":
        raise ValueError(f"hash kernels take CPU or CUDA tensors, got {pos.device}")
    if pos.dtype != torch.float32 or pos.dim() != 2 or pos.shape[1] != 3:
        raise ValueError(f"pos must be [N, 3] float32, got {tuple(pos.shape)} {pos.dtype}")
    if spec.n_features_per_level not in _KERNEL_FEATURES:
        raise ValueError(f"kernel takes F in {_KERNEL_FEATURES}, "
                         f"got {spec.n_features_per_level}")
    if spec.n_levels > _KERNEL_MAX_LEVELS:
        raise ValueError(f"kernel takes at most {_KERNEL_MAX_LEVELS} levels")
    for name, (t, shape) in named.items():
        if t.device != pos.device or t.dtype != torch.float32 \
                or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape} float32 on {pos.device}, "
                             f"got {tuple(t.shape)} {t.dtype} on {t.device}")
    for t in [pos] + [t for t, _ in named.values()]:
        if not t.is_contiguous():
            raise ValueError("hash kernels take contiguous tensors")


def _const_ptrs(consts: LevelConsts):
    return (consts.scales.ctypes.data, consts.mults.ctypes.data,
            consts.sizes.ctypes.data, consts.masks.ctypes.data,
            consts.offsets.ctypes.data, consts.corner_offs.ctypes.data)


def encode_fwd(spec: HashGridSpec, table: torch.Tensor, pos: torch.Tensor,
               e0_out: torch.Tensor | None = None,
               out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Kernel F: [N, 3] positions -> [N, F*L] feature-major encoding in
    ``out_dtype`` (float32, or bfloat16: each f32 sum rounded once, the
    values of the f32 output cast to bf16).

    ``e0_out`` ([N, L] int32), if given, receives each (sample, level)'s
    base entry, so a check can count index disagreements."""
    if pos.device.type == "cpu":
        return hash_encode_plain(spec, table, pos, e0_out).to(out_dtype)
    L, F = spec.n_levels, spec.n_features_per_level
    n = pos.shape[0]
    _require_cuda_inputs(spec, pos, table=(table, (spec.n_entries, F)))
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"kernel F writes float32 or bfloat16, not {out_dtype}")
    if e0_out is not None and (e0_out.dtype != torch.int32
                               or tuple(e0_out.shape) != (n, L)
                               or e0_out.device != pos.device
                               or not e0_out.is_contiguous()):
        raise ValueError("e0_out must be a contiguous [N, L] int32 CUDA tensor")
    from .cuda_lib import check, hash_encode_lib

    lib = hash_encode_lib()
    if table.data_ptr() % 16:  # the kernel reads rows as 16-byte vectors
        table = table.clone()
    out = torch.empty((n, F * L), dtype=out_dtype, device=pos.device)
    consts = level_consts(spec)
    with torch.cuda.device(pos.device):
        status = lib.hash_encode_fwd(
            pos.data_ptr(), table.data_ptr(), out.data_ptr(),
            None if e0_out is None else e0_out.data_ptr(),
            n, L, F, int(out_dtype == torch.bfloat16), *_const_ptrs(consts),
            torch.cuda.current_stream(pos.device).cuda_stream)
    check(status, "hash_encode_fwd")
    encode_fwd.launches += 1
    return out


encode_fwd.launches = 0


def _bwd(spec: HashGridSpec, pos, g, plan_only: bool, grad=None,
         work=None):
    """Launch kernel B (plan_only: its sort alone): (grad, work).  The
    caller may pass the output ``grad`` and the work space ``work``."""
    L, F = spec.n_levels, spec.n_features_per_level
    n = pos.shape[0]
    _require_cuda_inputs(spec, pos, g=(g, (n, F * L)))
    size = bwd_layout(spec, n, False)[0]
    if work is None:
        work = torch.empty(size, dtype=torch.int32, device=pos.device)
    elif (work.dtype != torch.int32 or tuple(work.shape) != (size,)
          or work.device != pos.device or not work.is_contiguous()):
        raise ValueError(f"work must be a contiguous [{size}] int32 tensor "
                         f"on {pos.device}")
    if grad is None:
        grad = torch.empty((0 if plan_only else spec.n_entries, F),
                           dtype=torch.float32, device=pos.device)
    else:
        _require_cuda_inputs(spec, pos, grad=(grad, (spec.n_entries, F)))
    _HASH_BWD(pos.get_device(), pos.data_ptr(), g.data_ptr(), grad.data_ptr(),
              work.data_ptr(), n, L, F, *_const_ptrs(level_consts(spec)),
              int(plan_only))
    return grad, work


def grad_table(spec: HashGridSpec, pos: torch.Tensor, g: torch.Tensor,
               out: torch.Tensor | None = None,
               work: torch.Tensor | None = None) -> torch.Tensor:
    """Kernel B: table gradient [n_entries, F] f32, each entry's
    contributions summed in `grad_table_plain`'s order, so equal to the
    twin bit for bit on every launch.  ``out`` ([n_entries, F] f32), if
    given, receives it, and ``work`` (int32, ``bwd_layout``'s size), if
    given, is the work space: a check can place both between guard
    zones."""
    if pos.device.type == "cpu":
        grad = grad_table_plain(spec, pos, g)
        return grad if out is None else out.copy_(grad)
    if pos.shape[0] == 0:  # nothing to sum
        if out is not None:
            return out.zero_()
        return torch.zeros((spec.n_entries, spec.n_features_per_level),
                           dtype=torch.float32, device=pos.device)
    grad, _ = _bwd(spec, pos, g, False, out, work)
    grad_table.launches += 1
    return grad


grad_table.launches = 0


def grad_table_plan(spec: HashGridSpec, pos: torch.Tensor, g: torch.Tensor):
    """Kernel B's sort alone, as `grad_table_plan_plain` returns it (on
    CPU tensors, that twin).  Not counted: kernel B's launches are counted
    by `grad_table`."""
    if pos.device.type == "cpu":
        return grad_table_plan_plain(spec, pos, g)
    _, at_start, at_order = bwd_layout(spec, pos.shape[0], False)
    _, work = _bwd(spec, pos, g, True)
    return (work[at_start:at_start + spec.n_entries + spec.n_levels + 1],
            work[at_order:at_order + spec.n_levels * pos.shape[0]])


class HashEncode(torch.autograd.Function):
    """Kernel F forward, kernel B backward; positions get no gradient
    (as in the reference, `grid_encode.py:190`)."""

    @staticmethod
    def forward(ctx, table, pos, spec, out_dtype):
        ctx.spec = spec
        ctx.save_for_backward(pos)
        return encode_fwd(spec, table, pos, out_dtype=out_dtype)

    @staticmethod
    def backward(ctx, g):
        (pos,) = ctx.saved_tensors
        return (grad_table(ctx.spec, pos, g.float().contiguous()), None, None,
                None)


def hash_encode_nbr(spec: HashGridSpec, table: torch.Tensor,
                    pos: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    """[N, 3] warped positions in [0, 1] -> [N, F*L] feature-major
    encoding, differentiable in ``table``, in ``compute_dtype`` (float32
    when None).  Kernel F writes float32 or bfloat16 itself."""
    pos = pos.detach().contiguous()
    out_dtype = compute_dtype or torch.float32
    if torch.is_grad_enabled() and table.requires_grad:
        return HashEncode.apply(table, pos, spec, out_dtype)
    return encode_fwd(spec, table.detach(), pos, out_dtype=out_dtype)

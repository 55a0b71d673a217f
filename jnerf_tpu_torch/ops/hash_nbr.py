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
`encode_fwd` (kernel F) and `grad_table` (kernel B; 16-byte vector
reductions, a warp's contributions summed per entry before they reach
L2).  Each wrapper runs its plain PyTorch twin (`hash_encode_plain`,
`grad_table_plain`) only when given CPU tensors; for CUDA tensors it
launches the kernel or raises.  Each wrapper counts its launches in
``.launches``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from .hash_grid import HashGridSpec, _corner_offsets, level_masks, level_multipliers

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
    pos [N, 3] and the f32 upstream gradient g [N, F*L]."""
    consts = level_consts(spec)
    L, F = spec.n_levels, spec.n_features_per_level
    grad = torch.zeros((spec.n_entries, F), dtype=torch.float32,
                       device=pos.device)
    g3 = g.reshape(pos.shape[0], F, L)
    for lvl in range(L):
        e0, X = _cell(consts, lvl, pos)
        gl = g3[:, :, lvl]
        for c in range(8):
            w = _corner_weight(X, c)
            grad.index_add_(0, _corner_entry(consts, lvl, e0, c),
                            w[:, None] * gl)
    return grad


# ---------------------------------------------------------- kernel wrappers
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
               e0_out: torch.Tensor | None = None) -> torch.Tensor:
    """Kernel F: [N, 3] positions -> [N, F*L] f32 feature-major encoding.

    ``e0_out`` ([N, L] int32), if given, receives each (sample, level)'s
    base entry, so a check can count index disagreements."""
    if pos.device.type == "cpu":
        return hash_encode_plain(spec, table, pos, e0_out)
    L, F = spec.n_levels, spec.n_features_per_level
    n = pos.shape[0]
    _require_cuda_inputs(spec, pos, table=(table, (spec.n_entries, F)))
    if e0_out is not None and (e0_out.dtype != torch.int32
                               or tuple(e0_out.shape) != (n, L)
                               or e0_out.device != pos.device
                               or not e0_out.is_contiguous()):
        raise ValueError("e0_out must be a contiguous [N, L] int32 CUDA tensor")
    from .cuda_lib import check, hash_encode_lib

    lib = hash_encode_lib()
    out = torch.empty((n, F * L), dtype=torch.float32, device=pos.device)
    consts = level_consts(spec)
    with torch.cuda.device(pos.device):
        status = lib.hash_encode_fwd(
            pos.data_ptr(), table.data_ptr(), out.data_ptr(),
            None if e0_out is None else e0_out.data_ptr(),
            n, L, F, *_const_ptrs(consts),
            torch.cuda.current_stream(pos.device).cuda_stream)
    check(status, "hash_encode_fwd")
    encode_fwd.launches += 1
    return out


encode_fwd.launches = 0


def grad_table(spec: HashGridSpec, pos: torch.Tensor,
               g: torch.Tensor) -> torch.Tensor:
    """Kernel B: table gradient [n_entries, F] f32 (f32 atomics; the sum
    order, and so the last bits, vary from run to run)."""
    if pos.device.type == "cpu":
        return grad_table_plain(spec, pos, g)
    L, F = spec.n_levels, spec.n_features_per_level
    n = pos.shape[0]
    _require_cuda_inputs(spec, pos, g=(g, (n, F * L)))
    from .cuda_lib import check, hash_encode_lib

    lib = hash_encode_lib()
    grad = torch.zeros((spec.n_entries, F), dtype=torch.float32,
                       device=pos.device)
    consts = level_consts(spec)
    with torch.cuda.device(pos.device):
        status = lib.hash_encode_bwd(
            pos.data_ptr(), g.data_ptr(), grad.data_ptr(), n, L, F,
            *_const_ptrs(consts),
            torch.cuda.current_stream(pos.device).cuda_stream)
    check(status, "hash_encode_bwd")
    grad_table.launches += 1
    return grad


grad_table.launches = 0


class HashEncode(torch.autograd.Function):
    """Kernel F forward, kernel B backward; positions get no gradient
    (as in the reference, `grid_encode.py:190`)."""

    @staticmethod
    def forward(ctx, table, pos, spec):
        ctx.spec = spec
        ctx.save_for_backward(pos)
        return encode_fwd(spec, table, pos)

    @staticmethod
    def backward(ctx, g):
        (pos,) = ctx.saved_tensors
        return grad_table(ctx.spec, pos, g.float().contiguous()), None, None


def hash_encode_nbr(spec: HashGridSpec, table: torch.Tensor,
                    pos: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    """[N, 3] warped positions in [0, 1] -> [N, F*L] feature-major
    encoding, differentiable in ``table``; cast to ``compute_dtype`` if
    given."""
    pos = pos.detach().contiguous()
    if torch.is_grad_enabled() and table.requires_grad:
        out = HashEncode.apply(table, pos, spec)
    else:
        out = encode_fwd(spec, table.detach(), pos)
    if compute_dtype is not None:
        out = out.to(compute_dtype)
    return out

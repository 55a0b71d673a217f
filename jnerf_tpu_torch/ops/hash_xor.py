"""Xor-hash grid encode (``hash_indexing='xor'``): forward, table
gradient, autograd.

Same semantics as `jnerf_tpu/ops/hash_grid.py::hash_encode` (:186-213) and
its autodiff backward: the reference's own hash, which reference
checkpoints need.  The geometry and the plain twins live in
`hash_grid` (`hash_grid_indices`, `hash_encode_xor_plain`,
`grad_table_xor_plain`); on the card kernels F and B of
`jnerf_tpu_torch/csrc/hash_encode.cu` run in xor mode, built with the
spec's ``hash_func``.  The rules are the linear mode's (`hash_nbr`): a
wrapper runs its twin only when given CPU tensors; for CUDA tensors it
launches the kernel or raises; each counts its launches in
``.launches``.

Kernel B sorts each level's (sample, corner) items stably by entry and
sums each entry's in `grad_table_xor_plain`'s order (sample-major), so it
equals the twin bit for bit on every launch; `grad_table_xor_plan`
returns the sort (`hash_nbr.grad_table_plan_plain(spec, pos, g,
xor=True)` is its twin).

The one deviation from the JAX package: its table gradient sums the bf16
contributions in bf16 (the cotangent of the bf16 cast through
``jnp.take``); kernel B and its twin sum the same contributions in f32.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from .hash_grid import (
    HashGridSpec,
    grad_table_xor_plain,
    hash_encode_xor_plain,
    xor_level_consts,
)
from .cuda_lib import Launch, hash_encode_lib
from .hash_nbr import _require_cuda_inputs, bwd_layout, grad_table_plan_plain


class XorConsts(NamedTuple):
    """Host constants of a spec in xor mode, as the CUDA entry points take
    them (and kept alive here while a launch reads them)."""

    scales: np.ndarray   # [L] f32
    mults: np.ndarray    # [L, 3] u32: (1, res, res^2) on dense levels
    sizes: np.ndarray    # [L] u32
    offsets: np.ndarray  # [L] u32
    hashed: np.ndarray   # [L] u32: 1 where the level is hashed


@functools.lru_cache(maxsize=32)
def xor_consts(spec: HashGridSpec) -> XorConsts:
    lv = xor_level_consts(spec)
    return XorConsts(
        scales=np.asarray([s for s, *_ in lv], np.float32),
        mults=np.ascontiguousarray(
            [(1, r, (r * r) & 0xFFFFFFFF) for _, r, *_ in lv], np.uint32),
        sizes=np.asarray([z for _, _, z, _, _ in lv], np.uint32),
        offsets=np.asarray([o for *_, o, _ in lv], np.uint32),
        hashed=np.asarray([int(h) for *_, h in lv], np.uint32),
    )


def _launch(name: str, spec: HashGridSpec, pos, src, dst, bf16: bool):
    from .cuda_lib import check, hash_encode_lib

    lib = hash_encode_lib(spec.hash_func)
    c = xor_consts(spec)
    with torch.cuda.device(pos.device):
        status = getattr(lib, name)(
            pos.data_ptr(), src.data_ptr(), dst.data_ptr(), pos.shape[0],
            spec.n_levels, spec.n_features_per_level, int(bf16),
            c.scales.ctypes.data, c.mults.ctypes.data, c.sizes.ctypes.data,
            c.offsets.ctypes.data, c.hashed.ctypes.data,
            torch.cuda.current_stream(pos.device).cuda_stream)
    check(status, name)


@functools.lru_cache(maxsize=None)
def _bwd_launch(hash_func: str) -> Launch:
    """Kernel B in xor mode from the library of ``hash_func``."""
    return Launch(lambda: hash_encode_lib(hash_func), "hash_encode_xor_bwd")


def _bwd(spec: HashGridSpec, pos, g, bf16: bool, plan_only: bool):
    """Launch kernel B in xor mode (plan_only: its sort alone): (grad,
    work)."""
    L, F = spec.n_levels, spec.n_features_per_level
    n = pos.shape[0]
    _require_cuda_inputs(spec, pos, g=(g, (n, F * L)))
    work = torch.empty(bwd_layout(spec, n, True)[0], dtype=torch.int32,
                       device=pos.device)
    grad = torch.empty((0 if plan_only else spec.n_entries, F),
                       dtype=torch.float32, device=pos.device)
    c = xor_consts(spec)
    _bwd_launch(spec.hash_func)(
        pos.get_device(), pos.data_ptr(), g.data_ptr(), grad.data_ptr(),
        work.data_ptr(), n, L, F, int(bf16), c.scales.ctypes.data,
        c.mults.ctypes.data, c.sizes.ctypes.data, c.offsets.ctypes.data,
        c.hashed.ctypes.data, int(plan_only))
    return grad, work


def encode_xor_fwd(spec: HashGridSpec, table: torch.Tensor, pos: torch.Tensor,
                   out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Kernel F in xor mode: [N, 3] positions -> [N, F*L] feature-major
    encoding in ``out_dtype`` (bfloat16: the JAX package's bf16 path, one
    rounding of each f32 sum; float32: f32 throughout)."""
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"kernel F writes float32 or bfloat16, not {out_dtype}")
    if pos.device.type == "cpu":
        return hash_encode_xor_plain(spec, table, pos, out_dtype).to(out_dtype)
    L, F = spec.n_levels, spec.n_features_per_level
    _require_cuda_inputs(spec, pos, table=(table, (spec.n_entries, F)))
    if table.data_ptr() % 16:  # the kernel reads rows as 16-byte vectors
        table = table.clone()
    out = torch.empty((pos.shape[0], F * L), dtype=out_dtype, device=pos.device)
    _launch("hash_encode_xor_fwd", spec, pos, table, out,
            out_dtype == torch.bfloat16)
    encode_xor_fwd.launches += 1
    return out


encode_xor_fwd.launches = 0


def grad_table_xor(spec: HashGridSpec, pos: torch.Tensor, g: torch.Tensor,
                   bf16: bool) -> torch.Tensor:
    """Kernel B in xor mode: table gradient [n_entries, F] f32 from the f32
    upstream gradient g [N, F*L]; each contribution formed as the JAX
    backward forms it (bf16(bf16(w) * g) when ``bf16``), summed in f32 in
    the twin's order: equal to the twin bit for bit."""
    if pos.device.type == "cpu":
        return grad_table_xor_plain(spec, pos, g, bf16)
    if pos.shape[0] == 0:  # nothing to sum
        return torch.zeros((spec.n_entries, spec.n_features_per_level),
                           dtype=torch.float32, device=pos.device)
    grad, _ = _bwd(spec, pos, g, bf16, False)
    grad_table_xor.launches += 1
    return grad


grad_table_xor.launches = 0


def grad_table_xor_plan(spec: HashGridSpec, pos: torch.Tensor,
                        g: torch.Tensor):
    """Kernel B's sort in xor mode alone, as
    `hash_nbr.grad_table_plan_plain(spec, pos, g, xor=True)` returns it
    (on CPU tensors, that twin).  Not counted."""
    if pos.device.type == "cpu":
        return grad_table_plan_plain(spec, pos, g, xor=True)
    n, L = pos.shape[0], spec.n_levels
    _, at_start, at_order = bwd_layout(spec, n, True)
    _, work = _bwd(spec, pos, g, False, True)
    return (work[at_start:at_start + spec.n_entries + L + 1],
            work[at_order:at_order + L * n * 8])


class HashEncodeXor(torch.autograd.Function):
    """Kernel F forward, kernel B backward in xor mode; positions get no
    gradient (as in the reference, `grid_encode.py:190`)."""

    @staticmethod
    def forward(ctx, table, pos, spec, out_dtype):
        ctx.spec, ctx.bf16 = spec, out_dtype == torch.bfloat16
        ctx.save_for_backward(pos)
        return encode_xor_fwd(spec, table, pos, out_dtype)

    @staticmethod
    def backward(ctx, g):
        (pos,) = ctx.saved_tensors
        return (grad_table_xor(ctx.spec, pos, g.float().contiguous(), ctx.bf16),
                None, None, None)


def hash_encode_xor(spec: HashGridSpec, table: torch.Tensor,
                    pos: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    """[N, 3] warped positions -> [N, F*L] feature-major encoding in
    ``compute_dtype`` (float32 when None), differentiable in ``table``."""
    pos = pos.detach().contiguous()
    out_dtype = compute_dtype or torch.float32
    if torch.is_grad_enabled() and table.requires_grad:
        return HashEncodeXor.apply(table, pos, spec, out_dtype)
    return encode_xor_fwd(spec, table.detach(), pos, out_dtype)

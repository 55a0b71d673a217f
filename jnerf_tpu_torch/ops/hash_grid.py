"""Multiresolution hash-grid geometry, the per-level linear hash and the
reference's xor hash.

`HashGridSpec` has the same fields and derived geometry as
`jnerf_tpu/ops/hash_grid.py::HashGridSpec`, so a table trained by either
package reads the same in the other.  `level_multipliers` and
`_corner_offsets` are copies of `jnerf_tpu/ops/hash_grid_rows.py:47-74`:
they must draw from ``default_rng(0x5F3759DF)`` in the same order, or the
hashed levels index a different table.

The xor mode (``hash_indexing='xor'``, the reference's own hash, which
reference checkpoints need) follows `jnerf_tpu/ops/hash_grid.py:39-213`:
corner (c0, c1, c2) of level l sits at ``pg_d = u32(floor(x_d * scale_l +
0.5)) + c_d`` (f32 -> uint32 saturates, as XLA converts), and its entry is
``off_l + (pg0 + pg1 res + pg2 res^2) % size_l`` on a dense level
(res^3 <= size_l), else ``off_l + HASH(pg0, pg1, pg2) % size_l`` with HASH
the config's ``hash_func`` in uint32 arithmetic; its weight is
``(wd0 * wd1) * wd2`` with ``wd = frac`` or ``1 - frac``.
`hash_grid_indices` gives both; `hash_encode_xor_plain` and
`grad_table_xor_plain` are the plain twins of kernels F and B in xor mode
(`jnerf_tpu_torch/csrc/hash_encode.cu`).
"""

from __future__ import annotations

import ast
import functools
import math
import operator
from dataclasses import dataclass, field
from typing import Tuple

import numpy as np
import torch

DEFAULT_HASH_FUNC = "p0 ^ p1 * 19349663 ^ p2 * 83492791"
# Kernel B's piece (`csrc/hash_encode.cu`'s kPiece): a table-gradient row
# sums its contributions in pieces cut at multiples of PIECE sorted
# positions (`piece_plan`).
PIECE = 32


@dataclass(frozen=True)
class HashGridSpec:
    """Static geometry of the hash grid (all host-side constants)."""

    n_levels: int = 16
    n_features_per_level: int = 2
    base_resolution: int = 16
    log2_hashmap_size: int = 19
    aabb_scale: float = 1.0
    desired_resolution: float = 2048.0
    hash_func: str = DEFAULT_HASH_FUNC
    # Extra cap on hashed-level table size (entries), on top of
    # 2**log2_hashmap_size (`HashEncoder`'s fast cap).  None = no extra cap.
    max_level_size: int | None = None
    # Derived (filled in __post_init__):
    per_level_scale: float = field(init=False, default=0.0)
    scales: Tuple[float, ...] = field(init=False, default=())
    resolutions: Tuple[int, ...] = field(init=False, default=())
    level_sizes: Tuple[int, ...] = field(init=False, default=())
    level_offsets: Tuple[int, ...] = field(init=False, default=())
    n_entries: int = field(init=False, default=0)

    def __post_init__(self):
        pls = math.exp(
            math.log(self.desired_resolution * self.aabb_scale / self.base_resolution)
            / max(self.n_levels - 1, 1)
        )
        scales, resolutions, sizes, offsets = [], [], [], [0]
        max_entries = 1 << self.log2_hashmap_size
        if self.max_level_size is not None:
            max_entries = min(max_entries, self.max_level_size)
        for lvl in range(self.n_levels):
            scale = 2.0 ** (lvl * math.log2(pls)) * self.base_resolution - 1.0
            res = int(math.ceil(scale)) + 1
            dense = res ** 3
            size = min(-(-dense // 8) * 8, max_entries)  # 8-aligned, capped
            scales.append(scale)
            resolutions.append(res)
            sizes.append(size)
            offsets.append(offsets[-1] + size)
        object.__setattr__(self, "per_level_scale", pls)
        object.__setattr__(self, "scales", tuple(scales))
        object.__setattr__(self, "resolutions", tuple(resolutions))
        object.__setattr__(self, "level_sizes", tuple(sizes))
        object.__setattr__(self, "level_offsets", tuple(offsets))
        object.__setattr__(self, "n_entries", offsets[-1])

    @property
    def out_dim(self) -> int:
        return self.n_levels * self.n_features_per_level

    def init_table(self, generator: torch.Generator):
        """Uniform +-1e-4 f32 init on the generator's device."""
        u = torch.rand((self.n_entries, self.n_features_per_level),
                       generator=generator, device=generator.device)
        return u * 2e-4 - 1e-4


def level_multipliers(spec: HashGridSpec) -> Tuple[Tuple[int, int, int], ...]:
    """(A, B, C) per level: dense strides for dense levels, randomized odd
    constants for hashed levels (decorrelated across levels)."""
    rng = np.random.default_rng(0x5F3759DF)
    out = []
    for lvl in range(spec.n_levels):
        res = spec.resolutions[lvl]
        size = spec.level_sizes[lvl]
        if res ** 3 <= size:
            out.append((1, res, res * res))
        else:
            a = int(rng.integers(1 << 16, 1 << 30)) | 1
            b = int(rng.integers(1 << 16, 1 << 30)) | 1
            c = int(rng.integers(1 << 16, 1 << 30)) | 1
            out.append((a, b, c))
    return tuple(out)


def _corner_offsets(spec: HashGridSpec):
    """[L, 8] additive index offset of each corner, mod the level size."""
    mults = level_multipliers(spec)
    offs = np.zeros((spec.n_levels, 8), np.int64)
    for lvl, (a, b, c) in enumerate(mults):
        size = spec.level_sizes[lvl]
        for corner in range(8):
            dx, dy, dz = corner & 1, (corner >> 1) & 1, (corner >> 2) & 1
            offs[lvl, corner] = (dx * a + dy * b + dz * c) % size
    return offs


def level_masks(spec: HashGridSpec) -> Tuple[int, ...]:
    """Per level, the AND mask that stands for ``% size``, or 0 where a
    real modulo is needed.  Dense levels never overflow their size
    (x + y*res + z*res^2 < res^3 <= size); power-of-two hashed levels mask
    with size-1 (`jnerf_tpu/ops/hash_nbr.py::_level_mask`)."""
    out = []
    for res, sz in zip(spec.resolutions, spec.level_sizes):
        if res ** 3 <= sz:
            out.append(0xFFFFFFFF)
        elif sz & (sz - 1) == 0:
            out.append(sz - 1)
        else:
            out.append(0)
    return tuple(out)


# --------------------------------------------------------------- xor hash
_U32 = 0xFFFFFFFF
_HASH_OPS = {ast.BitXor: "^", ast.Mult: "*", ast.Add: "+", ast.BitAnd: "&",
             ast.BitOr: "|", ast.LShift: "<<", ast.RShift: ">>"}
# Python's own ints: how the JAX package folds a constant subexpression.
_PY_OPS = {"^": operator.xor, "*": operator.mul, "+": operator.add,
           "&": operator.and_, "|": operator.or_, "<<": operator.lshift,
           ">>": operator.rshift}


def _mul32(a, b):
    """a * b mod 2^32 for int64 tensors (or ints) in [0, 2^32), without
    int64 overflow: the high half of a multiplies b separately."""
    lo = (a & 0xFFFF) * b
    hi = (((a >> 16) * b) & 0xFFFF) << 16
    return (lo + hi) & _U32


def _apply_op(op: str, a, b):
    """One uint32 operation, as XLA computes it on uint32 arrays (shifts by
    32 or more give 0), on int64 tensors in [0, 2^32) (or Python ints, save
    for shifts)."""
    if op == "^":
        return a ^ b
    if op == "&":
        return a & b
    if op == "|":
        return a | b
    if op == "+":
        return (a + b) & _U32
    if op == "*":
        return _mul32(a, b)
    b = torch.as_tensor(b)
    amt = torch.clamp(b, max=31)
    shifted = (a << amt) & _U32 if op == "<<" else a >> amt
    return torch.where(b < 32, shifted, torch.zeros_like(shifted))


@dataclass(frozen=True)
class HashFunc:
    """A validated ``hash_func`` string: ``tree`` is its expression as
    nested (op, left, right) tuples over "p0", "p1", "p2" and ints in
    [0, 2^32); ``c_expr`` is the same expression as CUDA C over uint32_t
    (every operation parenthesized, literals with a u suffix, shifts through
    jn_shl / jn_shr, which give 0 for 32 or more, as XLA does)."""

    expr: str
    tree: object
    c_expr: str

    def __call__(self, p0, p1, p2):
        env = {"p0": p0, "p1": p1, "p2": p2}

        def ev(node):
            if isinstance(node, str):
                return env[node]
            if isinstance(node, int):
                return node
            op, a, b = node
            return _apply_op(op, ev(a), ev(b))

        out = ev(self.tree)
        if isinstance(out, int) and torch.is_tensor(p0):
            return torch.full_like(p0, out)
        return out


@functools.lru_cache(maxsize=32)
def _compile_hash_func(expr: str) -> HashFunc:
    """Parse and check the config's C hash expression.  It may hold only
    p0, p1, p2, integer literals, ``^ * + & | << >>`` and parentheses, to
    which Python and C give the same precedence; constant subexpressions
    are folded and must lie in [0, 2^32), where the JAX package's uint32
    arithmetic agrees with C's.  Anything else raises ValueError."""
    try:
        root = ast.parse(expr, mode="eval").body
    except SyntaxError as e:
        raise ValueError(f"hash_func {expr!r} does not parse: {e.msg}") from None

    def build(node):
        if isinstance(node, ast.Name) and node.id in ("p0", "p1", "p2"):
            return node.id
        if isinstance(node, ast.Constant) and type(node.value) is int:
            val = node.value
        elif isinstance(node, ast.BinOp) and type(node.op) in _HASH_OPS:
            op = _HASH_OPS[type(node.op)]
            a, b = build(node.left), build(node.right)
            if not (isinstance(a, int) and isinstance(b, int)):
                return (op, a, b)
            val = _PY_OPS[op](a, b)
        else:
            raise ValueError(
                f"hash_func {expr!r}: {ast.unparse(node)!r} is not allowed; "
                "use p0, p1, p2, integer literals, ^ * + & | << >> and "
                "parentheses")
        if not 0 <= val <= _U32:
            raise ValueError(f"hash_func {expr!r}: the constant {val} is "
                             "outside [0, 2^32)")
        return val

    def emit(node):
        if isinstance(node, str):
            return node
        if isinstance(node, int):
            return f"{node}u"
        op, a, b = node
        if op in ("<<", ">>"):
            fn = "jn_shl" if op == "<<" else "jn_shr"
            return f"{fn}({emit(a)}, {emit(b)})"
        return f"({emit(a)} {op} {emit(b)})"

    tree = build(root)
    return HashFunc(expr=expr, tree=tree, c_expr=emit(tree))


def xor_level_consts(spec: HashGridSpec):
    """Per level of the xor mode: (scale f32, res, size, offset, hashed);
    a level is hashed where res^3 exceeds its size."""
    return [(np.float32(spec.scales[lvl]), spec.resolutions[lvl],
             spec.level_sizes[lvl], spec.level_offsets[lvl],
             spec.resolutions[lvl] ** 3 > spec.level_sizes[lvl])
            for lvl in range(spec.n_levels)]


def hash_grid_indices(spec: HashGridSpec, pos: torch.Tensor):
    """Corner entries and trilinear weights of the xor mode.

    pos: [N, 3] float32 warped positions.  Returns idx [N, L*8] int32
    (entries into the flat table, level-major, corner c at bit d of c along
    axis d) and weights [N, L*8] float32, as
    `jnerf_tpu/ops/hash_grid.py::hash_grid_indices`."""
    hash_fn = _compile_hash_func(spec.hash_func)
    idx, wts = [], []
    for scale, res, size, offset, hashed in xor_level_consts(spec):
        g, fr = [], []
        for d in range(3):
            q = pos[:, d] * float(scale) + 0.5
            gq = torch.floor(q)
            fr.append(q - gq)
            g.append(gq.to(torch.int64).clamp_(0, _U32))
        for c in range(8):
            bits = [(c >> d) & 1 for d in range(3)]
            pg = [(g[d] + bits[d]) & _U32 for d in range(3)]
            if hashed:
                h = hash_fn(*pg)
            else:
                h = (pg[0] + _mul32(pg[1], res)
                     + _mul32(_mul32(pg[2], res), res)) & _U32
            idx.append(h % size + offset)
            wd = [fr[d] if bits[d] else 1.0 - fr[d] for d in range(3)]
            wts.append((wd[0] * wd[1]) * wd[2])
    return (torch.stack(idx, dim=1).to(torch.int32),
            torch.stack(wts, dim=1))


def hash_encode_xor_plain(spec: HashGridSpec, table: torch.Tensor,
                          pos: torch.Tensor, compute_dtype=None):
    """Plain twin of kernel F in xor mode: [N, 3] -> [N, F*L]
    feature-major, in ``compute_dtype``.  bf16: bf16(sum_c bf16(bf16(t) *
    bf16(w_c))), the 8 products summed in f32 (corner order) and rounded
    once; None or float32: f32 throughout."""
    L, F = spec.n_levels, spec.n_features_per_level
    n = pos.shape[0]
    idx, w = hash_grid_indices(spec, pos)
    bf16 = compute_dtype == torch.bfloat16
    tbl = table.to(torch.bfloat16).float() if bf16 else table.float()
    if bf16:
        w = w.to(torch.bfloat16).float()
    rows = tbl[idx.long()].reshape(n, L, 8, F)
    w = w.reshape(n, L, 8, 1)
    acc = torch.zeros((n, L, F), dtype=torch.float32, device=pos.device)
    for c in range(8):
        prod = rows[:, :, c] * w[:, :, c]
        acc = acc + (prod.to(torch.bfloat16).float() if bf16 else prod)
    out = acc.permute(0, 2, 1).reshape(n, F * L)
    return out.to(torch.bfloat16) if bf16 else out


def xor_contributions(spec: HashGridSpec, pos: torch.Tensor, g: torch.Tensor,
                      bf16: bool):
    """The table-gradient terms of the xor mode: entries [N*L*8] (int64)
    and values [N*L*8, F] f32, each ``w_c * g[n, f*L + l]`` formed as the
    JAX backward forms it: bf16(bf16(w_c) * g) in bf16 mode, else f32."""
    L, F = spec.n_levels, spec.n_features_per_level
    n = pos.shape[0]
    idx, w = hash_grid_indices(spec, pos)
    if bf16:
        w = w.to(torch.bfloat16).float()
    gl = g.float().reshape(n, F, L).permute(0, 2, 1)  # [N, L, F]
    vals = w.reshape(n, L, 8, 1) * gl[:, :, None, :]
    if bf16:
        vals = vals.to(torch.bfloat16).float()
    return idx.reshape(-1).long(), vals.reshape(-1, F)


def live_rows(spec: HashGridSpec, g: torch.Tensor) -> torch.Tensor:
    """[N, L] bool: the (sample, level)s whose F upstream values are not
    all zero.  The others (the compaction's empty slots) add exact zeros,
    which leave an f32 sum's bits as they are, and kernel B leaves them
    out of its sort."""
    n, L, F = g.shape[0], spec.n_levels, spec.n_features_per_level
    return (g.reshape(n, F, L) != 0).any(dim=1)


def piece_plan(keys: torch.Tensor):
    """Kernel B's pieces of one level: its M items (keys [M], in item
    order) sorted stably by key, each run of one key cut where the sorted
    position crosses a multiple of PIECE.  Returns (the sort, each
    piece's key, each sorted item's piece), the pieces by key, then
    position."""
    m = keys.shape[0]
    order = torch.sort(keys, stable=True).indices
    n_pieces = -(-m // PIECE)
    piece = keys[order] * n_pieces + torch.arange(m, device=keys.device) \
        // PIECE
    uniq, pid = torch.unique_consecutive(piece, return_inverse=True)
    return order, uniq // n_pieces, pid


def piece_sums(plan, vals: torch.Tensor) -> torch.Tensor:
    """Each piece of ``plan`` (`piece_plan`) summed from +0.0 in sorted
    order (``index_add_`` adds in index order): [n_pieces, F] f32 from
    the items' vals [M, F] f32 in item order."""
    order, keys, pid = plan
    return torch.zeros((keys.shape[0], vals.shape[1]), dtype=torch.float32,
                       device=vals.device).index_add_(0, pid, vals[order])


def grad_table_xor_plain(spec: HashGridSpec, pos: torch.Tensor,
                         g: torch.Tensor, bf16: bool):
    """Plain twin of kernel B in xor mode: dL/dtable [n_entries, F] f32,
    the contributions of `xor_contributions` summed in f32: each level's
    (sample, corner) items, sample-major (but those of `live_rows`' left-out
    samples), sorted stably by entry and
    summed in pieces (`piece_plan`), then each entry's pieces summed from
    +0.0 in order."""
    L, F = spec.n_levels, spec.n_features_per_level
    n = pos.shape[0]
    idx, vals = xor_contributions(spec, pos, g, bf16)
    idx, vals = idx.reshape(n, L, 8), vals.reshape(n, L, 8, F)
    live = live_rows(spec, g.float())
    grad = torch.zeros((spec.n_entries, F), dtype=torch.float32,
                       device=pos.device)
    for lvl in range(L):
        keep = live[:, lvl]
        plan = piece_plan(idx[keep, lvl].reshape(-1))
        grad.index_add_(0, plan[1],
                        piece_sums(plan, vals[keep, lvl].reshape(-1, F)))
    return grad

"""Data parallelism over a torch.distributed process group.

Counterpart of `jnerf_tpu/parallel/__init__.py`.  The JAX package shards
the ray batch over a 1-D ``data`` mesh inside one jitted step and lets XLA
place the collectives: a mesh changes where the work runs, not what is
computed.  Here a mesh is a process group with one process (rank) per
member, and the step places its collectives by hand so that an n-rank step
computes the same function as the one-process step from the same seed
(`runner/runner.py`):

- every rank draws the global batch from the same seeded generator and
  marches its contiguous slice of the rays (``shard_rays``);
- the march outputs are gathered to every rank (``replicated``), so that
  compaction caps the global batch, identically on every rank;
- each rank runs the model on its slice of the rows, and ``gather_rows``
  gathers the raw outputs; its backward returns this rank's slice of the
  incoming gradient, since every rank computes the same whole loss;
- one all-reduce sums the parameter gradients (``all_reduce_grads``), and
  Adam, ExpDecay and EMA then run identically on every rank.

A plain DistributedDataParallel over per-rank batches computes another
function: each rank would draw its own pixels, cap its own samples and
average the gradients.

The gathers are built on ``all_reduce`` (each rank writes its slice into a
zero-filled buffer and the buffers are summed; adding zeros is exact, but
for the sign of a zero) and ``broadcast``, the two collectives that gloo
runs on CUDA tensors as NCCL does.  Slices are contiguous and balanced:
rank r of n holds rows [r*R//n, (r+1)*R//n), so R need not divide by n.
Never shard the per-ray sample axis: samples along a ray are one
compositing chain.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Mesh:
    """A 1-D data-parallel mesh: a process group (None: the default
    group), this process's rank in it, its size and the device that holds
    this rank's tensors."""

    group: object
    rank: int
    size: int
    device: torch.device


def make_mesh(n_devices=None, group=None, device=None) -> Mesh:
    """The mesh over an initialized process group (the default group
    unless given); ``n_devices``, if given, must be its size.  ``device``
    defaults to the current CUDA device; without CUDA it raises unless
    given ``device="cpu"``, so that a rank never falls back to the CPU in
    place of a missing card."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: torch.distributed is not initialized")
    size = dist.get_world_size(group)
    if n_devices is not None and n_devices != size:
        raise ValueError(f"make_mesh({n_devices}): the process group has "
                         f"{size} ranks")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: CUDA is not available (pass "
                               "device='cpu' to run the ranks on the CPU)")
        device = torch.device("cuda", torch.cuda.current_device())
    return Mesh(group, dist.get_rank(group), size, torch.device(device))


def shard_bounds(n: int, mesh: Mesh):
    """Rows [lo, hi) of a global [n, ...] tensor that ``mesh.rank`` holds."""
    return n * mesh.rank // mesh.size, n * (mesh.rank + 1) // mesh.size


def shard_rays(x, mesh: Mesh | None):
    """This rank's contiguous slice of a global [R, ...] tensor (``x``
    itself without a mesh)."""
    if mesh is None:
        return x
    lo, hi = shard_bounds(x.shape[0], mesh)
    return x[lo:hi]


def replicated(x, mesh: Mesh | None, n: int | None = None):
    """The global [n, ...] tensor whose slice ``x`` this rank holds,
    gathered on every rank (``x`` itself without a mesh).  ``n`` is
    found with one more all-reduce when not given."""
    if mesh is None:
        return x
    if n is None:
        count = torch.tensor(x.shape[0], dtype=torch.int64, device=x.device)
        dist.all_reduce(count, group=mesh.group)
        n = int(count)
    lo, hi = shard_bounds(n, mesh)
    if x.shape[0] != hi - lo:
        raise ValueError(f"rank {mesh.rank} of {mesh.size} holds "
                         f"{x.shape[0]} rows of {n}, not {hi - lo}")
    wire = torch.uint8 if x.dtype == torch.bool else x.dtype
    buf = torch.zeros((n, *x.shape[1:]), dtype=wire, device=x.device)
    buf[lo:hi] = x
    dist.all_reduce(buf, group=mesh.group)
    return buf.to(x.dtype)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, n):
        ctx.bounds = shard_bounds(n, mesh)
        return replicated(x, mesh, n)

    @staticmethod
    def backward(ctx, grad):
        # Every rank computes the same whole loss from the gathered rows,
        # so this rank's rows get its slice of the gradient as it is; a
        # sum over ranks (an all_gather's reduce-scatter) would be n times
        # too large.
        lo, hi = ctx.bounds
        return grad[lo:hi], None, None


def gather_rows(x, mesh: Mesh | None, n: int):
    """``replicated`` through autograd: the global [n, ...] rows on every
    rank, whose backward hands this rank the gradient of its own rows."""
    if mesh is None:
        return x
    return _GatherRows.apply(x, mesh, n)


def replicate_tree(tensors, mesh: Mesh | None):
    """Broadcast each tensor from the mesh's rank 0, in place; returns
    ``tensors``."""
    if mesh is None:
        return tensors
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t.view(torch.uint8) if t.dtype == torch.bool else t,
                           group=mesh.group, group_src=0)
    return tensors


def all_reduce_grads(params, mesh: Mesh | None):
    """Sum the parameters' gradients over the mesh in one all-reduce (a
    parameter without a gradient counts as zeros)."""
    if mesh is None:
        return
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=mesh.group)
    for p, g in zip(params, flat.split([g.numel() for g in grads])):
        p.grad = g.view_as(p)


def check_same(mesh: Mesh | None, what: str, **values):
    """Raise unless every rank holds the same integer ``values``: one
    all-reduce by MIN of the values and their negatives, which gives each
    value's minimum and maximum over the ranks."""
    if mesh is None:
        return
    names = list(values)
    v = torch.tensor([values[k] for k in names] + [-values[k] for k in names],
                     dtype=torch.int64, device=mesh.device)
    dist.all_reduce(v, op=dist.ReduceOp.MIN, group=mesh.group)
    lo = dict(zip(names, v[:len(names)].tolist()))
    hi = dict(zip(names, (-v[len(names):]).tolist()))
    if lo != hi:
        raise RuntimeError(f"the ranks disagree on {what}: rank {mesh.rank} "
                           f"holds {values}; the smallest are {lo}, the "
                           f"largest {hi}")

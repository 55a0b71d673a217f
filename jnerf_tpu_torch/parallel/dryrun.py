"""Multi-rank dry run of the NGP trainer: the counterpart of
`__graft_entry__.py::dryrun_multichip`.

    python -m jnerf_tpu_torch.parallel.dryrun --ranks 2 [--device cpu]

``dryrun_multichip(n)`` spawns n ranks (`torch.multiprocessing`, start
method ``spawn``: CUDA cannot fork once initialized) that meet through a
``FileStore`` in a temporary directory, so that concurrent runs never
contend for a port, and whose collectives time out rather than hang.  The
backend is NCCL when every rank has a card of its own, gloo when ranks
share a card (NCCL refuses two ranks on one device), and gloo on the CPU
with ``device="cpu"``.  No rank moves to the CPU unasked.

Each rank checks the collectives on its device (``check_collectives``),
then runs the JAX dry run's two runs under the mesh:

- at the flagship shapes (16 levels of 2^19 entries, a 128^3 grid, 4096
  rays, 2^18 target samples, compacted, march budget x2), a grid refresh
  at step 300 and one training step (``step_case``), then a few more
  steps, timed; once in the config's bf16, as the JAX dry run, and once
  in f32.  In bf16 each rank's weight gradients of the MLPs are rounded
  to bf16 before the all-reduce sums them (the rounding of the JAX
  package's transposed dot, `models/networks/mlp.py`), where one process
  rounds the whole sum once, so only the f32 step is the one-process
  step's function to summation order; the JAX package's own mesh test
  runs f32 for the same reason (`tests/test_parallel.py:29`);
- at tiny shapes with ``update_den_freq=4``, a two-window ``train_range``
  across the lagged batch adaptation (``windows_case``).

Each rank returns its results (losses, gradients, grid, model rows and
kernel launches) to the parent, which checks that the ranks agree; a rank
that raises makes the parent raise.  The workers live in this package so
that spawned ranks import nothing but torch and the port.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time
from datetime import timedelta

import torch
import torch.distributed as dist

from jnerf_tpu_torch.parallel import (
    gather_rows,
    make_mesh,
    replicate_tree,
    replicated,
    shard_rays,
)

# ngp_synthetic_cfg arguments of the JAX dry run's two runs
# (`__graft_entry__.py:67-77, 110-114`).
FLAGSHIP = dict(n_images=2, H=64, W=64, n_rays_per_batch=4096,
                target_batch_size=1 << 18, grid_size=128, nerf_steps=1024,
                hash_levels=16, log2_hashmap_size=19)
TINY = dict(n_images=2, H=32, W=32, n_rays_per_batch=256,
            target_batch_size=1 << 12, grid_size=32, nerf_steps=128,
            hash_levels=4, log2_hashmap_size=12)
COMPACTED = {"compacted_batch": True, "march_budget_factor": 2}


def flagship_spec(fp16=True):
    """The flagship run: a refresh at step 300 (the steady-state refresh),
    one step, then 8 more for the rate.  ``fp16=False`` computes in f32
    end to end (see ``dryrun_multichip``)."""
    return {"cfg": dict(FLAGSHIP, fp16=fp16), "set": COMPACTED,
            "refresh_step": 300, "timed_steps": 8}


def windows_spec():
    """The two-window run across the lagged batch adaptation."""
    return {"cfg": TINY, "set": {**COMPACTED, "sampler.update_den_freq": 4},
            "steps": 8}


# ------------------------------------------------------------------ ranks
def choose_backend(n_ranks: int, device: str) -> str:
    """NCCL when each of ``n_ranks`` CUDA ranks has a card of its own, gloo
    when they share cards or run on the CPU."""
    if device == "cpu":
        return "gloo"
    if device != "cuda":
        raise ValueError(f"device={device!r}: 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError("dry run on 'cuda': CUDA is not available")
    return "nccl" if torch.cuda.device_count() >= n_ranks else "gloo"


def run_ranks(n_ranks: int, cases, device="cuda", timeout_s=300.0):
    """Run ``cases``, a list of (function, spec), on ``n_ranks`` spawned
    ranks; each rank calls ``function(mesh, device, spec)`` in turn.
    Returns, for each rank, the list of the cases' results."""
    backend = choose_backend(n_ranks, device)
    with tempfile.TemporaryDirectory(prefix="jnerf_ranks_") as tmp:
        torch.multiprocessing.start_processes(
            _rank_main, args=(n_ranks, backend, device, tmp, cases, timeout_s),
            nprocs=n_ranks, join=True, start_method="spawn")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(n_ranks)]


def _rank_main(rank, world, backend, device, tmp, cases, timeout_s):
    if device == "cpu":
        dev = torch.device("cpu")
        # The ranks share the host's cores; more threads than cores make
        # each rank's thread pool spin against the others'.
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    else:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    store = dist.FileStore(os.path.join(tmp, "store"), world)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world,
                            timeout=timedelta(seconds=timeout_s))
    try:
        mesh = make_mesh(world, device=dev)
        out = [fn(mesh, dev, spec) for fn, spec in cases]
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------------ cases
def check_collectives(mesh, device, spec=None):
    """The mesh's collectives on this rank's device, on 7 rows (uneven
    for 2 ranks): the gather of float and bool slices with and without the
    row count, the gather's backward, a broadcast of float and bool
    tensors and ``sync``.  Raises if any is wrong; returns what it saw."""
    from jnerf_tpu_torch.utils.general import sync

    n = 7
    x = torch.arange(2 * n, dtype=torch.float32, device=device).reshape(n, 2)
    mask = x[:, 0] > 5
    w = torch.linspace(-1.0, 1.0, 2 * n, device=device).reshape(n, 2)
    xl = shard_rays(x, mesh).clone().requires_grad_()
    (gather_rows(xl, mesh, n) * w).sum().backward()
    floats = torch.full((3,), float(mesh.rank), device=device)
    flags = torch.tensor([mesh.rank == 0, mesh.rank != 0], device=device)
    replicate_tree([floats, flags], mesh)
    one = torch.tensor(float(mesh.rank + 1), device=device)
    out = {
        "gathered": replicated(shard_rays(x, mesh), mesh, n).cpu(),
        "gathered_count_found": replicated(shard_rays(x, mesh), mesh).cpu(),
        "gathered_mask": replicated(shard_rays(mask, mesh), mesh, n).cpu(),
        "grad": xl.grad.cpu(), "grad_expected": shard_rays(w, mesh).cpu(),
        "broadcast": floats.cpu(), "broadcast_flags": flags.cpu(),
        "sum": float(sync(one, "sum", mesh)),
        "mean": float(sync(one, "mean", mesh)),
        "number": sync(3, mesh=mesh),
    }
    k = mesh.size
    ok = (torch.equal(out["gathered"], x.cpu())
          and torch.equal(out["gathered_count_found"], x.cpu())
          and torch.equal(out["gathered_mask"], mask.cpu())
          and torch.equal(out["grad"], out["grad_expected"])
          and torch.equal(out["broadcast"], torch.zeros(3))
          and out["broadcast_flags"].tolist() == [True, False]
          and out["sum"] == k * (k + 1) / 2
          and out["mean"] == (k + 1) / 2 and out["number"] == 3)
    if not ok:
        raise RuntimeError(f"rank {mesh.rank}: the collectives on {device} "
                           f"are wrong: {out}")
    return out


def step_case(mesh, device, spec):
    """A grid refresh at ``spec["refresh_step"]`` and one training step
    of the runner that ``spec`` configures (`make_runner`), under ``mesh``
    (None: one process); then ``spec["timed_steps"]`` more steps, timed.
    Optional draws: ``jitter`` for the refresh and ``draws`` (idx, bg, u)
    for the step, as numpy arrays.  Returns the step's loss, the
    gradients and updated parameters by name, the refreshed grid, the
    rows of every model forward and density query on this rank, the
    kernel launches of the refresh and the step, times and peak memory."""
    runner = make_runner(spec, device, mesh)
    rows = _count_rows(runner.model)
    counters = _launch_counters()
    _reset_peak(device)
    step = spec["refresh_step"]
    jitter = spec.get("jitter")
    _reset(counters)
    t0 = _clock(device)
    runner.cfg.m_training_step = step
    runner.sampler.update_density_grid(
        training_step=step, generator=runner.generator,
        jitter=None if jitter is None else torch.tensor(jitter, device=device))
    refresh_s = _clock(device) - t0
    refresh_launches = _read(counters)
    state = runner.sampler.state
    grid = {k: state[k].cpu() for k in ("density_grid", "bitfield", "mean")}
    draws = {}
    if spec.get("draws") is not None:
        idx, bg, u = (torch.tensor(a, device=device) for a in spec["draws"])
        draws = {"idx": idx.long(), "bg": bg, "u": u}
    _reset(counters)
    t0 = _clock(device)
    loss = float(runner.train_step(**draws))
    step_s = _clock(device) - t0
    step_launches = _read(counters)
    out = {
        "loss": loss,
        "grads": {k: p.grad.cpu() for k, p in runner.model.named_parameters()},
        "params": {k: p.detach().cpu()
                   for k, p in runner.model.named_parameters()},
        "grid": grid, "model_rows": list(rows["model"]),
        "density_rows": list(rows["density"]),
        "launches": {"refresh": refresh_launches, "step": step_launches},
        "refresh_s": refresh_s, "step_s": step_s,
    }
    n = spec.get("timed_steps", 0)
    if n:
        t0 = _clock(device)
        for _ in range(n):
            runner.train_step()
        out["steps_per_s"] = n / (_clock(device) - t0)
    out["peak_mib"] = _peak_mib(device)
    return out


def windows_case(mesh, device, spec):
    """``train_range(0, spec["steps"])`` of the runner that ``spec``
    configures, under ``mesh``; ``spec["n_rays"]``, if given, maps a rank
    to the ray count it starts at (a shape the ranks disagree on must
    make ``train_range`` raise).  Returns the last loss, each window's
    (steps, rays, samples per ray), the rate, whether the lagged batch
    adaptation was armed, and peak memory."""
    runner = make_runner(spec, device, mesh)
    n_rays = (spec.get("n_rays") or {}).get(mesh.rank if mesh else 0)
    if n_rays:
        runner.sampler.n_rays_per_batch = n_rays
        runner.sampler.n_samples_per_ray = runner.sampler._samples_for_rays(
            n_rays)
    _reset_peak(device)
    shapes = []
    t0 = _clock(device)
    loss = runner.train_range(0, spec["steps"],
                              tick=lambda *s: shapes.append(s))
    loss = float(loss)
    secs = _clock(device) - t0
    return {"loss": loss, "shapes": shapes, "steps_per_s": spec["steps"] / secs,
            "adapt_armed": runner._pending_adapt is not None,
            "peak_mib": _peak_mib(device)}


def train_case(mesh, device, spec):
    """``train()`` of the runner that ``spec`` configures, under ``mesh``,
    with a validation render every ``spec["val_freq"]`` steps.  Returns
    what ``train`` returned (the test PSNR; None on ranks other than 0),
    the parameters and the grid state after training."""
    runner = make_runner(spec, device, mesh)
    runner.val_freq = spec["val_freq"]
    psnr = runner.train()
    state = runner.sampler.state
    return {"psnr": psnr,
            "params": {k: p.detach().cpu()
                       for k, p in runner.model.named_parameters()},
            "grid": {k: state[k].cpu()
                     for k in ("density_grid", "bitfield", "mean")}}


def make_runner(spec, device, mesh):
    """A Runner on ``device`` for ``ngp_synthetic_cfg(**spec["cfg"])``
    with ``spec["set"]`` applied (dotted keys reach into sub-configs) and
    ``spec["params"]`` (a JAX params tree), if given, loaded; under a
    mesh, its state is then broadcast from rank 0."""
    from jnerf_tpu_torch.runner import Runner
    from jnerf_tpu_torch.utils.bench_cfg import ngp_synthetic_cfg
    from jnerf_tpu_torch.utils.convert import jax_params_to_state_dict

    cfg = ngp_synthetic_cfg(**spec["cfg"])
    for key, value in spec.get("set", {}).items():
        *path, name = key.split(".")
        node = cfg
        for p in path:
            node = node[p]
        node[name] = value
    runner = Runner(device=device)
    if spec.get("params") is not None:
        runner.model.load_state_dict(jax_params_to_state_dict(spec["params"]))
        if runner.ema is not None:
            runner.ema_state = runner.ema.init(runner.params)
    runner.mesh = mesh
    if mesh is not None:
        state = runner.sampler.state
        replicate_tree(
            list(runner.params)
            + (runner.ema_state["shadow"] if runner.ema is not None else [])
            + [state["density_grid"], state["bitfield"], state["mean"]], mesh)
    return runner


# ----------------------------------------------------------- instruments
def _count_rows(model):
    """Record the rows of every forward and density query of ``model``."""
    rows = {"model": [], "density": []}
    model.register_forward_pre_hook(
        lambda _m, args: rows["model"].append(args[0].shape[0]))
    density = model.density

    def counted(pos):
        rows["density"].append(pos.shape[0])
        return density(pos)

    model.density = counted
    return rows


def _launch_counters():
    from jnerf_tpu_torch.ops import fused_mlp, hash_nbr, hash_xor

    return {"F": hash_nbr.encode_fwd, "B": hash_nbr.grad_table,
            "F xor": hash_xor.encode_xor_fwd, "B xor": hash_xor.grad_table_xor,
            "F-MLP": fused_mlp.fused_mlp_fwd, "B-MLP": fused_mlp.fused_mlp_bwd,
            "D-MLP": fused_mlp.fused_density_mlp}


def _reset(counters):
    for fn in counters.values():
        fn.launches = 0


def _read(counters):
    return {k: fn.launches for k, fn in counters.items()}


def _clock(device):
    """The host clock, after the device's queued work has finished."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def _reset_peak(device):
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def _peak_mib(device):
    if device.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(device) / 2**20


# ------------------------------------------------------------------ entry
def dryrun_multichip(n_devices: int, device="cuda"):
    """Run the dry run on ``n_devices`` ranks (see the module docstring);
    returns each rank's results ({"collectives", "flagship",
    "flagship_f32", "windows"}) after checking that the ranks agree on the
    steps' losses and gradients, on the refreshed grids and on every
    window's shape."""
    backend = choose_backend(n_devices, device)
    print(f"dryrun_multichip({n_devices}): {backend} backend, ranks on "
          f"{device}", flush=True)
    t0 = time.perf_counter()
    names = ("collectives", "flagship", "flagship_f32", "windows")
    ranks = run_ranks(n_devices, [(check_collectives, None),
                                  (step_case, flagship_spec()),
                                  (step_case, flagship_spec(fp16=False)),
                                  (windows_case, windows_spec())],
                      device=device)
    results = [dict(zip(names, r)) for r in ranks]
    first = results[0]
    for r, res in enumerate(results[1:], 1):
        same = res["windows"]["shapes"] == first["windows"]["shapes"] and all(
            res[k]["loss"] == first[k]["loss"]
            and all(torch.equal(res[k]["grads"][p], g)
                    for p, g in first[k]["grads"].items())
            and all(torch.equal(res[k]["grid"][g], v)
                    for g, v in first[k]["grid"].items())
            for k in ("flagship", "flagship_f32"))
        if not same:
            raise RuntimeError(f"dryrun_multichip: rank {r} disagrees with "
                               "rank 0 on a step's loss or gradients, on a "
                               "refreshed grid or on the windows' shapes")
    for k in ("flagship", "flagship_f32"):
        print(f"dryrun_multichip({n_devices}): one sharded train step OK "
              f"({k}), loss={first[k]['loss']:.5f}, model rows per rank "
              f"{[res[k]['model_rows'] for res in results]}", flush=True)
    win = first["windows"]
    print(f"dryrun_multichip({n_devices}): 2-window train_range OK "
          f"({sum(s[0] for s in win['shapes'])} steps, shapes "
          f"{win['shapes']}), loss={win['loss']:.5f}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return results


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--ranks", type=int, default=2)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = parser.parse_args(argv)
    dryrun_multichip(args.ranks, device=args.device)


if __name__ == "__main__":
    main()

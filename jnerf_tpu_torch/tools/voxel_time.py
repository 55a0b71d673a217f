"""Kernel V (the Plenoxels grid gradient, ``ops/voxel_grid.py::corner_grad``)
timed on one training step's inputs of ``chip_smoke.py`` phase 14's grids
(dense 256^3, then sparse 512^3 after the upsample), on the card.

    python3 jnerf_tpu_torch/tools/voxel_time.py --capture INPUTS [--tree DIR]
    python3 jnerf_tpu_torch/tools/voxel_time.py --inputs INPUTS [--tree DIR]

``--capture`` runs phase 14 (``chip_smoke.run_svox2``: ``svox2_base.py``
through the CLI on a 256^2 synthetic scene, 512 dense and 128 sparse
steps), prints its steps/s and peak memory, and keeps one step's kernel V
inputs of each grid in INPUTS (``torch.save``, a few GB: keep it out of
the repository).  ``--inputs`` times kernel V on them: CUDA-event ms over
three runs of 20 launches, the profiler's device ms a launch by CUDA
kernel (`kernel_times`, which ``chip_smoke.py`` groups by stage), the
peak memory above the inputs and a digest of the outputs' bits (equal
digests, equal bits).  ``--tree DIR`` does either with the
checkout at DIR (a ``git archive`` of another commit: its
``jnerf_tpu_torch`` and ``chip_smoke.py``), whose kernels build into DIR's
own ``build/``; run this file as a script for that, so that no other
checkout's package is loaded first.  Without a card it refuses to run.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    what = ap.add_mutually_exclusive_group(required=True)
    what.add_argument("--capture", metavar="INPUTS",
                      help="run phase 14 and keep its kernel V inputs here")
    what.add_argument("--inputs", metavar="INPUTS",
                      help="time kernel V on the inputs kept here")
    ap.add_argument("--tree", default=str(ROOT),
                    help="the checkout whose package and chip_smoke.py run")
    return ap.parse_args(argv)


def capture(torch, chip_smoke, path):
    """Phase 14 of the tree's chip_smoke.py; its kernel V inputs to path."""
    from jnerf_tpu_torch.dataset.synthetic import make_synthetic_scene
    from jnerf_tpu_torch.ops import cuda_lib, fused_mlp, hash_nbr, hash_xor
    from jnerf_tpu_torch.tools import run_net

    chip_smoke.build_kernels(torch, cuda_lib)
    tmp = tempfile.mkdtemp(prefix="voxel_time_")
    scene = os.path.join(tmp, "scene")
    make_synthetic_scene(scene, n_train=24, n_val=2, n_test=4,
                         H=chip_smoke.CLI_HW, W=chip_smoke.CLI_HW,
                         device="cuda")
    counters = chip_smoke.launch_counters(hash_nbr, hash_xor, fused_mlp)
    res = chip_smoke.run_svox2(torch, run_net, counters, scene, tmp)
    print(f"phase 14: dense {res['dense_steps_per_s']:.3f} steps/s, sparse "
          f"{res['sparse_steps_per_s']:.3f} steps/s, the phase's peak "
          f"{res['peak_mib']:.1f} MiB", flush=True)
    torch.save(res["voxel"], path)


def short(name: str) -> str:
    """A CUDA kernel's name from the profiler without its namespace,
    return type and arguments."""
    name = name.replace("(anonymous namespace)::", "").replace("void ", "")
    return name.split("(")[0]


def kernel_times(torch, fn, reps=3):
    """The CUDA kernels of ``reps`` calls of ``fn`` under torch.profiler,
    in the order they ran: (short name, device ms / reps) each.  The
    profiler's device times are approximate: they need not add up to the
    CUDA events' time of a call."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    events = sorted((e for e in prof.events()
                     if e.device_type == cuda and not e.is_user_annotation),
                    key=lambda e: e.time_range.start)
    return [(short(e.name), e.time_range.elapsed_us() / 1e3 / reps)
            for e in events]


def time_inputs(torch, chip_smoke, path):
    """The tree's kernel V on each grid's inputs kept at path."""
    from jnerf_tpu_torch.ops import voxel_grid

    # A tree before the sample path takes no offsets: it gets the corner
    # rows (the base rows plus each offset; the dense grid's are all on
    # the grid).
    takes_offsets = "offsets" in voxel_grid.corner_grad.__code__.co_varnames
    for name, inp in torch.load(path).items():
        idx_c, w_c, g_c, n_rows = inp[:4]
        offs = inp[4] if len(inp) > 4 else None
        if offs and not takes_offsets:
            idx_c, offs = idx_c[:, None] + torch.tensor(offs), None
        idx, w = idx_c.cuda(), w_c.cuda()
        grads = [g.cuda() for g in g_c]
        args = (idx, w, grads, n_rows) + ((offs,) if offs else ())

        def kernel():
            return voxel_grid.corner_grad(*args)

        out = kernel()
        digest = hashlib.sha256(b"".join(
            o.cpu().numpy().tobytes() for o in out)).hexdigest()[:16]
        del out
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        kernel()
        torch.cuda.synchronize()
        extra = (torch.cuda.max_memory_allocated() - base) / 2**20
        ms = [chip_smoke.cuda_ms(kernel, iters=20) for _ in range(3)]
        by = {}
        for k, v in kernel_times(torch, kernel):
            by[k] = by.get(k, 0.0) + v
        top = sorted(by.items(), key=lambda kv: -kv[1])
        print(f"kernel V [{name}] ({'sample' if offs else 'item'} path): "
              f"{[round(x, 4) for x in ms]} ms, device "
              f"{sum(by.values()):.4f} ms a launch (profiler, "
              f"approximate), peak above the inputs {extra:.1f} MiB, "
              f"outputs {digest}; by CUDA kernel: "
              + "; ".join(f"{k} {v:.4f}" for k, v in top), flush=True)
        voxel_grid.corner_grad.launches = 0
        del idx, w, grads, args
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    args = parse_args(argv)
    tree = os.path.abspath(args.tree)
    loaded = sys.modules.get("jnerf_tpu_torch")
    if loaded is not None and not loaded.__file__.startswith(tree + os.sep):
        raise SystemExit(f"--tree {tree}: another checkout's package is "
                         f"loaded; run this file as a script")
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("voxel_time needs an NVIDIA GPU: "
                         "torch.cuda.is_available() is false")
    import chip_smoke

    print(f"{tree}: {chip_smoke.card_line()}", flush=True)
    if args.capture:
        capture(torch, chip_smoke, os.path.abspath(args.capture))
    else:
        time_inputs(torch, chip_smoke, os.path.abspath(args.inputs))
    return 0


if __name__ == "__main__":
    sys.exit(main())

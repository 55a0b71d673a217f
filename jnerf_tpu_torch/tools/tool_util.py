"""What the port's measuring tools share: the device a tool runs on, the
card line, the bench configs' encoder shapes, git revs and the rev guard,
an atomic JSON write and timers that give the host clock and the card's
clock side by side.

``card(device)`` is the card's name and power limit as nvidia-smi gives
them, or "cpu".  Every tool runs on the card and refuses to run without
one unless its caller asks for the CPU (``--cpu``); a CPU run reports no
device time.
"""

from __future__ import annotations

import os
import subprocess
import time
from pathlib import Path

import torch

from jnerf_tpu_torch.tools.mini_profile import _card as card  # noqa: F401

REPO = Path(__file__).resolve().parents[2]
# Where the tools' numbers go; logs/ itself holds the JAX package's TPU runs.
LOG_DIR = REPO / "logs" / "torch"

# Hash-grid shapes of the bench configs: the reference's 16 levels x 2
# features, and 8 x 4 and 4 x 8 with the same 32-wide output.
ENCODERS = {"f4l8": dict(hash_levels=8, hash_features=4),
            "f8l4": dict(hash_levels=4, hash_features=8),
            "f2l16": {}}


def device_for(cpu: bool, tool: str) -> torch.device:
    """The card, or the CPU when asked; never the CPU in place of a
    missing card."""
    if cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(f"{tool}: CUDA is not available (pass --cpu to run "
                           "on the CPU)")
    return torch.device("cuda")


def sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def git_rev(root=REPO):
    """Short git rev of the working tree, or None outside a checkout."""
    try:
        return subprocess.run(
            ["git", "-C", str(root), "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=10,
        ).stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        return None


def rev_mismatch(rev_a: str, rev_b: str, root=REPO) -> bool:
    """Whether two revs hold different code of the port: a diff of
    ``jnerf_tpu_torch`` between them that lists a file, or that fails (an
    unknown rev, no git), counts as a mismatch."""
    try:
        out = subprocess.run(
            ["git", "diff", "--name-only", f"{rev_a}..{rev_b}", "--",
             "jnerf_tpu_torch"],
            capture_output=True, text=True, cwd=root, timeout=10)
    except (OSError, subprocess.SubprocessError):
        return True
    return out.returncode != 0 or bool(out.stdout.strip())


def write_atomic(path, text: str):
    """Write ``text`` to ``path`` through a temporary file and a rename,
    creating the directory."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_text(text)
    os.replace(tmp, path)


def timed(fn, reps: int, device: torch.device):
    """Run ``fn`` ``reps`` times; returns (host ms a rep, device ms a rep).

    The host clock runs from the first call to the end of a synchronize
    after the last; the device time is the span between CUDA events
    recorded before the first launch and after the last (None on the
    CPU), idle gaps included."""
    sync(device)
    start = stop = None
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    if stop is not None:
        stop.record()
    sync(device)
    host = (time.perf_counter() - t0) * 1e3 / reps
    return host, (start.elapsed_time(stop) / reps if start is not None
                  else None)


def host_us(fn, calls: int) -> float:
    """Host µs a call of ``fn`` on the card over ``calls`` calls after 100
    warm-up calls, with no synchronize inside the loop: the launch path's
    own cost while the card keeps up.  The card is synchronized before and
    after, outside the clock."""
    for _ in range(100):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t * 1e6 / calls


def kernel_time(fn, reps: int, device: torch.device):
    """(kernel ms a rep, kernel launches a rep) of ``reps`` runs of ``fn``
    under ``torch.profiler``: the sum of the CUDA kernels' own times, so
    the device's busy share is this over the host time; (None, None) on
    the CPU."""
    if device.type != "cuda":
        return None, None
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    sync(device)
    with torch.profiler.profile(activities=acts, acc_events=True) as prof:
        for _ in range(reps):
            fn()
        sync(device)
    cuda = torch.autograd.DeviceType.CUDA
    # Kernels only: a range annotation also shows on the device's timeline.
    kernels = [e for e in prof.events()
               if e.device_type == cuda and not e.is_user_annotation]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    return busy_ms / reps, len(kernels) / reps

"""Training observability: throughput meters, step timers, profiler traces.

Counterpart of `jnerf_tpu/utils/metrics.py`:

- ``ThroughputMeter`` tracks iters/s, rays/s and samples/s over a sliding
  window of host-clock ticks;
- ``trace`` records a code region with ``torch.profiler`` (CPU and, where
  present, CUDA activity) into a Chrome trace file;
- ``StepTimer`` names phases inside a step loop, synchronizing the card at
  a phase's end when given a CUDA tensor;
- ``get_log`` is a file + console logger.
"""

from __future__ import annotations

import collections
import contextlib
import logging
import os
import time


class ThroughputMeter:
    def __init__(self, window: int = 100):
        self.times = collections.deque(maxlen=window)
        self.rays = collections.deque(maxlen=window)
        self.samples = collections.deque(maxlen=window)
        self._last = None

    def tick(self, n_rays: int = 0, n_samples: int = 0):
        now = time.perf_counter()
        if self._last is not None:
            self.times.append(now - self._last)
            self.rays.append(n_rays)
            self.samples.append(n_samples)
        self._last = now

    @property
    def iters_per_s(self):
        t = sum(self.times)
        return len(self.times) / t if t else 0.0

    @property
    def rays_per_s(self):
        t = sum(self.times)
        return sum(self.rays) / t if t else 0.0

    @property
    def samples_per_s(self):
        t = sum(self.times)
        return sum(self.samples) / t if t else 0.0

    def summary(self) -> str:
        return (f"{self.iters_per_s:.1f} it/s | "
                f"{self.rays_per_s/1e3:.0f} krays/s | "
                f"{self.samples_per_s/1e6:.1f} Msamples/s")


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler trace around a region, written to
    ``<log_dir>/trace.json`` (chrome://tracing or Perfetto)."""
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """Named wall-clock phases; a phase given a CUDA tensor as
    ``sync_value`` waits for the card before it stops its clock."""

    def __init__(self):
        self.totals = collections.defaultdict(float)
        self.counts = collections.defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, sync_value=None):
        t0 = time.perf_counter()
        yield
        if sync_value is not None and getattr(sync_value, "is_cuda", False):
            import torch

            torch.cuda.synchronize(sync_value.device)
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def summary(self) -> str:
        return " | ".join(
            f"{k}: {1e3*v/max(self.counts[k],1):.1f}ms"
            for k, v in sorted(self.totals.items())
        )


def get_log(path: str) -> logging.Logger:
    """File+console logger (parity: mipnerf contrib's get_log)."""
    logger = logging.getLogger(path)
    if not logger.handlers:
        logger.setLevel(logging.INFO)
        fh = logging.FileHandler(path)
        fh.setFormatter(logging.Formatter("%(asctime)s %(message)s"))
        logger.addHandler(fh)
        sh = logging.StreamHandler()
        logger.addHandler(sh)
    return logger

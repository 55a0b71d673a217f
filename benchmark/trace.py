"""The device trace of a traced window: busy time as the union of the
device's operation intervals, time by operation name, and idle gaps named
by what the host was doing.

``traced(fn, device)`` runs ``fn`` under ``torch.profiler`` inside a host
span named ``bench.window`` that starts and ends with a synchronize; the
window is that span.  A device operation counts for the part of its
interval inside the window; overlapping operations count once.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

import torch

WINDOW = "bench.window"
# The longest idle gaps that are named by the host operation under them.
GAPS_NAMED = 200


def union_s(intervals, lo, hi) -> float:
    """Seconds covered by the union of (start, end) intervals [us],
    clipped to [lo, hi]."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total * 1e-6


def gaps(intervals, lo, hi):
    """The idle (start, end) gaps [us] of the union inside [lo, hi]."""
    out, t = [], lo
    for s, e in sorted(intervals):
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [g for g in out if g[1] > g[0]]


class Trace:
    """Device operations (name, start, end) [us], host operations and the
    window [us] of one traced run."""

    def __init__(self, device_ops, host_ops, window):
        self.device_ops = device_ops
        self.host_ops = host_ops
        self.lo, self.hi = window

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) * 1e-6

    @property
    def busy_s(self) -> float:
        return union_s([(s, e) for _, s, e in self.device_ops], self.lo,
                       self.hi)

    def op_seconds(self, match) -> float:
        """Seconds of device operations whose name ``match`` accepts."""
        return sum(min(e, self.hi) - max(s, self.lo)
                   for n, s, e in self.device_ops
                   if match(n) and e > self.lo and s < self.hi) * 1e-6

    def breakdown(self, top=10) -> dict:
        by_name = defaultdict(float)
        for n, s, e in self.device_ops:
            if e > self.lo and s < self.hi:
                by_name[n] += (min(e, self.hi) - max(s, self.lo)) * 1e-6
        idle = defaultdict(float)
        longest = sorted(gaps([(s, e) for _, s, e in self.device_ops],
                              self.lo, self.hi), key=lambda g: g[0] - g[1])
        host = sorted(self.host_ops, key=lambda h: h[1])
        starts = [h[1] for h in host]
        for gs, ge in longest[:GAPS_NAMED]:
            idle[_host_at(host, starts, gs)] += (ge - gs) * 1e-6
        return {"device_ops": _top(by_name, top), "idle_gaps": _top(idle, top)}


def _host_at(host, starts, t) -> str:
    """The innermost (latest started) host operation running at ``t``."""
    for n, s, e in reversed(host[:bisect.bisect_right(starts, t)]):
        if e > t:
            return n
    return "host idle"


def idle_percent(ctx):
    """The per-layer reading of a traced window's idle share, in %."""
    tr = ctx.get("trace")
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def _top(d, k):
    return [[n, v] for n, v in sorted(d.items(), key=lambda x: -x[1])[:k]]


def traced(fn, device) -> tuple:
    """(fn's result, Trace) of ``fn`` run under the profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            _sync(device)
            out = fn()
            _sync(device)
    dev_ops, host_ops, window = [], [], None
    cpu = torch.autograd.DeviceType.CPU
    for e in prof.events():
        tr = e.time_range
        if e.name == WINDOW and e.device_type == cpu:
            window = (tr.start, tr.end)
        elif e.device_type == cpu:
            host_ops.append((e.name, tr.start, tr.end))
        elif not e.is_user_annotation:
            dev_ops.append((e.name, tr.start, tr.end))
    if window is None:
        raise RuntimeError("the profiler recorded no window span")
    return out, Trace(dev_ops, host_ops, window)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)

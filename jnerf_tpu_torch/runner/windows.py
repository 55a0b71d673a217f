"""CUDA graph windows, shared by the NGP, NeuS, Mip-NeRF and Plenoxels
runners.

The JAX runners chain a window of training steps in one jitted
``lax.scan`` and dispatch it once.  Here, on a CUDA runner without a mesh
(`graph_windows`), a window of ``n`` steps is the replay of one CUDA graph
that holds its steps unrolled (`GraphWindows`): the first window of a key
runs eagerly on the capture stream, as the warm-up that capture needs; the
next one is captured, and every window from it on replays its graph.  All
graphs of a runner share one memory pool and one capture stream.

A step reads what changes from step to step from device memory: a row of
a table of per-step scalars (learning rates, bias corrections, anneal
ratios, image indices), computed on the host and copied in with one copy a
window (`host_to_device`), and, where a runner stages its batches, a row
of one static input holding the window's batches.  The eager path reads
the same rows.  The runner's generator is registered with each graph, so a
replay advances it as the eager steps would; a graph window and an eager
window from one seed end in the same bits.  The kernel wrappers' launch
counters (`COUNTED_WRAPPERS`) and the runner's host step counts are bumped
on the host, so a capture puts them back as they were (nothing ran) and
each replay adds the capture's counts.  A capture that fails raises.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from jnerf_tpu_torch.ops import fused_mlp, hash_nbr, hash_xor, voxel_grid

# The kernel wrappers that count their launches (``fn.launches``), by module.
COUNTED_WRAPPERS = (
    (hash_nbr, ("encode_fwd", "grad_table")),
    (hash_xor, ("encode_xor_fwd", "grad_table_xor")),
    (fused_mlp, ("fused_mlp_fwd", "fused_mlp_bwd", "fused_density_mlp")),
    (voxel_grid, ("corner_grad",)),
)

# The longest window of the NeuS, Mip-NeRF and Plenoxels runners (their
# JAX runners' ``_WINDOW``).
WINDOW = 16


def graph_windows(device: torch.device, mesh=None) -> bool:
    """Whether a runner replays its windows as CUDA graphs: on a CUDA
    device without a mesh (gloo's collectives cannot be captured)."""
    return torch.device(device).type == "cuda" and mesh is None


def window_length(step: int, end: int, freqs=(), longest: int = WINDOW) -> int:
    """Steps in the window that starts at ``step``: at most ``longest``,
    cut at ``end`` and at the next multiple of each of ``freqs``, the JAX
    runners' rule."""
    n = min(longest, end - step)
    for f in freqs:
        n = min(n, f - step % f)
    return max(1, n)


def host_to_device(x, device, out=None) -> torch.Tensor:
    """A host array (numpy or tensor) on ``device`` in one copy that does
    not wait (from pinned memory on a card), into ``out`` if given."""
    host = torch.from_numpy(np.ascontiguousarray(x)) \
        if isinstance(x, np.ndarray) else x
    if torch.device(device).type == "cuda":
        host = host.pin_memory()
    if out is None:
        return host.to(device, non_blocking=True)
    return out.copy_(host, non_blocking=True)


def counted_wrappers():
    return [getattr(mod, name) for mod, names in COUNTED_WRAPPERS
            for name in names]


def _get(holder, key):
    return holder[key] if isinstance(holder, dict) else getattr(holder, key)


def _set(holder, key, value):
    if isinstance(holder, dict):
        holder[key] = value
    else:
        setattr(holder, key, value)


class _Window(NamedTuple):
    """A captured window: the graph, its static table and input, the
    output it writes, and each counted wrapper's launches in one replay."""

    graph: object
    table: torch.Tensor
    inputs: torch.Tensor | None
    out: torch.Tensor
    launches: list


class GraphWindows:
    """A runner's windows.  ``run(key, rows, body, ...)`` runs ``body(table,
    inputs)`` (a window's steps, each reading its row of ``table`` and of
    ``inputs``; it returns one tensor, e.g. the steps' losses) as the
    replay of the key's graph, or eagerly where the key has no graph yet
    (its warm-up); ``eager(rows, body, inputs)`` runs it as a plain loop.
    ``rows`` [n, width] and ``inputs`` [n, ...] are host arrays.
    ``counters``: (holder, key) pairs of host step counts that ``body``
    adds one to a step; ``params``: tensors whose ``.grad`` a capture
    leaves in the graph's pool (reset to None after it); ``prepare()``
    runs before a capture or a replay."""

    def __init__(self, device, generator):
        self.device = torch.device(device)
        self.generator = generator
        self.cache = {}  # key -> _Window
        self.warm = {}  # key -> (shape, dtype) of the warm-up's output
        self._stream = self._pool = None

    def clear(self):
        """Drop every graph (the tensors they read were replaced)."""
        self.cache.clear()
        self.warm.clear()

    def eager(self, rows, body, inputs=None):
        return body(host_to_device(rows, self.device),
                    None if inputs is None
                    else host_to_device(inputs, self.device))

    def run(self, key, rows, body, inputs=None, counters=(), params=(),
            prepare=None):
        win = self.cache.get(key)
        if win is None and key not in self.warm:
            stream = self.capture_stream()
            current = torch.cuda.current_stream(self.device)
            stream.wait_stream(current)
            with torch.cuda.stream(stream):
                out = self.eager(rows, body, inputs)
            current.wait_stream(stream)
            self.warm[key] = (out.shape, out.dtype)
            return out
        if prepare is not None:
            prepare()
        if win is None:
            win = self.cache[key] = self._capture(key, rows, body, inputs,
                                                  counters, params)
        host_to_device(rows, self.device, out=win.table)
        if inputs is not None:
            host_to_device(inputs, self.device, out=win.inputs)
        win.graph.replay()
        n = len(rows)
        for holder, k in counters:
            _set(holder, k, _get(holder, k) + n)
        for fn, d in win.launches:
            fn.launches += d
        return win.out

    def capture_stream(self):
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
            self._pool = torch.cuda.graph_pool_handle()
        return self._stream

    def _capture(self, key, rows, body, inputs, counters, params) -> _Window:
        """Capture ``body`` over a static table and input into one graph;
        the host's step counts and launch counters are put back as they
        were, since nothing ran."""
        table = host_to_device(rows, self.device)
        static_in = (None if inputs is None
                     else host_to_device(inputs, self.device))
        shape, dtype = self.warm[key]
        out = torch.empty(shape, dtype=dtype, device=self.device)
        wrappers = counted_wrappers()
        before = [fn.launches for fn in wrappers]
        saved = [_get(holder, k) for holder, k in counters]
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.generator)
        try:
            with torch.cuda.graph(graph, pool=self._pool,
                                  stream=self.capture_stream()):
                out.copy_(body(table, static_in))
            launches = [(fn, fn.launches - b)
                        for fn, b in zip(wrappers, before)]
        finally:
            for fn, b in zip(wrappers, before):
                fn.launches = b
            for (holder, k), v in zip(counters, saved):
                _set(holder, k, v)
        # The gradients live in the graph's pool; replays do not set them.
        for p in params:
            p.grad = None
        return _Window(graph, table, static_in, out, launches)

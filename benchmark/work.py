"""The yardstick's peaks, operation and byte counts, and the card line.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, at its
700 W limit).  The hash kernels' counts are those the program's smoke test
states for kernels F and B: kernel F reads the positions, each table row
its launch needs once, and writes the encoding (bfloat16); kernel B reads
the positions and the float32 upstream gradient and writes the whole
table gradient.  The bound of a launch is the larger of its bytes over
the memory rate and its operations over the float32 rate.
"""

from __future__ import annotations

import subprocess

import torch

HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12


def bound_s(nbytes: float, flops: float, flop_rate: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / flop_rate)


def _hash_flops(n, n_levels, n_features):
    # A (sample, level): 8 f32 operations an axis for the cell and its
    # corner factors; a corner: 2 multiplies for its weight, then a
    # multiply and an add a feature.
    return n * n_levels * (24 + 8 * (2 + 2 * n_features))


def hash_fwd_bound_s(n, n_levels, n_features, rows_read, out_bytes=2):
    nbytes = (12 * n + 4 * n_features * rows_read
              + out_bytes * n_features * n_levels * n)
    return bound_s(nbytes, _hash_flops(n, n_levels, n_features),
                   F32_FLOP_PER_S)


def hash_bwd_bound_s(n, n_levels, n_features, n_entries):
    nbytes = 12 * n + 4 * n_features * n_levels * n + 4 * n_features * n_entries
    return bound_s(nbytes, _hash_flops(n, n_levels, n_features),
                   F32_FLOP_PER_S)


def rows_read(grid, pos) -> int:
    """Distinct table rows the corners of ``pos`` [N, 3] touch, summed
    over the levels of the reference's ``HashGrid``."""
    total = 0
    for scale, size, offset, mult in grid.levels:
        g = torch.floor(pos * scale + 0.5).long()
        ent = []
        for c in range(8):
            h = sum(((g[:, d] + ((c >> d) & 1)) * mult[d]) & 0xFFFFFFFF
                    for d in range(3)) & 0xFFFFFFFF
            ent.append(h % size)
        total += int(torch.unique(torch.cat(ent)).numel())
    return total


def card(device) -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    if torch.device(device).type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return torch.cuda.get_device_name(0)

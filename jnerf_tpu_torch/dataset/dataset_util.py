"""Dataset helper math: the NGP scale constant and fov/focal conversion.

Copied from `jnerf_tpu/dataset/dataset_util.py` (importing that module
would import the JAX package).  Image IO is not ported yet.
"""

from __future__ import annotations

import math

# Poses are scaled by this factor (and offset by 0.5) into NGP's unit cube.
NERF_SCALE = 0.33


def fov_to_focal_length(resolution: int, degrees: float) -> float:
    return 0.5 * resolution / math.tan(0.5 * math.radians(degrees))


"""The port's host-side C++ cores, loaded with ctypes: marching
tetrahedra (the counterpart of `jnerf_tpu/native.py`), the JPEG codec
(`dataset/jpeg.py`) and the MPEG-4 video encoder (`utils/mp4.py`).

Each ``csrc/<name>.cpp`` builds with ``g++ -O3 -shared -fPIC`` at first
use into ``build/jnerf_tpu_torch/`` under the checkout (git-ignored),
named by a hash of the source and the flags, as `ops/cuda_lib.py` builds
the CUDA kernels: an edited source rebuilds and an unchanged one loads at
once.  A missing compiler or a failed build raises; there is no fallback
(callers that want the numpy marching path ask for it with
``use_native=False``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

import numpy as np

from jnerf_tpu_torch.ops.cuda_lib import BUILD_DIR, CSRC_DIR

# No contraction into FMAs: the numpy path rounds every product.
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off")


def build(name: str = "marching_tets") -> str:
    """Compile ``csrc/<name>.cpp`` unless a library of the same source and
    flags exists; returns the library path."""
    src = CSRC_DIR / f"{name}.cpp"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{name}_{digest}.so"
    if lib.exists():
        return str(lib)
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"g++ not found: the {name} core cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp.so")
    proc = subprocess.run([gxx, *GXX_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {src}:\n{proc.stderr[-4000:]}")
    os.replace(tmp, lib)  # atomic against a concurrent build
    return str(lib)


@functools.lru_cache(maxsize=None)
def marching_lib() -> ctypes.CDLL:
    """The built core, loaded once."""
    lib = ctypes.CDLL(build())
    lib.marching_tets.restype = ctypes.c_int64
    lib.marching_tets.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
    ]
    lib.mt_free.restype = None
    lib.mt_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
    return lib


def weld(soup: np.ndarray):
    """Triangle soup [3T, 3] -> (vertices [V, 3], triangles [T', 3] int64):
    vertices equal after rounding to 1e-5 become one, and triangles that
    welding made degenerate are dropped.  The JAX package's result (its
    ``np.unique`` of the rounded keys, vertices in key order, each the
    first of its duplicates), from a stable lexicographic sort of the keys,
    which takes a third of ``np.unique``'s time on structured rows."""
    key = np.round(soup * 1e5).astype(np.int64)
    order = np.lexsort((key[:, 2], key[:, 1], key[:, 0]))
    sorted_key = key[order]
    first = np.empty(len(key), bool)
    first[:1] = True
    first[1:] = (sorted_key[1:] != sorted_key[:-1]).any(axis=1)
    inv = np.empty(len(key), np.int64)
    inv[order] = np.cumsum(first) - 1
    vertices = soup[order[first]]
    triangles = inv.reshape(-1, 3)
    ok = ((triangles[:, 0] != triangles[:, 1])
          & (triangles[:, 1] != triangles[:, 2])
          & (triangles[:, 0] != triangles[:, 2]))
    return vertices, triangles[ok]


def marching_tets_native(field: np.ndarray, threshold: float = 0.0):
    """C++ marching tetrahedra of an [X, Y, Z] field -> (vertices [V, 3]
    in grid-index coordinates, triangles [T, 3])."""
    lib = marching_lib()
    field = np.ascontiguousarray(field, np.float32)
    if field.ndim != 3:
        raise ValueError(f"field must be [X, Y, Z], got {field.shape}")
    out_ptr = ctypes.POINTER(ctypes.c_float)()
    n_tris = lib.marching_tets(
        field.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        field.shape[0], field.shape[1], field.shape[2],
        ctypes.c_float(threshold), ctypes.byref(out_ptr),
    )
    try:
        if n_tris == 0:
            return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)
        soup = np.ctypeslib.as_array(out_ptr,
                                     shape=(int(n_tris) * 3, 3)).copy()
    finally:
        lib.mt_free(out_ptr)
    return weld(soup)

"""Build and load the port's CUDA kernels (`jnerf_tpu_torch/csrc/*.cu`:
``hash_encode`` and ``fused_mlp``).

Each source compiles with ``nvcc`` into a shared library with a plain C
interface, loaded with ctypes: no PyTorch headers, so a build takes
seconds.  Libraries go to ``build/jnerf_tpu_torch/`` under the checkout,
named by a hash of the source and flags, so an edited source rebuilds and
an unchanged one loads at once.  A missing ``nvcc`` or a failed build
raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "jnerf_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    """nvcc from PATH, else from the CUDA toolkit at $CUDA_HOME."""
    path = shutil.which("nvcc")
    if path is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        if os.path.exists(os.path.join(home, "bin", "nvcc")):
            path = os.path.join(home, "bin", "nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a library of the same source and
    flags exists; returns the library path.  The compiler's report
    (``-Xptxas -v``: registers, spills) is kept beside it as ``.log``."""
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{name}_{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp.so")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
        capture_output=True, text=True,
    )
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr[-4000:]}")
    os.replace(tmp, lib)  # atomic against a concurrent build
    return lib


_P = ctypes.c_void_p
_I = ctypes.c_int
# hash_encode_fwd(pos, table, out, e0_out, n, L, F, out_bf16, scales, mults,
#                 sizes, masks, offsets, corner_offs, stream)
_HASH_FWD_ARGS = [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P]
# hash_encode_bwd(pos, g, grad, n, L, F, scales, mults, sizes, masks,
#                 offsets, corner_offs, stream)
_HASH_BWD_ARGS = [_P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P]


@functools.lru_cache(maxsize=None)
def hash_encode_lib() -> ctypes.CDLL:
    """The hash-encode kernels, built at first use."""
    lib = ctypes.CDLL(str(build("hash_encode")))
    lib.hash_encode_fwd.argtypes = _HASH_FWD_ARGS
    lib.hash_encode_fwd.restype = ctypes.c_int
    lib.hash_encode_bwd.argtypes = _HASH_BWD_ARGS
    lib.hash_encode_bwd.restype = ctypes.c_int
    return lib


# fused_mlp_fwd(x, d, w0, w1, v0, v1, v2, out, n, stream)
_MLP_FWD_ARGS = [_P] * 8 + [_I, _P]
# fused_mlp_bwd(x, d, w0, w1, v0, v1, v2, g, dx, partial, dw, n, n_blocks,
#               stream)
_MLP_BWD_ARGS = [_P] * 11 + [_I, _I, _P]
# fused_density_mlp_fwd(x, w0, w1, out, n, stream)
_DENSITY_FWD_ARGS = [_P] * 4 + [_I, _P]


@functools.lru_cache(maxsize=None)
def fused_mlp_lib() -> ctypes.CDLL:
    """The fused NGP MLP kernels, built at first use."""
    lib = ctypes.CDLL(str(build("fused_mlp")))
    for fn, args in ((lib.fused_mlp_fwd, _MLP_FWD_ARGS),
                     (lib.fused_mlp_bwd, _MLP_BWD_ARGS),
                     (lib.fused_density_mlp_fwd, _DENSITY_FWD_ARGS),
                     (lib.fused_mlp_bwd_blocks, [_I])):
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return lib


def check(status: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launch."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status}")

"""Build and load the port's CUDA kernels (`jnerf_tpu_torch/csrc/*.cu`:
``hash_encode``, ``fused_mlp`` and ``envelope``).

Each source compiles with ``nvcc`` into a shared library with a plain C
interface, loaded with ctypes: no PyTorch headers, so a build takes
seconds.  Libraries go to ``build/jnerf_tpu_torch/`` under the checkout,
named by a hash of the source, the headers it may include
(``csrc/*.cuh``), the flags and a prelude of definitions,
so an edited source rebuilds and an unchanged one loads at once.  The
hash kernels' prelude defines the xor mode's hash (the config's
``hash_func``): each distinct string builds its own library once, and the
default string gives the same library on every run.  A missing ``nvcc``
or a failed build raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from .hash_grid import DEFAULT_HASH_FUNC, _compile_hash_func

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


def build(name: str, prelude: str = "") -> Path:
    """Compile ``csrc/<name>.cu`` unless a library of the same source,
    flags and ``prelude`` exists; returns the library path.  A prelude
    (definitions the source reads) goes into a file under the build
    directory that includes the source.  The compiler's report
    (``-Xptxas -v``: registers, spills) is kept beside it as ``.log``."""
    src = CSRC_DIR / f"{name}.cu"
    headers = b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(
        src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()
        + prelude.encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{name}_{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp.so")
    unit = src
    if prelude:
        unit = BUILD_DIR / f"{name}_{digest}.{os.getpid()}.cu"
        unit.write_text(f'{prelude}\n#include "{src}"\n')
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(unit)],
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
# hash_encode_bwd(pos, g, grad, work, n, L, F, scales, mults, sizes, masks,
#                 offsets, corner_offs, plan_only, stream)
_HASH_BWD_ARGS = [_P] * 4 + [_I] * 3 + [_P] * 6 + [_I, _P]
# hash_encode_xor_fwd(pos, table, out, n, L, F, bf16, scales, mults, sizes,
#                     offsets, hashed, stream)
_HASH_XOR_ARGS = [_P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P]
# hash_encode_xor_bwd(pos, g, grad, work, n, L, F, bf16, scales, mults,
#                     sizes, offsets, hashed, plan_only, stream)
_HASH_XOR_BWD_ARGS = [_P] * 4 + [_I] * 4 + [_P] * 5 + [_I, _P]
# hash_encode_bwd_layout(n, L, F, xor_mode, sizes, out[3]) -> int32s
_HASH_BWD_LAYOUT_ARGS = [_I] * 4 + [_P, _P]


def hash_prelude(hash_func: str = DEFAULT_HASH_FUNC) -> str:
    """hash_encode.cu's JNERF_HASH for a ``hash_func`` string (checked,
    and rewritten as C, by `hash_grid._compile_hash_func`)."""
    c_expr = _compile_hash_func(hash_func).c_expr
    return f"#define JNERF_HASH(p0, p1, p2) {c_expr}"


@functools.lru_cache(maxsize=None)
def hash_encode_lib(hash_func: str = DEFAULT_HASH_FUNC) -> ctypes.CDLL:
    """The hash-encode kernels with the xor mode's hash ``hash_func``
    (the linear mode reads no hash), built at first use."""
    lib = ctypes.CDLL(str(build("hash_encode", hash_prelude(hash_func))))
    for fn, args in ((lib.hash_encode_fwd, _HASH_FWD_ARGS),
                     (lib.hash_encode_bwd, _HASH_BWD_ARGS),
                     (lib.hash_encode_xor_fwd, _HASH_XOR_ARGS),
                     (lib.hash_encode_xor_bwd, _HASH_XOR_BWD_ARGS)):
        fn.argtypes = args
        fn.restype = ctypes.c_int
    lib.hash_encode_bwd_layout.argtypes = _HASH_BWD_LAYOUT_ARGS
    lib.hash_encode_bwd_layout.restype = ctypes.c_longlong
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


# env_row_gather(table, idx, w, out, n, chunks, n_rows, mode, stream)
_ROW_GATHER_ARGS = [_P] * 4 + [_I] * 4 + [_P]
# env_elem_gather(src, idx, out, n, mode, w, src_rows, src_w, stream)
_ELEM_GATHER_ARGS = [_P] * 3 + [_I] * 5 + [_P]
# env_row_scatter_add(idx, vals, out, work, n, chunks, n_rows, plan_only,
#                     stream)
_ROW_SCATTER_ARGS = [_P] * 4 + [_I] * 4 + [_P]
# env_row_scatter_layout(n, n_rows, out[3]) -> int32s
_ROW_SCATTER_LAYOUT_ARGS = [_I, _I, _P]
# env_packed_work(n, L, n_rows, n_acc, mode, tile_rows) -> int32s
_PACKED_WORK_ARGS = [_I] * 6
# env_packed_bins(pos, g, rows, slots, scales, work, recA, recB, n, L,
#                 n_rows, n_acc, mode, tile_rows, stream)
_PACKED_BINS_ARGS = [_P] * 8 + [_I] * 6 + [_P]
# env_packed_accumulate(work, recA, recB, out, n, L, n_rows, n_acc, mode,
#                       tile_rows, stream)
_PACKED_ACC_ARGS = [_P] * 4 + [_I] * 6 + [_P]
# env_packed_noscat(pos, g, slots, scales, out, scratch, n, L, n_rows, blk,
#                   stream)
_PACKED_NOSCAT_ARGS = [_P] * 6 + [_I] * 4 + [_P]


@functools.lru_cache(maxsize=None)
def envelope_lib() -> ctypes.CDLL:
    """The envelope kernels K1-K4 (`ops/envelope.py`), built at first
    use."""
    lib = ctypes.CDLL(str(build("envelope")))
    for fn, args in ((lib.env_row_gather, _ROW_GATHER_ARGS),
                     (lib.env_elem_gather, _ELEM_GATHER_ARGS),
                     (lib.env_row_scatter_add, _ROW_SCATTER_ARGS),
                     (lib.env_packed_bins, _PACKED_BINS_ARGS),
                     (lib.env_packed_accumulate, _PACKED_ACC_ARGS),
                     (lib.env_packed_noscat, _PACKED_NOSCAT_ARGS)):
        fn.argtypes = args
        fn.restype = ctypes.c_int
    lib.env_packed_work.argtypes = _PACKED_WORK_ARGS
    lib.env_packed_work.restype = ctypes.c_longlong
    lib.env_row_scatter_layout.argtypes = _ROW_SCATTER_LAYOUT_ARGS
    lib.env_row_scatter_layout.restype = ctypes.c_longlong
    lib.env_packed_chunk.argtypes = []
    lib.env_packed_chunk.restype = ctypes.c_int
    return lib


def check(status: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launch."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status}")


class Launch:
    """A C launch function of a built library, called with the least host
    work: ``Launch(envelope_lib, "env_elem_gather")(device_index, *args)``
    resolves the function once (building the library at the first call),
    appends the device's current stream (``torch.cuda.stream(...)`` is
    followed), makes the device current only when it is not, and raises on
    a nonzero cudaError_t.  The arguments are the function's own but the
    stream."""

    __slots__ = ("lib", "name", "_fn", "_dev", "_stream")

    def __init__(self, lib, name: str):
        self.lib, self.name, self._fn = lib, name, None

    def __call__(self, device: int, *args) -> None:
        fn = self._fn
        if fn is None:
            import torch

            # The current device and the raw handle of its current stream,
            # without torch.cuda's lazy-init check and Stream object: a
            # caller's tensor on the card means CUDA is initialized.
            self._dev = torch._C._cuda_getDevice
            self._stream = torch._C._cuda_getCurrentRawStream
            fn = self._fn = getattr(self.lib(), self.name)
        if device == self._dev():
            status = fn(*args, self._stream(device))
        else:
            import torch

            with torch.cuda.device(device):
                status = fn(*args, self._stream(device))
        if status:
            raise RuntimeError(f"{self.name}: CUDA error {status}")

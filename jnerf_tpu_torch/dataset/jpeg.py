"""JPEG reading and writing through the port's C++ codec
(``csrc/jpeg.cpp``), so that a machine without imageio, PIL or cv2 reads
the real captures and writes JPEG images.

``decode_jpeg`` gives the pixels that libjpeg-turbo gives at its defaults
(the JAX package's reads: imageio through PIL, and ``cv2.imread``), bit for
bit: baseline, extended sequential and progressive Huffman JPEGs, 8-bit,
grey or three components, any integral sampling, restart markers; EXIF
orientation is ignored, as those reads ignore it.  Arithmetic-coded,
lossless, hierarchical, 12-bit and CMYK files raise ``ValueError``.
``encode_jpeg`` writes what PIL writes for ``quality`` (imageio's JPEG
writer): JFIF, 4:2:0, the Annex K tables scaled by quality and the
standard Huffman tables.  The core builds with g++ at first use
(`native.py`); a failed build raises.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from jnerf_tpu_torch import native

_ERR_LEN = 512


@functools.lru_cache(maxsize=None)
def jpeg_lib() -> ctypes.CDLL:
    """The built codec, loaded once."""
    lib = ctypes.CDLL(native.build("jpeg"))
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.jpeg_decode.restype = ctypes.c_int
    lib.jpeg_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(u8p),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.c_char_p, ctypes.c_int,
    ]
    lib.jpeg_encode.restype = ctypes.c_int
    lib.jpeg_encode.argtypes = [
        u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(u8p), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_char_p, ctypes.c_int,
    ]
    lib.jpeg_free.restype = None
    lib.jpeg_free.argtypes = [ctypes.c_void_p]
    return lib


def decode_jpeg(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """JPEG bytes -> uint8 [H, W] (grey) or [H, W, 3] (RGB).  ``name`` (the
    file) goes into the ``ValueError`` of a file the codec refuses."""
    lib = jpeg_lib()
    out = ctypes.POINTER(ctypes.c_uint8)()
    h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = ctypes.create_string_buffer(_ERR_LEN)
    rc = lib.jpeg_decode(data, len(data), ctypes.byref(out), ctypes.byref(h),
                         ctypes.byref(w), ctypes.byref(c), err, _ERR_LEN)
    if rc != 0:
        raise ValueError(f"{name}: {err.value.decode(errors='replace')}")
    try:
        shape = (h.value, w.value) if c.value == 1 else (h.value, w.value, c.value)
        return np.ctypeslib.as_array(out, shape=shape).copy()
    finally:
        lib.jpeg_free(out)


def encode_jpeg(img: np.ndarray, quality: int = 95) -> bytes:
    """uint8 [H, W], [H, W, 1] (grey) or [H, W, 3] (RGB) -> JPEG bytes."""
    px = np.ascontiguousarray(img)
    if px.dtype != np.uint8:
        raise ValueError(f"encode_jpeg takes uint8, got {px.dtype}")
    if px.ndim == 2:
        px = px[:, :, None]
    if px.ndim != 3 or px.shape[2] not in (1, 3):
        raise ValueError(f"encode_jpeg takes grey or RGB, got shape {px.shape}")
    lib = jpeg_lib()
    out = ctypes.POINTER(ctypes.c_uint8)()
    size = ctypes.c_int64()
    err = ctypes.create_string_buffer(_ERR_LEN)
    rc = lib.jpeg_encode(px.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                         px.shape[0], px.shape[1], px.shape[2], int(quality),
                         ctypes.byref(out), ctypes.byref(size), err, _ERR_LEN)
    if rc != 0:
        raise ValueError(err.value.decode(errors="replace"))
    try:
        return ctypes.string_at(out, size.value)
    finally:
        lib.jpeg_free(out)

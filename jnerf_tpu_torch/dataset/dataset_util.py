"""Dataset helper math and image IO.

The helpers are copies of `jnerf_tpu/dataset/dataset_util.py` (importing
that module would import the JAX package).  ``read_image`` and
``write_image`` keep its signatures and semantics, but read and write PNG
with the standard library (zlib, struct) and numpy, and JPEG with the
port's C++ codec (`dataset/jpeg.py`: the same pixels as libjpeg-turbo), so
that a machine without imageio, PIL or cv2 trains and renders.  PNG: 8-bit
grey, grey+alpha, RGB and RGBA, non-interlaced, every filter type; other
PNGs (16-bit, palette, interlaced) raise.  ``.bin`` is raw fp16 RGBA
behind an (h, w) int32 header, as in the JAX package.  Other extensions go
to imageio, imported when such a file is met.
"""

from __future__ import annotations

import math
import os
import struct
import zlib

import numpy as np

from jnerf_tpu_torch.dataset.jpeg import decode_jpeg, encode_jpeg

# Poses are scaled by this factor (and offset by 0.5) into NGP's unit cube.
NERF_SCALE = 0.33

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
# PNG colour type -> channels, for the 8-bit types this codec reads.
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
_PNG_COLOR_TYPE = {c: t for t, c in _PNG_CHANNELS.items()}
_JPEG_EXTS = (".jpg", ".jpeg")


def fov_to_focal_length(resolution: int, degrees: float) -> float:
    return 0.5 * resolution / math.tan(0.5 * math.radians(degrees))


def focal_length_to_fov(resolution: int, focal_length: float) -> float:
    return 2.0 * math.degrees(math.atan(0.5 * resolution / focal_length))


def srgb_to_linear(img):
    limit = 0.04045
    return np.where(img > limit, np.power((img + 0.055) / 1.055, 2.4), img / 12.92)


def linear_to_srgb(img):
    limit = 0.0031308
    return np.where(img > limit, 1.055 * (img ** (1.0 / 2.4)) - 0.055, 12.92 * img)


# -------------------------------------------------------------------- PNG
def _unfilter_rows(ftype, raw, c):
    """Rows whose filters are None, Sub or Up: each row is one numpy op."""
    h, stride = raw.shape
    out = np.empty_like(raw)
    prev = np.zeros(stride, np.uint8)
    for r in range(h):
        f = ftype[r]
        if f == 0:
            out[r] = raw[r]
        elif f == 1:  # Sub: a running sum along the row, per channel
            out[r] = np.cumsum(raw[r].reshape(-1, c), axis=0,
                               dtype=np.uint8).reshape(-1)
        else:  # Up
            out[r] = raw[r] + prev
        prev = out[r]
    return out


def _unfilter_wavefront(ftype, raw, w, c):
    """Any filter type.  Average and Paeth read the decoded pixel to the
    left, so pixel (r, x) waits for (r, x-1), (r-1, x) and (r-1, x-1): all
    pixels on one anti-diagonal r + x = d are independent, and the image
    decodes in h + w - 1 vector steps.  T[d, r + 1] holds pixel (r, d - r);
    row 0 of T and the never-written slots read as the zeros PNG puts
    outside the image."""
    h = raw.shape[0]
    rows, cols = np.indices((h, w))
    px = raw.reshape(h, w, c).astype(np.int16)
    skew_raw = np.zeros((h + w - 1, h, c), np.int16)
    skew_raw[rows + cols, rows] = px
    T = np.zeros((h + w - 1, h + 1, c), np.int16)
    zero = np.zeros((h + 1, c), np.int16)
    for d in range(h + w - 1):
        r0, r1 = max(0, d - w + 1), min(h - 1, d) + 1
        prev1 = T[d - 1] if d >= 1 else zero
        prev2 = T[d - 2] if d >= 2 else zero
        a = prev1[r0 + 1:r1 + 1]  # left
        b = prev1[r0:r1]          # up
        ul = prev2[r0:r1]         # upper left
        f = ftype[r0:r1, None]
        pa, pb, pc = np.abs(b - ul), np.abs(a - ul), np.abs(a + b - 2 * ul)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, ul))
        pred = np.where(f == 1, a, np.where(f == 2, b, np.where(
            f == 3, (a + b) >> 1, np.where(f == 4, paeth, 0))))
        T[d, r0 + 1:r1 + 1] = (skew_raw[d, r0:r1] + pred) & 0xFF
    return T[rows + cols, rows + 1].astype(np.uint8).reshape(h, w * c)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> uint8 [H, W] (grey) or [H, W, C] (C = 2, 3, 4)."""
    if data[:8] != _PNG_SIG:
        raise ValueError("not a PNG file")
    pos, header, idat = 8, None, []
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind!r}: bad CRC")
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _comp, _filt, interlace = header
    if depth != 8 or ctype not in _PNG_CHANNELS or interlace != 0:
        raise ValueError(
            f"unsupported PNG (bit depth {depth}, colour type {ctype}, "
            f"interlace {interlace}): this reader takes 8-bit grey, grey+alpha,"
            " RGB and RGBA, non-interlaced")
    c = _PNG_CHANNELS[ctype]
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if rows.size != h * (w * c + 1):
        raise ValueError("PNG image data has the wrong size")
    rows = rows.reshape(h, w * c + 1)
    ftype, raw = rows[:, 0], rows[:, 1:]
    if ftype.max(initial=0) > 4:
        raise ValueError(f"PNG filter type {int(ftype.max())} is not 0-4")
    if ftype.max(initial=0) <= 2:
        out = _unfilter_rows(ftype, raw, c)
    else:
        out = _unfilter_wavefront(ftype, raw, w, c)
    return out.reshape(h, w) if c == 1 else out.reshape(h, w, c)


def _filter_rows(px: np.ndarray, ftype: int) -> np.ndarray:
    """The filtered bytes of uint8 rows px [H, W, C] under one filter."""
    z = np.zeros_like(px[:1]).astype(np.int16)
    x = px.astype(np.int16)
    a = np.concatenate([np.zeros_like(x[:, :1]), x[:, :-1]], axis=1)
    b = np.concatenate([z, x[:-1]], axis=0)
    ul = np.concatenate([np.zeros_like(b[:, :1]), b[:, :-1]], axis=1)
    if ftype == 0:
        pred = 0
    elif ftype == 1:
        pred = a
    elif ftype == 2:
        pred = b
    elif ftype == 3:
        pred = (a + b) >> 1
    elif ftype == 4:
        pa, pb, pc = np.abs(b - ul), np.abs(a - ul), np.abs(a + b - 2 * ul)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, ul))
    else:
        raise ValueError(f"PNG filter type {ftype} is not 0-4")
    return ((x - pred) & 0xFF).astype(np.uint8)


def encode_png(img: np.ndarray, filter_type: int = 2) -> bytes:
    """uint8 [H, W] or [H, W, C] (C = 1-4) -> PNG bytes, every row under
    ``filter_type`` (Up by default: one vector op)."""
    px = np.asarray(img)
    if px.dtype != np.uint8:
        raise ValueError(f"encode_png takes uint8, got {px.dtype}")
    if px.ndim == 2:
        px = px[:, :, None]
    h, w, c = px.shape
    if c not in _PNG_COLOR_TYPE:
        raise ValueError(f"encode_png takes 1-4 channels, got {c}")
    rows = _filter_rows(px, filter_type).reshape(h, w * c)
    raw = np.concatenate([np.full((h, 1), filter_type, np.uint8), rows], axis=1)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, _PNG_COLOR_TYPE[c], 0, 0, 0)
    return (_PNG_SIG + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + chunk(b"IEND", b""))


# ------------------------------------------------------------ image files
def read_image_u8(path: str) -> np.ndarray:
    """An 8-bit image file as uint8 [H, W] or [H, W, C]: PNG by this
    module's decoder, JPEG by the port's codec, other formats by imageio
    (imported here)."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".png":
        with open(path, "rb") as f:
            return decode_png(f.read())
    if ext in _JPEG_EXTS:
        with open(path, "rb") as f:
            return decode_jpeg(f.read(), path)
    import imageio.v2 as imageio

    return np.asarray(imageio.imread(path))


def read_image(path: str) -> np.ndarray:
    """Read an image to float32 in [0,1], shape [H, W, C].

    ``.bin`` files are raw fp16 RGBA with a (h, w) int32 header, as produced
    by the reference's ``write_image`` (`dataset_util.py:57-87`).
    """
    if os.path.splitext(path)[1] == ".bin":
        with open(path, "rb") as f:
            raw = f.read()
        h, w = struct.unpack("ii", raw[:8])
        return (
            np.frombuffer(raw, dtype=np.float16, count=h * w * 4, offset=8)
            .astype(np.float32)
            .reshape([h, w, 4])
        )
    img = read_image_u8(path).astype(np.float32)
    if img.ndim == 2:
        img = img[:, :, None]
    return img / 255.0


def write_image(path: str, img: np.ndarray, quality: int = 95) -> None:
    """Write a float image in [0, 1] ([H, W] or [H, W, C]): PNG by this
    module's encoder, ``.bin`` as fp16 RGBA, JPEG (``quality``; the first
    three channels, as the JAX package keeps) by the port's codec, other
    formats by imageio (imported here)."""
    img = np.asarray(img)
    ext = os.path.splitext(path)[1].lower()
    if ext == ".bin":
        if img.shape[2] < 4:
            pad = np.ones([img.shape[0], img.shape[1], 4 - img.shape[2]], img.dtype)
            img = np.concatenate([img, pad], axis=-1)
        with open(path, "wb") as f:
            f.write(struct.pack("ii", img.shape[0], img.shape[1]))
            f.write(img.astype(np.float16).tobytes())
        return
    out = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    if ext == ".png":
        with open(path, "wb") as f:
            f.write(encode_png(out))
        return
    if ext in _JPEG_EXTS:
        with open(path, "wb") as f:
            f.write(encode_jpeg(out[..., :3], quality))
        return
    import imageio.v2 as imageio

    imageio.imwrite(path, out)

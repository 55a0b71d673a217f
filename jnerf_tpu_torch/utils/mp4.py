"""An mp4 writer without cv2: MPEG-4 Part 2 video (the ``mp4v`` fourcc
that the JAX package's ``cv2.VideoWriter`` uses) in an ISO BMFF file.

The frames are coded by the port's C++ encoder (``csrc/mpeg4.cpp``, built
with g++ at first use by `native.py`; a failed build raises) as intra-only
VOPs at one fixed quantiser, every AC coefficient a type-3 escape.  The
file holds ``ftyp``, then ``moov`` (``mvhd`` and one video ``trak`` whose
``stsd`` carries an ``mp4v`` entry with the VOS/VO/VOL headers in its
``esds``; ``stts``, ``stss``, ``stsc``, ``stsz``, ``stco``), then ``mdat``
with the frames, as one chunk.  ``write`` takes RGB frames and the file
shows their colours (the JAX render swaps them to BGR for cv2, whose
writer swaps them back).
"""

from __future__ import annotations

import ctypes
import functools
import struct

import numpy as np

from jnerf_tpu_torch import native

# The quantiser of every VOP (1-31).  At 2 the frames of
# tests/test_torch_mp4.py decode nearer their input than cv2's own mp4v
# file of them, in luma by 4-5 dB.
QUANTISER = 2


@functools.lru_cache(maxsize=None)
def mpeg4_lib() -> ctypes.CDLL:
    """The built encoder, loaded once."""
    lib = ctypes.CDLL(native.build("mpeg4"))
    u8pp = ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8))
    lib.mp4v_headers.restype = ctypes.c_int
    lib.mp4v_headers.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                 u8pp, ctypes.POINTER(ctypes.c_int64)]
    lib.mp4v_encode_vop.restype = ctypes.c_int
    lib.mp4v_encode_vop.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int64, ctypes.c_int, u8pp,
        ctypes.POINTER(ctypes.c_int64)]
    lib.mp4v_free.restype = None
    lib.mp4v_free.argtypes = [ctypes.c_void_p]
    return lib


def _take(fn, *args) -> bytes:
    """Call an encoder entry point that returns a malloc'ed buffer."""
    lib = mpeg4_lib()
    out = ctypes.POINTER(ctypes.c_uint8)()
    size = ctypes.c_int64()
    if fn(*args, ctypes.byref(out), ctypes.byref(size)) != 0:
        raise ValueError(f"the MPEG-4 encoder refused {args[-3:]}")
    try:
        return ctypes.string_at(out, size.value)
    finally:
        lib.mp4v_free(out)


def box(kind: bytes, *parts: bytes) -> bytes:
    body = b"".join(parts)
    return struct.pack(">I", 8 + len(body)) + kind + body


def full_box(kind: bytes, version: int, flags: int, *parts: bytes) -> bytes:
    return box(kind, struct.pack(">I", (version << 24) | flags), *parts)


def _descriptor(tag: int, body: bytes) -> bytes:
    """An MPEG-4 systems descriptor, its size in the 4-byte form."""
    n = len(body)
    size = bytes([0x80 | (n >> 21) & 0x7F, 0x80 | (n >> 14) & 0x7F,
                  0x80 | (n >> 7) & 0x7F, n & 0x7F])
    return bytes([tag]) + size + body


_MATRIX = struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)


class Mp4Writer:
    """``Mp4Writer(path, width, height, fps)``: ``write(frame)`` takes a
    uint8 RGB frame [height, width, 3], ``release()`` writes the file."""

    def __init__(self, path: str, width: int, height: int, fps: int = 28):
        self.path, self.w, self.h, self.fps = path, int(width), int(height), \
            int(fps)
        lib = mpeg4_lib()
        self.headers = _take(lib.mp4v_headers, self.w, self.h, self.fps)
        self.samples: list[bytes] = []

    def write(self, frame: np.ndarray) -> None:
        px = np.ascontiguousarray(frame, dtype=np.uint8)
        if px.shape != (self.h, self.w, 3):
            raise ValueError(f"frame {px.shape} is not [{self.h}, {self.w}, 3]")
        lib = mpeg4_lib()
        self.samples.append(_take(
            lib.mp4v_encode_vop, px.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            self.w, self.h, self.fps, len(self.samples), QUANTISER))

    def release(self) -> None:
        head = box(b"ftyp", b"isom", struct.pack(">I", 0x200),
                   b"isom", b"iso2", b"mp41")
        # stco holds a 32-bit offset, so moov's size does not depend on it.
        moov = self._moov(0)
        offset = len(head) + len(moov) + 8
        moov = self._moov(offset)
        with open(self.path, "wb") as f:
            f.write(head)
            f.write(moov)
            f.write(struct.pack(">I", 8 + sum(map(len, self.samples))) + b"mdat")
            for s in self.samples:
                f.write(s)

    def _moov(self, chunk_offset: int) -> bytes:
        n = len(self.samples)
        duration = n  # in 1/fps units, one per frame
        mvhd = full_box(b"mvhd", 0, 0, struct.pack(
            ">IIIIIH10x", 0, 0, self.fps, duration, 0x10000, 0x100),
            _MATRIX, bytes(24), struct.pack(">I", 2))
        tkhd = full_box(b"tkhd", 0, 3, struct.pack(
            ">IIIIIQHHHH", 0, 0, 1, 0, duration, 0, 0, 0, 0, 0),
            _MATRIX, struct.pack(">II", self.w << 16, self.h << 16))
        mdhd = full_box(b"mdhd", 0, 0, struct.pack(
            ">IIIIHH", 0, 0, self.fps, duration, 0x55C4, 0))  # 'und'
        hdlr = full_box(b"hdlr", 0, 0, struct.pack(">I", 0), b"vide",
                        bytes(12), b"VideoHandler\x00")
        vmhd = full_box(b"vmhd", 0, 1, bytes(8))
        dinf = box(b"dinf", full_box(b"dref", 0, 0, struct.pack(">I", 1),
                                     full_box(b"url ", 0, 1)))
        biggest = max(map(len, self.samples), default=0)
        bitrate = int(8 * sum(map(len, self.samples)) * self.fps / max(n, 1))
        esds = full_box(b"esds", 0, 0, _descriptor(0x03, struct.pack(">HB", 1, 0) + (
            _descriptor(0x04, struct.pack(">BB", 0x20, 0x11)
                        + biggest.to_bytes(3, "big")
                        + struct.pack(">II", bitrate, bitrate)
                        + _descriptor(0x05, self.headers))
            + _descriptor(0x06, b"\x02"))))
        name = b"mpeg4 intra"
        mp4v = box(b"mp4v", bytes(6), struct.pack(">H", 1), bytes(16),
                   struct.pack(">HHIIIH", self.w, self.h, 0x480000, 0x480000,
                               0, 1),
                   bytes([len(name)]) + name + bytes(31 - len(name)),
                   struct.pack(">Hh", 0x18, -1), esds)
        stsd = full_box(b"stsd", 0, 0, struct.pack(">I", 1), mp4v)
        stts = full_box(b"stts", 0, 0, struct.pack(">III", 1, n, 1))
        stss = full_box(b"stss", 0, 0, struct.pack(f">I{n}I", n, *range(1, n + 1)))
        stsc = full_box(b"stsc", 0, 0, struct.pack(">IIII", 1, 1, n, 1))
        stsz = full_box(b"stsz", 0, 0, struct.pack(f">II{n}I", 0, n,
                                                   *map(len, self.samples)))
        stco = full_box(b"stco", 0, 0, struct.pack(">II", 1, chunk_offset))
        stbl = box(b"stbl", stsd, stts, stss, stsc, stsz, stco)
        minf = box(b"minf", vmhd, dinf, stbl)
        mdia = box(b"mdia", mdhd, hdlr, minf)
        trak = box(b"trak", tkhd, mdia)
        return box(b"moov", mvhd, trak)


def read_boxes(data: bytes, start: int = 0, end: int | None = None) -> list:
    """A box walk: [(type, body offset, body size)] of the boxes in
    data[start:end] (one level)."""
    end = len(data) if end is None else end
    out, pos = [], start
    while pos + 8 <= end:
        size, kind = struct.unpack(">I4s", data[pos:pos + 8])
        if size < 8 or pos + size > end:
            raise ValueError(f"bad box {kind!r} of size {size} at {pos}")
        out.append((kind.decode("latin-1"), pos + 8, size - 8))
        pos += size
    return out


def describe(path: str) -> dict:
    """A box walk of an mp4 file this writer made: its top-level boxes,
    the video track's sample entry and size, sample count, sync samples,
    timescale and duration, and whether the sample sizes fill mdat."""
    with open(path, "rb") as f:
        data = f.read()
    top = read_boxes(data)

    def child(parent, kind):
        _, off, size = parent
        for box_ in read_boxes(data, off, off + size):
            if box_[0] == kind:
                return box_
        raise ValueError(f"{path}: no {kind} box")

    moov = next(b for b in top if b[0] == "moov")
    mdat = next(b for b in top if b[0] == "mdat")
    mdia = child(child(moov, "trak"), "mdia")
    mdhd = child(mdia, "mdhd")
    timescale, duration = struct.unpack(">II", data[mdhd[1] + 12:mdhd[1] + 20])
    stbl = child(child(mdia, "minf"), "stbl")
    stsd = child(stbl, "stsd")
    entry = read_boxes(data, stsd[1] + 8, stsd[1] + stsd[2])[0]
    width, height = struct.unpack(">HH", data[entry[1] + 24:entry[1] + 28])
    stsz = child(stbl, "stsz")
    _, count = struct.unpack(">II", data[stsz[1] + 4:stsz[1] + 12])
    sizes = struct.unpack(f">{count}I",
                          data[stsz[1] + 12:stsz[1] + 12 + 4 * count])
    stss = child(stbl, "stss")
    (n_sync,) = struct.unpack(">I", data[stss[1] + 4:stss[1] + 8])
    stco = child(stbl, "stco")
    (offset,) = struct.unpack(">I", data[stco[1] + 8:stco[1] + 12])
    return {"boxes": [b[0] for b in top], "entry": entry[0], "width": width,
            "height": height, "samples": count, "sync_samples": n_sync,
            "timescale": timescale, "duration": duration,
            "fps": timescale * count / duration if duration else 0.0,
            "mdat_filled": offset == mdat[1] and sum(sizes) == mdat[2],
            "bytes": len(data)}

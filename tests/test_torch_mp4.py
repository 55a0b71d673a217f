"""The port's mp4 writer (`utils/mp4.py`, `csrc/mpeg4.cpp`) read back by
cv2 here (FFmpeg's MPEG-4 decoder): frame count, size, 28 fps, each frame
near its input and no further from it than cv2's own ``mp4v`` file of the
same frames, RGB order as in the JAX render's file, and the boxes."""

import struct

import cv2
import numpy as np
import pytest

from jnerf_tpu_torch.utils.mp4 import Mp4Writer, describe, read_boxes


def _frames(n, h, w):
    """A moving red disc over smooth colour ramps (render-like content)."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    out = []
    for i in range(n):
        f = np.stack([np.sin(x / 9.0 + i * 0.3 + k) * 90 + 128
                      + np.cos(y / 13.0 - i * 0.2) * 30 for k in range(3)], -1)
        disc = (x - w / 2 - 6 * np.sin(i / 2)) ** 2 + (y - h / 2) ** 2
        f[disc < (min(h, w) / 4) ** 2] = [250, 40, 30]
        out.append(np.clip(f, 0, 255).astype(np.uint8))
    return out


def _read(path):
    """(frames as RGB, frame count, width, height, fps) through cv2."""
    cap = cv2.VideoCapture(path)
    info = (int(cap.get(cv2.CAP_PROP_FRAME_COUNT)),
            int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
            int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)), cap.get(cv2.CAP_PROP_FPS))
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f[..., ::-1])
    cap.release()
    return frames, info


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 10 * np.log10(255.0 ** 2 / mse)


def _luma(frame):
    return cv2.cvtColor(np.ascontiguousarray(frame), cv2.COLOR_RGB2YUV)[..., 0]


def _write(path, frames):
    h, w = frames[0].shape[:2]
    writer = Mp4Writer(str(path), w, h, 28)
    for f in frames:
        writer.write(f)
    writer.release()


def _write_like_the_jax_render(path, frames):
    """The JAX package's Runner.render writer (`jnerf_tpu/runner/runner.py`)."""
    h, w = frames[0].shape[:2]
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 28,
                             (w, h))
    for f in frames:
        writer.write(cv2.cvtColor(f, cv2.COLOR_BGR2RGB))
    writer.release()


@pytest.mark.parametrize("size", [(48, 64), (37, 53), (16, 16), (378, 504)])
def test_cv2_reads_the_writers_file(tmp_path, size):
    """Frame count, the true size (odd sizes too: the VOL states it), 28
    fps, and every frame's luma within 35 dB of its input's; the RGB PSNR,
    which the 4:2:0 chroma of the red disc's edge bounds on small frames,
    at least 20 dB (30 dB at 378 x 504, the LLFF render's size)."""
    h, w = size
    frames = _frames(3 if h > 100 else 6, h, w)
    path = tmp_path / "v.mp4"
    _write(path, frames)
    got, (count, width, height, fps) = _read(str(path))
    assert (count, width, height, fps) == (len(frames), w, h, 28.0)
    assert len(got) == len(frames)
    for a, b in zip(frames, got):
        assert b.shape == a.shape and _psnr(_luma(a), _luma(b)) >= 35.0
        assert _psnr(a, b) >= (30.0 if h > 100 else 20.0)


@pytest.mark.parametrize("size", [(48, 64), (64, 80)])
def test_no_worse_than_cv2s_own_file(tmp_path, size):
    """Each frame is no further from its input than the frame of cv2's own
    mp4v file of the same frames (even sizes: cv2's writer keeps them), in
    RGB and in luma."""
    frames = _frames(8, *size)
    _write(tmp_path / "port.mp4", frames)
    _write_like_the_jax_render(tmp_path / "cv2.mp4", frames)
    port, _ = _read(str(tmp_path / "port.mp4"))
    ref, _ = _read(str(tmp_path / "cv2.mp4"))
    assert len(port) == len(ref) == len(frames)
    for f, a, b in zip(frames, port, ref):
        assert _psnr(f, a) >= _psnr(f, b)
        assert _psnr(_luma(f), _luma(a)) >= _psnr(_luma(f), _luma(b))


def test_colours_in_rgb_order_as_the_jax_render(tmp_path):
    """Pure red, green and blue thirds come back in place (cv2's BGR
    reversed), as from the JAX render's cv2 file of the same RGB frames."""
    frame = np.zeros((48, 96, 3), np.uint8)
    for k in range(3):
        frame[:, 32 * k:32 * (k + 1), k] = 230
    _write(tmp_path / "port.mp4", [frame] * 2)
    _write_like_the_jax_render(tmp_path / "cv2.mp4", [frame] * 2)
    port, _ = _read(str(tmp_path / "port.mp4"))
    ref, _ = _read(str(tmp_path / "cv2.mp4"))
    for k in range(3):
        part = np.s_[8:40, 32 * k + 8:32 * k + 24]
        means = port[0][part].reshape(-1, 3).mean(axis=0)
        assert means.argmax() == k and means[k] > 200
        np.testing.assert_allclose(means, ref[0][part].reshape(-1, 3).mean(0),
                                   atol=8)


def test_boxes(tmp_path):
    """ftyp, moov, mdat; the track's sample table holds one sync sample
    per frame, their sizes summing to mdat's body, at 28 per second, and
    an mp4v entry at the frame size; describe() (the card's box walk)
    reads the same."""
    frames = _frames(5, 24, 40)
    path = tmp_path / "v.mp4"
    _write(path, frames)
    data = path.read_bytes()
    top = read_boxes(data)
    assert [b[0] for b in top] == ["ftyp", "moov", "mdat"]

    def child(parent, kind):
        _, off, size = parent
        found = [b for b in read_boxes(data, off, off + size) if b[0] == kind]
        assert len(found) == 1, kind
        return found[0]

    moov = top[1]
    mdia = child(child(moov, "trak"), "mdia")
    mdhd = child(mdia, "mdhd")
    timescale, duration = struct.unpack(">II", data[mdhd[1] + 12:mdhd[1] + 20])
    stbl = child(child(mdia, "minf"), "stbl")
    stsd = child(stbl, "stsd")
    entry = read_boxes(data, stsd[1] + 8, stsd[1] + stsd[2])[0]
    assert entry[0] == "mp4v"
    w, h = struct.unpack(">HH", data[entry[1] + 24:entry[1] + 28])
    stsz = child(stbl, "stsz")
    _, _, count = struct.unpack(">III", data[stsz[1]:stsz[1] + 12])
    sizes = struct.unpack(f">{count}I", data[stsz[1] + 12:stsz[1] + 12 + 4 * count])
    stss = child(stbl, "stss")
    (n_sync,) = struct.unpack(">I", data[stss[1] + 4:stss[1] + 8])
    stco = child(stbl, "stco")
    (offset,) = struct.unpack(">I", data[stco[1] + 8:stco[1] + 12])
    assert (w, h, count, n_sync) == (40, 24, 5, 5)
    assert (timescale, duration) == (28, 5)
    assert offset == top[2][1] and sum(sizes) == top[2][2]
    assert data[offset:offset + 4] == b"\x00\x00\x01\xb6"  # a VOP start code
    assert describe(str(path)) == {
        "boxes": ["ftyp", "moov", "mdat"], "entry": "mp4v", "width": 40,
        "height": 24, "samples": 5, "sync_samples": 5, "timescale": 28,
        "duration": 5, "fps": 28.0, "mdat_filled": True, "bytes": len(data)}

"""Time the port's JPEG codec (`dataset/jpeg.py`) at a real capture's size.

    python3 -m jnerf_tpu_torch.tools.jpeg_decode_time [--height 1080]
        [--width 1920] [--quality 95] [--repeat 5]

Makes one photograph-like RGB image (smooth colour ramps with a little
noise, so every DCT band carries energy) of height x width, encodes it at
``--quality`` (4:2:0, as ``write_image`` writes) and decodes the file,
each ``--repeat`` times on the host, checks that the decoded image is
within a few levels of the input and prints the times (host clock, this
machine's CPU).  The fox capture's frames are 1080 x 1920; fern's full-size
frames, which the LLFF loader decodes to minify, are 3024 x 4032.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from jnerf_tpu_torch.dataset.jpeg import decode_jpeg, encode_jpeg


def _median_ms(times):
    return sorted(times)[len(times) // 2] * 1e3


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--quality", type=int, default=95)
    ap.add_argument("--repeat", type=int, default=5)
    args = ap.parse_args(argv)
    h, w = args.height, args.width
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    noise = np.random.default_rng(0).normal(0, 4, (h, w, 3)).astype(np.float32)
    img = np.clip(np.stack([np.sin(x / 97.0 + k) * 90 + 128
                            + np.cos(y / 61.0) * 30 for k in range(3)], -1)
                  + noise, 0, 255).astype(np.uint8)
    enc, dec = [], []
    for _ in range(args.repeat):
        t0 = time.perf_counter()
        data = encode_jpeg(img, args.quality)
        enc.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        out = decode_jpeg(data)
        dec.append(time.perf_counter() - t0)
    err = np.abs(out.astype(np.int16) - img.astype(np.int16)).mean()
    assert out.shape == img.shape and err < 8, err
    print(f"{w}x{h} RGB at quality {args.quality} ({len(data)} B, mean "
          f"|error| {err:.2f} levels): encode {min(enc) * 1e3:.1f} ms min, "
          f"{_median_ms(enc):.1f} ms median; decode {min(dec) * 1e3:.1f} ms "
          f"min, {_median_ms(dec):.1f} ms median of {args.repeat}", flush=True)
    return {"encode_ms": _median_ms(enc), "decode_ms": _median_ms(dec),
            "bytes": len(data)}


if __name__ == "__main__":
    main()

"""Time the port's PNG decoder on a blender-lego-sized image.

    python3 -m jnerf_tpu_torch.tools.png_decode_time [--size 800] [--repeat 5]

Encodes one smooth RGBA image of size x size with every row under the
Paeth filter (which, like Average, reads the decoded pixel to the left, so
the decoder's wavefront pass runs) and once under Up (one vector op a
row), decodes each ``--repeat`` times on the host, checks the pixels and
prints the times (host clock, this machine's CPU).
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from jnerf_tpu_torch.dataset.dataset_util import decode_png, encode_png


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=800)
    ap.add_argument("--repeat", type=int, default=5)
    args = ap.parse_args(argv)
    y, x = np.mgrid[0:args.size, 0:args.size]
    img = np.stack([(x * 0.3 + y * 0.1) % 256, (x * y / 300.0) % 256,
                    np.sin(x / 20.0) * 120 + 128, np.full_like(x, 255)],
                   axis=-1).astype(np.uint8)
    for name, ftype in (("Paeth", 4), ("Up", 2)):
        data = encode_png(img, ftype)
        times = []
        for _ in range(args.repeat):
            t0 = time.perf_counter()
            out = decode_png(data)
            times.append(time.perf_counter() - t0)
        assert np.array_equal(out, img)
        print(f"{name} rows, {args.size}x{args.size} RGBA ({len(data)} B): "
              f"decode {min(times) * 1e3:.1f} ms min, "
              f"{sorted(times)[len(times) // 2] * 1e3:.1f} ms median of "
              f"{args.repeat}", flush=True)


if __name__ == "__main__":
    main()

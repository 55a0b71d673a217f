"""Equal-iteration quality A/B of the linear hash against the reference's
xor hash: the port's counterpart of `tools/ab_hash_quality.py`.

    python3 -m jnerf_tpu_torch.tools.ab_hash_quality [--steps=600] \\
        [--size=96] [--log2=15] [--levels=8] [--rays=1024] [--cpu]

Both arms, ``linear_rows`` then ``xor``, train the same analytic scene (8
images of size x size, a 64^3 grid, 256 march steps, ``--rays`` rays and
32 target samples a ray) for the same steps from the same seed
(``Runner.train_range``: a refresh every 16 steps, the batch adapted a
window later), then render up to 2 validation views.  One JSON line an
arm, with `tools/ab_hash_quality.py`'s keys and the card's name and power
limit.  Runs on the card; without one it raises unless given ``--cpu``.
"""

from __future__ import annotations

import argparse
import json

import torch


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--size", type=int, default=96)
    ap.add_argument("--log2", type=int, default=15)
    ap.add_argument("--levels", type=int, default=8)
    ap.add_argument("--rays", type=int, default=1024)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    from jnerf_tpu_torch.tools.tool_util import card, device_for

    device = device_for(args.cpu, "ab_hash_quality")
    from jnerf_tpu_torch.models.losses import img2mse, mse2psnr
    from jnerf_tpu_torch.runner import Runner
    from jnerf_tpu_torch.utils import bench_cfg

    on = card(device)
    out = []
    for indexing in ("linear_rows", "xor"):
        cfg = bench_cfg.ngp_synthetic_cfg(
            n_images=8, H=args.size, W=args.size, n_rays_per_batch=args.rays,
            target_batch_size=args.rays * 32, grid_size=64, nerf_steps=256,
            hash_levels=args.levels, log2_hashmap_size=args.log2,
            tot_train_steps=args.steps)
        cfg.hash_indexing = indexing
        runner = Runner(device=device)
        float(runner.train_range(0, args.steps))
        psnrs = []
        for img_id in range(min(2, runner.dataset["val"].n_images)):
            img, _a, tar = runner.render_img(dataset_mode="val", img_id=img_id)
            psnrs.append(float(mse2psnr(img2mse(torch.from_numpy(img),
                                                torch.from_numpy(tar)))))
        line = {
            "hash_indexing": indexing,
            "steps": args.steps,
            "size": args.size,
            "log2": args.log2,
            "levels": args.levels,
            "psnr": round(sum(psnrs) / len(psnrs), 2),
            "per_view": [round(p, 2) for p in psnrs],
            "backend": device.type,
            "card": on,
        }
        out.append(line)
        print(json.dumps(line), flush=True)
    return out


if __name__ == "__main__":
    main()

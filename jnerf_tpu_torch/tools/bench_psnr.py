"""PSNR at a wall-clock budget: the port's counterpart of `bench_psnr.py`.

    python3 -m jnerf_tpu_torch.tools.bench_psnr --scene hard --encoder f8l4 \\
        --compact --compact-m 17 --march-factor 2 --fast-cap 524288 \\
        --out logs/torch/quality/psnr300_f8l4_m17f2k19_hard.json

The reference's quality bar is Instant-NGP's 36.41 dB on blender-lego
within 5 minutes on an RTX 3090.  Lego is not in the repository, so this
trains the analytic spheres (or ``--scene hard``) at reference scale for
``--budget-s`` seconds of training, by refresh windows, after
``--warmup-steps`` outside the budget (the kernels' build and the
first-call costs, which the reference's precompiled kernels do not pay
either), or for exactly ``--iters`` steps; then reports the mean
validation PSNR over up to 4 views, as one JSON line with `bench_psnr.py`'s
keys and the card's name and power limit.  ``vs_baseline`` is that PSNR
as a fraction of the measured ceiling of the same config
(``logs/torch/ceiling_<config>_plain_s42.json``, the default name of
``jnerf_tpu_torch.tools.ceiling_run``, or ``--ceiling-file``), null when
none is found; ``fraction_suspect`` flags a fraction past 1.02 and
``ceiling_code_state_mismatch`` a ceiling from a rev whose port code
differs (or whose diff fails).  ``--out``
writes the line atomically; nothing else is written.  Runs on the card;
without one it raises unless given ``--cpu``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

import torch


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--budget-s", type=float, default=300.0)
    ap.add_argument("--iters", type=int, default=0,
                    help="if >0, train exactly this many iterations instead "
                         "of a wall-clock budget (equal-iteration A/Bs)")
    ap.add_argument("--image-size", type=int, default=512)
    ap.add_argument("--hash-indexing", default="linear_rows",
                    choices=["linear_rows", "linear_nbr", "linear_rows_xla",
                             "xor"])
    ap.add_argument("--encoder", default="f4l8",
                    choices=["f2l16", "f4l8", "f8l4"],
                    help="hash-grid shape: the reference's 16x2, or 8x4 / "
                         "4x8 with the same 32-wide output")
    ap.add_argument("--fast-cap", type=int, default=0,
                    help="hashed-level table cap in entries (0 = default; "
                         "524288 = the reference's 2^19)")
    ap.add_argument("--compact", action="store_true",
                    help="ragged sample compaction: the model runs on the "
                         "kept samples only")
    ap.add_argument("--scene", default="spheres", choices=["spheres", "hard"],
                    help="'hard' = the textured, thin-structured scene with "
                         "supersampled ground truth")
    ap.add_argument("--ssaa", type=int, default=0,
                    help="GT supersampling (0 = scene default: 1/2)")
    ap.add_argument("--n-val", type=int, default=0,
                    help="validation views (0 = scene default: 2/4)")
    ap.add_argument("--march-factor", type=int, default=1,
                    help="over-provision the per-ray march budget by this "
                         "factor (compaction keeps model cost at M)")
    ap.add_argument("--compact-m", type=int, default=0,
                    help="log2 of the compacted model batch M (0 = target "
                         "batch size)")
    ap.add_argument("--ceiling-file", default="",
                    help="ceiling JSON to normalize against: a bare name "
                         "resolves under logs/torch/, a path is used as is")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--tiny", action="store_true",
                    help="harness smoke test: tiny scene and model")
    ap.add_argument("--warmup-steps", type=int, default=256,
                    help="steps (and one grid refresh) outside the budget")
    ap.add_argument("--out", default="",
                    help="also write the JSON line to this path atomically")
    return ap.parse_args(argv)


def ceiling_name(args):
    """The ceiling file to read, a bare name under logs/torch/ or a path:
    ``--ceiling-file``, else `ceiling_run`'s default name of this config
    (the plain MLP, seed 42)."""
    if args.ceiling_file:
        return args.ceiling_file
    from jnerf_tpu_torch.tools.ceiling_run import config_name

    run = argparse.Namespace(
        encoder=args.encoder, compact=args.compact, compact_m=args.compact_m,
        march_factor=args.march_factor, fast_cap=args.fast_cap,
        scene=args.scene, pallas_mlp=False, seed=42)
    return f"ceiling_{config_name(run)}.json"


def main(argv=None):
    """Train, score, print (and with ``--out`` write) the line; returns
    the result."""
    args = parse_args(argv)
    from jnerf_tpu_torch.tools.tool_util import (
        ENCODERS, LOG_DIR, REPO, card, device_for, git_rev, rev_mismatch,
        write_atomic,
    )

    device = device_for(args.cpu, "bench_psnr")
    from jnerf_tpu_torch.models.losses import img2mse, mse2psnr
    from jnerf_tpu_torch.runner import Runner
    from jnerf_tpu_torch.utils import bench_cfg

    if args.tiny:
        cfg = bench_cfg.ngp_synthetic_cfg(
            n_images=4, H=64, W=64, n_rays_per_batch=512,
            target_batch_size=1 << 13, grid_size=32, nerf_steps=128,
            hash_levels=8, log2_hashmap_size=13, tot_train_steps=1 << 30)
    else:
        cfg = bench_cfg.ngp_synthetic_cfg(
            n_images=16, H=args.image_size, W=args.image_size,
            tot_train_steps=1 << 30, scene=args.scene,
            ssaa=args.ssaa or (2 if args.scene == "hard" else 1),
            n_val=args.n_val or (4 if args.scene == "hard" else 2),
            **ENCODERS[args.encoder])
    cfg.hash_indexing = args.hash_indexing
    if args.fast_cap:
        cfg.hashmap_fast_cap = args.fast_cap
    if args.compact:
        cfg.compacted_batch = (1 << args.compact_m) if args.compact_m else True
        cfg.march_budget_factor = args.march_factor
    runner = Runner(device=device)
    freq = runner.sampler.update_den_freq

    float(runner.train_range(0, args.warmup_steps))
    i = args.warmup_steps
    t0 = time.perf_counter()
    if args.iters:
        float(runner.train_range(i, i + args.iters))
        i += args.iters
    else:
        while time.perf_counter() - t0 < args.budget_s:
            float(runner.train_range(i, i + freq))
            i += freq
    elapsed = time.perf_counter() - t0
    iters = i - args.warmup_steps

    psnrs = []
    for img_id in range(min(4, runner.dataset["val"].n_images)):
        img, _a, tar = runner.render_img(dataset_mode="val", img_id=img_id)
        psnrs.append(float(mse2psnr(img2mse(torch.from_numpy(img),
                                            torch.from_numpy(tar)))))

    ceiling = ceiling_rev = None
    name = ceiling_name(args)
    path = name if os.path.dirname(name) else os.path.join(LOG_DIR, name)
    if os.path.exists(path):
        with open(path) as f:
            cdata = json.load(f)
        ceiling = cdata.get("psnr_ceiling")
        ceiling_rev = cdata.get("git_rev")
    if args.ceiling_file and ceiling is None:
        print(f"[bench_psnr] WARNING: requested ceiling file "
              f"{args.ceiling_file} not found; vs_baseline will be null",
              file=sys.stderr)
    mean_psnr = sum(psnrs) / len(psnrs)
    fraction = round(mean_psnr / ceiling, 3) if ceiling else None
    fraction_suspect = bool(fraction is not None and fraction > 1.02)
    rev = git_rev(REPO)
    state_mismatch = bool(ceiling_rev and rev and ceiling_rev != rev
                          and rev_mismatch(ceiling_rev, rev))
    if fraction_suspect:
        print(f"[bench_psnr] WARNING: psnr {mean_psnr:.2f} exceeds the cited "
              f"ceiling {ceiling} by >2%: the ceiling file is stale; re-run "
              "jnerf_tpu_torch.tools.ceiling_run", file=sys.stderr)
    if state_mismatch:
        print(f"[bench_psnr] WARNING: the ceiling was measured at git "
              f"{ceiling_rev}, this run is {rev}, and the port's code "
              "differs (or the diff failed)", file=sys.stderr)
    if not all(math.isfinite(p) for p in psnrs):
        raise SystemExit(f"bench_psnr: non-finite PSNR {psnrs}")
    result = {
        "metric": "ngp_psnr_at_budget",
        "value": round(mean_psnr, 2),
        "unit": "dB",
        "vs_baseline": fraction,
        "extra": {
            "psnr_ceiling": ceiling,
            "git_rev": rev,
            "ceiling_git_rev": ceiling_rev,
            **({"fraction_suspect": True} if fraction_suspect else {}),
            **({"ceiling_code_state_mismatch": True}
               if state_mismatch else {}),
            "budget_s": (None if args.iters else args.budget_s),
            "iters": iters,
            "iters_per_s": round(iters / elapsed, 2),
            "hash_indexing": args.hash_indexing,
            "encoder": args.encoder,
            "fast_cap": args.fast_cap or None,
            "compact": ((f"m=2^{args.compact_m}" if args.compact_m
                         else "m=target") + f",f={args.march_factor}"
                        if args.compact else None),
            "per_view_psnr": [round(p, 2) for p in psnrs],
            "scene": ("synthetic-spheres-tiny" if args.tiny else
                      f"synthetic-{args.scene}-{args.image_size}")
                     + " (lego is not in the repository)",
            "backend": device.type,
            "card": card(device),
        },
    }
    line = json.dumps(result)
    print(line, flush=True)
    if args.out:
        write_atomic(args.out, line + "\n")
    return result


if __name__ == "__main__":
    main()

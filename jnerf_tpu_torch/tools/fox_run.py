"""Quality runs on the fox real capture: the port's counterpart of
`tools/fox_run.py`, with the same flags (``--device`` in place of
``--cpu``), the same two modes, eval and result keys, and one JSON line.

    python3 -m jnerf_tpu_torch.tools.fox_run --mode ceiling --steps 16384
    python3 -m jnerf_tpu_torch.tools.fox_run --mode budget --budget-s 300

It trains `projects/ngp/configs/ngp_fox.py` (``aabb_scale`` 4: three grid
cascades, cone-angle steps) on ``data/fox`` under the checkout (50 JPEGs
at 1080 x 1920 with k1/k2/p1/p2 distortion, read by the port's codec; the
capture is not in the repository).  ``--mode ceiling`` evaluates every
``--eval-every`` steps and writes ``logs/torch/ceiling_fox.json``;
``--mode budget`` trains for ``--budget-s`` seconds after
``--warmup-steps`` and writes ``logs/torch/quality/psnr300_fox.json``.
The eval renders the 2 held-out frames (``transforms_test.json``) and
takes the PSNR in the trainer's composited space against its background
(the photographs are opaque, so plain RGB MSE); ``--eval-scale s``
renders every s-th pixel against the same-strided target.  It runs on the
card and refuses to run without one unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

from jnerf_tpu_torch.tools.tool_util import ENCODERS, REPO, git_rev


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", default="ceiling", choices=["ceiling", "budget"])
    ap.add_argument("--steps", type=int, default=16384,
                    help="ceiling-mode training steps")
    ap.add_argument("--eval-every", type=int, default=4096)
    ap.add_argument("--budget-s", type=float, default=300.0)
    ap.add_argument("--warmup-steps", type=int, default=256,
                    help="budget mode: steps excluded from the budget")
    ap.add_argument("--encoder", default="f8l4",
                    choices=["f2l16", "f4l8", "f8l4"])
    ap.add_argument("--fast-cap", type=int, default=0)
    ap.add_argument("--compact-m", type=int, default=0,
                    help="log2 of the compacted batch M (0 = the config's)")
    ap.add_argument("--march-factor", type=int, default=2)
    ap.add_argument("--eval-scale", type=int, default=1,
                    help="downsample factor for eval renders (CPU smokes)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default="")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    import numpy as np
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("fox_run needs an NVIDIA GPU (or --device cpu): "
                         "torch.cuda.is_available() is false")
    from jnerf_tpu_torch.models.losses import img2mse, mse2psnr
    from jnerf_tpu_torch.runner import Runner
    from jnerf_tpu_torch.utils import config
    from jnerf_tpu_torch.utils.registry import DATASETS, build_from_cfg

    os.chdir(REPO)  # the config's dataset_dir is repo-relative ("data/fox")
    config.init_cfg(os.path.join(REPO, "projects/ngp/configs/ngp_fox.py"))
    cfg = config.get_cfg()
    cfg.tot_train_steps = 1 << 30
    enc = ENCODERS[args.encoder]
    if enc:
        cfg.encoder.pos_encoder.update(
            n_levels=enc["hash_levels"],
            n_features_per_level=enc["hash_features"])
    if args.fast_cap:
        cfg.hashmap_fast_cap = args.fast_cap
    if args.compact_m:
        cfg.compacted_batch = 1 << args.compact_m
        cfg.march_budget_factor = args.march_factor

    dev = torch.device(args.device)
    runner = Runner(device=dev)
    u = torch.rand((runner.render_chunk_rays,), device=dev,
                   generator=torch.Generator(dev).manual_seed(0))

    def eval_psnr():
        if runner.dataset["test"] is None:
            runner.dataset["test"] = build_from_cfg(
                runner.cfg.dataset.test, DATASETS, device=dev)
        ds = runner.dataset["test"]
        bg = runner.background_color.cpu().numpy()
        ps = []
        s = args.eval_scale
        for img_id in range(2):
            if s == 1:
                img, _a, tar = runner.render_img(dataset_mode="test",
                                                 img_id=img_id, u=u)
            else:
                H, W = runner.H, runner.W
                ro, rd = ds.generate_rays_total_test(img_id)
                ro = ro.reshape(H, W, 3)[::s, ::s].reshape(-1, 3)
                rd = rd.reshape(H, W, 3)[::s, ::s].reshape(-1, 3)
                h2, w2 = (H + s - 1) // s, (W + s - 1) // s
                img, alpha = runner._render_rays_chunked(
                    ro.to(dev), rd.to(dev), h2, w2, u=u)
                tar_full = ds.image(img_id)[::s, ::s]
                tar = tar_full[..., :3] * tar_full[..., 3:] \
                    + bg * (1 - tar_full[..., 3:])
                img = img + bg * (1 - alpha)
            ps.append(float(mse2psnr(img2mse(
                torch.from_numpy(np.asarray(img, np.float32)),
                torch.from_numpy(np.asarray(tar, np.float32))))))
        return float(np.mean(ps)), [round(p, 2) for p in ps]

    def train(i, nxt):
        loss = float(runner.train_range(i, nxt))
        if not math.isfinite(loss):
            raise SystemExit(f"non-finite loss at step {nxt}: {loss}")

    t0 = time.perf_counter()
    if args.mode == "ceiling":
        trajectory = []
        i = 0
        while i < args.steps:
            nxt = min(args.steps, i + args.eval_every)
            train(i, nxt)
            i = nxt
            psnr, _per_view = eval_psnr()
            trajectory.append({"iters": i, "psnr": round(psnr, 3),
                               "elapsed_s": round(
                                   time.perf_counter() - t0, 1)})
            print(f"[fox] iters={i} psnr={psnr:.3f} "
                  f"({time.perf_counter() - t0:.0f}s)", flush=True)
        final_psnr, per_view = eval_psnr()
        ceiling = max([final_psnr] + [t["psnr"] for t in trajectory])
        result = {
            "psnr_ceiling": round(ceiling, 2),
            "psnr_final": round(final_psnr, 2),
            "per_view_psnr": per_view,
            "iters": args.steps,
            "trajectory": trajectory,
        }
        default_out = os.path.join(REPO, "logs", "torch", "ceiling_fox.json")
    else:
        train(0, args.warmup_steps)
        t0 = time.perf_counter()
        i = args.warmup_steps
        chunk = 512
        while time.perf_counter() - t0 < args.budget_s:
            train(i, i + chunk)
            i += chunk
        elapsed = time.perf_counter() - t0
        psnr, per_view = eval_psnr()
        iters = i - args.warmup_steps
        result = {
            "psnr_at_budget": round(psnr, 2),
            "per_view_psnr": per_view,
            "budget_s": args.budget_s,
            "iters": iters,
            "iters_per_s": round(iters / elapsed, 2),
        }
        default_out = os.path.join(REPO, "logs", "torch", "quality",
                                   "psnr300_fox.json")

    result.update({
        "encoder": args.encoder,
        "fast_cap": args.fast_cap or None,
        "compact": ((f"m=2^{args.compact_m},f={args.march_factor}")
                    if args.compact_m else None),
        "dataset": "fox-real-capture (data/fox, 50 train / 2 test)",
        "git_rev": git_rev(REPO),
        "elapsed_s": round(time.perf_counter() - t0, 1),
        "backend": dev.type,
    })
    out_path = args.out or default_out
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    tmp = out_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(result, f, indent=1)
    os.replace(tmp, out_path)
    print(json.dumps({k: v for k, v in result.items()
                      if k != "trajectory"}), flush=True)
    return result


if __name__ == "__main__":
    sys.exit(0 if main() else 1)

"""Train an NGP config on an analytic scene and record its validation PSNR
at equal iteration counts: the port's counterpart of `tools/ceiling_run.py`,
with the same flags, defaults, eval and "ceiling = best eval" rule.

    python3 -m jnerf_tpu_torch.tools.ceiling_run --encoder f8l4 \\
        --scene hard --fast-cap 524288 --compact --compact-m 17 \\
        --march-factor 2 --steps 8192 --eval-every 4096 --seed 42 \\
        [--pallas-mlp]

Every ``--eval-every`` steps (``Runner.train_range``) it renders the val
views and takes their mean ``mse2psnr(img2mse(render, target))``; every
eval uses one fixed march jitter, as the JAX runner renders with one key.
It writes one JSON to ``--out`` (default
``logs/torch/ceiling_<config>[_<scene>]_<plain|fused>_s<seed>.json`` in
the repository, e.g. ``ceiling_f8l4_m17f2k19_hard_plain_s42.json``) with
the trajectory, the per-view PSNR, the card's name and power limit as
nvidia-smi gives them and the git rev, and saves the trained field with
``Runner.save_ckpt`` to ``work_dirs/torch/<the JSON's name>/params.pkl``
under the working directory.  It runs on the card and refuses to run
without one unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path

from jnerf_tpu_torch.tools.tool_util import ENCODERS, REPO, card, git_rev


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=40_000)
    ap.add_argument("--eval-every", type=int, default=8192)
    ap.add_argument("--image-size", type=int, default=512)
    ap.add_argument("--encoder", default="f2l16",
                    choices=["f2l16", "f4l8", "f8l4"])
    ap.add_argument("--scene", default="spheres", choices=["spheres", "hard"])
    ap.add_argument("--ssaa", type=int, default=0,
                    help="GT supersampling factor (0 = scene default: 1 for "
                         "spheres, 2 for hard)")
    ap.add_argument("--n-val", type=int, default=0,
                    help="validation views (0 = scene default: 2/4)")
    ap.add_argument("--fast-cap", type=int, default=0,
                    help="hashed-level table cap in entries (0 = default)")
    ap.add_argument("--compact", action="store_true")
    ap.add_argument("--march-factor", type=int, default=2)
    ap.add_argument("--compact-m", type=int, default=0,
                    help="log2 of the compacted model batch M (0 = target)")
    ap.add_argument("--pallas-mlp", action="store_true",
                    help="cfg.use_pallas_mlp: train with the fused MLP "
                         "kernels (F-MLP forward, B-MLP backward)")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default=None, help="json path (default above)")
    return ap.parse_args(argv)


def config_name(args) -> str:
    """e.g. f8l4_m17f2k19_hard_plain_s42 for the headline on the hard
    scene, trained with the plain MLP at seed 42."""
    name = args.encoder
    if args.compact:
        name += f"_m{args.compact_m or 'T'}f{args.march_factor}"
    if args.fast_cap:
        log2 = math.log2(args.fast_cap)
        name += f"k{int(log2)}" if log2.is_integer() else f"k{args.fast_cap}"
    if args.scene != "spheres":
        name += f"_{args.scene}"
    return name + f"_{'fused' if args.pallas_mlp else 'plain'}_s{args.seed}"


def main(argv=None):
    args = parse_args(argv)
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("ceiling_run needs an NVIDIA GPU (or --device cpu): "
                         "torch.cuda.is_available() is false")
    from jnerf_tpu_torch.models.losses import img2mse, mse2psnr
    from jnerf_tpu_torch.runner import Runner
    from jnerf_tpu_torch.utils.bench_cfg import ngp_synthetic_cfg

    ssaa = args.ssaa or (2 if args.scene == "hard" else 1)
    n_val = args.n_val or (4 if args.scene == "hard" else 2)
    cfg = ngp_synthetic_cfg(
        n_images=16, H=args.image_size, W=args.image_size,
        tot_train_steps=args.steps, scene=args.scene, ssaa=ssaa,
        n_val=n_val, seed=args.seed, **ENCODERS[args.encoder])
    if args.fast_cap:
        cfg.hashmap_fast_cap = args.fast_cap
    if args.compact:
        cfg.compacted_batch = (1 << args.compact_m) if args.compact_m else True
        cfg.march_budget_factor = args.march_factor
    cfg.use_pallas_mlp = args.pallas_mlp

    dev = torch.device(args.device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    runner = Runner(device=dev)
    sync()
    setup_s = time.perf_counter() - t0
    if runner.model._fused_ok != args.pallas_mlp:
        raise SystemExit("cfg.use_pallas_mlp did not set the fused MLP gate")
    u = torch.rand((runner.render_chunk_rays,), device=dev,
                   generator=torch.Generator(dev).manual_seed(0))
    print(f"[ceiling] setup (scene build included) {setup_s:.3f} s",
          flush=True)

    def eval_psnr():
        ps = []
        for img_id in range(min(n_val, runner.dataset["val"].n_images)):
            img, _a, tar = runner.render_img("val", img_id=img_id, u=u)
            ps.append(float(mse2psnr(img2mse(torch.from_numpy(img),
                                             torch.from_numpy(tar)))))
        return sum(ps) / len(ps), ps

    t0 = time.perf_counter()
    train_s, trajectory, per_view = 0.0, [], []
    i = 0
    while i < args.steps:
        nxt = min(args.steps, i + args.eval_every)
        t_train = time.perf_counter()
        loss = float(runner.train_range(i, nxt))
        train_s += time.perf_counter() - t_train
        if not math.isfinite(loss):
            raise SystemExit(f"non-finite loss at step {nxt}: {loss}")
        i = nxt
        psnr, per_view = eval_psnr()
        trajectory.append({"iters": i, "psnr": round(psnr, 3),
                           "per_view_psnr": [round(p, 3) for p in per_view],
                           "loss": loss,
                           "elapsed_s": round(time.perf_counter() - t0, 1)})
        print(f"[ceiling] iters={i} psnr={psnr:.3f} per view "
              f"{', '.join(f'{p:.3f}' for p in per_view)} "
              f"({time.perf_counter() - t0:.0f} s, "
              f"{i / train_s:.2f} steps/s training)", flush=True)

    name = config_name(args)
    out_path = Path(args.out or REPO / "logs" / "torch" / f"ceiling_{name}.json")
    ckpt = Path("work_dirs") / "torch" / out_path.stem / "params.pkl"
    runner.save_ckpt(str(ckpt))
    result = {
        "psnr_ceiling": round(max(t["psnr"] for t in trajectory), 3),
        "psnr_final": trajectory[-1]["psnr"],
        "per_view_psnr": [round(p, 3) for p in per_view],
        "iters": args.steps,
        "encoder": args.encoder,
        "fast_cap": args.fast_cap or None,
        "git_rev": git_rev(REPO),
        "compact": ((f"m=2^{args.compact_m}" if args.compact_m
                     else "m=target") + f",f={args.march_factor}"
                    if args.compact else None),
        "scene": f"synthetic-{args.scene}-{args.image_size}"
                 + (f"-ssaa{ssaa}" if ssaa > 1 else ""),
        "use_pallas_mlp": args.pallas_mlp,
        "seed": args.seed,
        "trajectory": trajectory,
        "setup_s": round(setup_s, 3),
        "train_steps_per_s": round(args.steps / train_s, 3),
        "elapsed_s": round(time.perf_counter() - t0, 1),
        "backend": dev.type,
        "card": card(dev),
        "ckpt": str(ckpt),
    }
    out_path.parent.mkdir(parents=True, exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({k: v for k, v in result.items() if k != "trajectory"}),
          flush=True)
    return result


if __name__ == "__main__":
    sys.exit(0 if main() else 1)

"""Benchmark of the port: steady-state Instant-NGP training throughput.

    python3 -m jnerf_tpu_torch.bench [--encoder f8l4+m17f2k19] [--cpu]

The port's counterpart of `bench.py`, with its flags, its configs in its
order (the headline first), its variant grammar, its sample count and its
one JSON line: ``ngp_train_iters_per_s`` against the reference's 133
iters/s on an RTX 3090 at ngp_base scale (4096 rays, 2^18 target samples
a step, a 128^3 x 5-cascade grid, bf16 MLPs), and ``vs_baseline_samples``
against its 2^18 real samples a step.  Each config trains on the
in-memory ``SyntheticSpheresDataset`` (16 images) with
``Runner.train_range``: ``--warmup`` steps, then ``--steps`` timed by the
host clock from the window's start to a read of its last loss.  Every
config also reports the launches of the hash kernels F and B in its
timed window, and the line carries the card's name and power limit.

Three departures from `bench.py`:

- a failed config is kept as its ``{"error": ...}`` entry and the line
  is printed, but the exit code is 1 if any config failed (`bench.py`
  exits 0 when one config survives);
- the headline's quality anchor is the port's own, from ``logs/torch/``:
  ``ceiling_<head>_hard_plain_s42.json`` (the default name of
  ``jnerf_tpu_torch.tools.ceiling_run``) and
  ``quality/psnr300_<head>_hard.json`` (written by
  ``jnerf_tpu_torch.tools.bench_psnr --out``);
- the anchor's rev guard counts a failed ``git diff`` of
  ``jnerf_tpu_torch`` between the two runs' revs as a mismatch.

Runs on the card; without one it raises unless given ``--cpu``.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
import time
from pathlib import Path

BASELINE_ITERS_PER_S = 133.0  # JNeRF-NGP on an RTX 3090 (reference README)
# The reference trains target_batch_size = 2^18 compacted samples a step
# (ngp_base.py:75); iters/s alone flatters a config that trains fewer real
# samples a step, so the line also gives samples/s over the reference's.
BASELINE_SAMPLES_PER_S = BASELINE_ITERS_PER_S * (1 << 18)

# `bench.py`'s configs in its order: the first is the headline, the
# reference-capacity (2^19-entry) tables at the 4 x 8 geometry with the
# batch compacted to 2^17 and a x2 march budget; then the speed modes and
# the reference's padded shape.
SHAPES = ("f8l4+m17f2k19", "f8l4+m17f2", "f8l4+m16f1", "f4l8+m16f1",
          "f2l16+m16f1", "f2l16")


def parse_variant(variant: str) -> dict:
    """Compaction variant grammar -> config overrides.

    "c<N>" = compact at M=target, march budget factor N; "m<B>" = compact
    at M=2^B; "f<N>" = march budget factor N; "k<B>" = hashed-level table
    cap 2^B entries (k19 = the reference's 2^19).  E.g. "m16f1" is a
    speed mode, "m17f2k19" the headline's quality mode.
    """
    knobs = {"compacted_batch": True}
    for tok, val in re.findall(r"([cmfk])(\d+)", variant):
        if tok == "m":
            knobs["compacted_batch"] = 1 << int(val)
        elif tok == "k":
            knobs["hashmap_fast_cap"] = 1 << int(val)
        else:  # c and f both set the march budget factor
            knobs["march_budget_factor"] = int(val)
    return knobs


def measure(encoder: str, args) -> dict:
    """Train one config at bench scale on ``args.device``; returns
    `bench.py`'s keys (``iters_per_s``, ``rays_per_s``, ...) and the
    launches of kernels F and B in the timed window."""
    from jnerf_tpu_torch.ops import hash_nbr
    from jnerf_tpu_torch.runner import Runner
    from jnerf_tpu_torch.tools.tool_util import ENCODERS
    from jnerf_tpu_torch.utils import bench_cfg
    from jnerf_tpu_torch.utils.metrics import ThroughputMeter

    name, _, variant = encoder.partition("+")
    cfg = bench_cfg.ngp_synthetic_cfg(
        n_images=16, H=args.image_size, W=args.image_size,
        tot_train_steps=args.warmup + args.steps, **ENCODERS[name])
    if variant:
        for k, v in parse_variant(variant).items():
            setattr(cfg, k, v)

    runner = Runner(device=args.device)
    meter = ThroughputMeter(window=args.steps)

    def tick(n, n_rays, n_samples_per_ray):
        for _ in range(n):
            meter.tick(n_rays=n_rays, n_samples=n_rays * n_samples_per_ray)

    # Warm-up: kernel builds, the grid's convergence, the batch shape's
    # settling.
    float(runner.train_range(0, args.warmup))
    fwd0, bwd0 = hash_nbr.encode_fwd.launches, hash_nbr.grad_table.launches
    meter.tick()  # arm the meter's clock at the window's start
    t0 = time.perf_counter()
    loss = runner.train_range(args.warmup, args.warmup + args.steps, tick=tick)
    float(loss)  # waits for the window's last step
    elapsed = time.perf_counter() - t0

    iters_per_s = args.steps / elapsed
    mean_rays = sum(meter.rays) / max(len(meter.rays), 1)
    # Real samples trained a step: the march's demand a ray (the sampler's
    # EMA over the run's windows) times the rays, clipped to what a step
    # keeps (the compaction cap M, or the padded [R, S] slots).
    sampler = runner.sampler
    demand = sampler._demand_ema or 0.0
    kept_cap = (cfg.compacted_batch if cfg.compacted_batch
                else sampler.n_rays_per_batch * sampler.n_samples_per_ray)
    if kept_cap is True:
        kept_cap = sampler.target_batch_size
    samples_per_step = min(demand * sampler.n_rays_per_batch, kept_cap)
    return {
        "iters_per_s": round(iters_per_s, 2),
        "rays_per_s": round(iters_per_s * mean_rays),
        "samples_per_step": round(samples_per_step),
        "samples_per_s": round(iters_per_s * samples_per_step),
        "n_rays_per_batch": sampler.n_rays_per_batch,
        "samples_per_ray": sampler.n_samples_per_ray,
        "elapsed_s": round(elapsed, 2),
        "launches": {"F": hash_nbr.encode_fwd.launches - fwd0,
                     "B": hash_nbr.grad_table.launches - bwd0},
    }


def quality_anchor(head_name: str, log_dir) -> dict:
    """The headline's quality reading from ``log_dir`` (``logs/torch``):
    its PSNR after bench_psnr's 5-minute budget as a fraction of the
    ceiling_run ceiling of the same config, with the stale-pair flags.
    Raises OSError, KeyError or ValueError if either file is missing or
    malformed."""
    from jnerf_tpu_torch.tools.tool_util import rev_mismatch

    head_file = head_name.replace("+", "_")  # f8l4+m17f2k19 -> f8l4_m17f2k19
    with open(Path(log_dir) / f"ceiling_{head_file}_hard_plain_s42.json") as f:
        ceil = json.load(f)
    quality = Path(log_dir) / "quality"
    with open(quality / f"psnr300_{head_file}_hard.json") as f:
        at5 = json.load(f)
    q = {
        "psnr_at_5min": at5["value"],
        "psnr_ceiling": ceil["psnr_ceiling"],
        "fraction_of_ceiling": round(at5["value"] / ceil["psnr_ceiling"], 3),
        "scene": ceil["scene"],
    }
    # A fraction past 1.02 means one side of the pair predates a code
    # change; revs that differ in the port's code cannot be claimed as
    # one measurement even when the fraction looks sane.
    if q["fraction_of_ceiling"] > 1.02:
        q["fraction_suspect"] = True
    crev = ceil.get("git_rev")
    qrev = at5.get("git_rev") or at5.get("extra", {}).get("git_rev")
    if crev and qrev and crev != qrev and rev_mismatch(crev, qrev):
        q["rev_mismatch"] = f"{crev}!={qrev}"
    return q


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU (debug; no device numbers)")
    parser.add_argument("--warmup", type=int, default=512)
    parser.add_argument("--steps", type=int, default=256)
    parser.add_argument("--image-size", type=int, default=512)
    parser.add_argument("--encoder", default="both",
                        help="f2l16 | f4l8 | f8l4, optionally with a "
                             "variant ('+m17f2k19', '+c4', ...), or 'both' "
                             "for every config of the bench")
    return parser.parse_args(argv)


def main(argv=None) -> int:
    """Measure the configs and print the one JSON line; returns the exit
    code: 1 if any config failed."""
    from jnerf_tpu_torch.tools.tool_util import LOG_DIR, card, device_for

    args = parse_args(argv)
    args.device = device_for(args.cpu, "jnerf_tpu_torch.bench")
    shapes = list(SHAPES) if args.encoder == "both" else [args.encoder]
    # Each config under its own trap, streamed to stderr as it finishes:
    # a failed config becomes an {"error": ...} entry, not a lost line.
    results = {}
    for s in shapes:
        try:
            results[s] = measure(s, args)
        except Exception as e:  # noqa: BLE001 — the instrument must survive
            results[s] = {"error": f"{type(e).__name__}: {e}"[:500]}
        print(f"[bench] {s}: {json.dumps(results[s])}", file=sys.stderr,
              flush=True)

    ok = [s for s in shapes if "error" not in results[s]]
    if not ok:
        print(json.dumps({"metric": "ngp_train_iters_per_s", "value": 0,
                          "unit": "iters/s", "vs_baseline": 0.0,
                          "extra": {"errors": results}}), flush=True)
        return 1
    head_name = ok[0]  # list order = headline preference
    headline = results[head_name]
    extra = {"encoder": head_name, **headline,
             "backend": args.device.type, "card": card(args.device)}
    extra.pop("iters_per_s")
    for name in shapes:
        if name != head_name:
            extra[name] = results[name]
    try:
        extra["quality"] = quality_anchor(head_name, LOG_DIR)
    except (OSError, KeyError, ValueError) as e:
        # A headline without its quality anchor is shown, not hidden.
        extra["quality_error"] = f"{type(e).__name__}: {e}"[:200]
    extra["vs_baseline_samples"] = round(
        headline.get("samples_per_s", 0) / BASELINE_SAMPLES_PER_S, 3)
    print(json.dumps({
        "metric": "ngp_train_iters_per_s",
        "value": headline["iters_per_s"],
        "unit": "iters/s",
        "vs_baseline": round(headline["iters_per_s"] / BASELINE_ITERS_PER_S,
                             3),
        "extra": extra,
    }), flush=True)
    return 1 if len(ok) < len(shapes) else 0


if __name__ == "__main__":
    sys.exit(main())

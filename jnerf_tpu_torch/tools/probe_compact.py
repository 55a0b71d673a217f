"""Padded against compacted training steps at bench scale: the port's
counterpart of `tools/probe_compact.py`.

    python3 -m jnerf_tpu_torch.tools.probe_compact [--encoder f8l4] \\
        [--steps 512] [--only padded,compact_m16_f1]

For each of `tools/probe_compact.py`'s six configs (the padded [R, S]
batch; compaction to the target with march factors 2 and 4; to 2^17 with
factors 2 and 1; to 2^16 with factor 1) it trains ``--steps`` steps on
16 images of 512^2, then times 6 refresh windows of steps at the
reached shapes (``Runner.train_step``, the host clock ending in a
synchronize, and the CUDA events' span beside it) and prints one JSON
line.  Runs on the card; without one it raises unless given ``--cpu``.
"""

from __future__ import annotations

import argparse
import json

CONFIGS = (
    ("padded", {}),
    # Factor 1 with M = R*S skips compaction (the same as padded).
    ("compact_f2", dict(compacted_batch=True, march_budget_factor=2)),
    ("compact_f4", dict(compacted_batch=True, march_budget_factor=4)),
    # Speed modes: the model tier on M = 2^17 or 2^16 kept samples.
    ("compact_m17_f2", dict(compacted_batch=131072, march_budget_factor=2)),
    ("compact_m17_f1", dict(compacted_batch=131072, march_budget_factor=1)),
    ("compact_m16_f1", dict(compacted_batch=65536, march_budget_factor=1)),
)


def time_window(runner, device, reps=6):
    """(host ms a step, device ms a step, R, S) over ``reps`` windows of
    steps at the runner's current shapes."""
    from jnerf_tpu_torch.tools.tool_util import timed

    freq = runner.sampler.update_den_freq

    def window():
        for _ in range(freq):
            runner.train_step()

    window()
    host, dev = timed(window, reps, device)
    return (host / freq, None if dev is None else dev / freq,
            runner.sampler.n_rays_per_batch, runner.sampler.n_samples_per_ray)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--encoder", default="f8l4")
    ap.add_argument("--steps", type=int, default=512,
                    help="training steps before timing, so that the grid "
                         "and the batch shape reach steady state")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--only", default="",
                    help="comma-separated config labels to run")
    args = ap.parse_args(argv)
    from jnerf_tpu_torch.tools.tool_util import ENCODERS, card, device_for

    device = device_for(args.cpu, "probe_compact")
    from jnerf_tpu_torch.runner import Runner
    from jnerf_tpu_torch.utils import bench_cfg

    configs = CONFIGS
    if args.only:
        names = set(args.only.split(","))
        configs = [c for c in CONFIGS if c[0] in names]
    on = card(device)
    out = []
    for label, knobs in configs:
        cfg = bench_cfg.ngp_synthetic_cfg(n_images=16, H=512, W=512,
                                          tot_train_steps=100000,
                                          **ENCODERS[args.encoder])
        for k, v in knobs.items():
            setattr(cfg, k, v)
        runner = Runner(device=device)
        float(runner.train_range(0, args.steps))
        host, dev, n_rays, n_samp = time_window(runner, device)
        line = {
            "config": label, "encoder": args.encoder,
            "ms_per_step": round(host, 3),
            "iters_per_s": round(1e3 / host, 2),
            "n_rays": n_rays, "n_samples": n_samp,
            "device_ms_per_step": None if dev is None else round(dev, 3),
            "card": on,
        }
        out.append(line)
        print(json.dumps(line), flush=True)
    return out


if __name__ == "__main__":
    main()

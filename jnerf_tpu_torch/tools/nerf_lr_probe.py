"""Vanilla NeRF's learning rate at full width: `projects/nerf/configs/
nerf_base.py` (8 x 256, frequency encodings of 10 and 4 octaves) trained at
each given learning rate on one blender-format scene that the port writes,
through the CLI's train task.

    python3 -m jnerf_tpu_torch.tools.nerf_lr_probe [--lr 1e-2 5e-4]
        [--steps 1024] [--hw 256] [--device cuda|cpu]

For each learning rate it prints one JSON line: the steps, steps/s (host
clock), the loss at each of the train task's plain lines (every 256
steps), the test PSNR and the PSNR of predicting the background
everywhere, with the card's name and power limit.  `chip_smoke.py`
phase 11 trains this config at 5e-4 rather than the config's 1e-2; this
is the measurement behind that choice (PERF.md §6).  A diagnostic: it
changes nothing in the config.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import textwrap
import time
from pathlib import Path

NERF_BASE = (Path(__file__).resolve().parents[2]
             / "projects" / "nerf" / "configs" / "nerf_base.py")


def probe(lr: float, steps: int, scene: str, tmp: str, device: str) -> dict:
    """Train nerf_base.py at ``lr`` for ``steps`` steps on ``scene`` and
    score its test set."""
    from jnerf_tpu_torch.runner import Runner
    from jnerf_tpu_torch.tools import run_net

    cfg = os.path.join(tmp, f"cfg_lr{lr:g}.py")
    Path(cfg).write_text(textwrap.dedent(f"""\
        _base_ = {str(NERF_BASE)!r}
        dataset_dir = {scene!r}
        dataset = dict(train=dict(root_dir=dataset_dir),
                       val=dict(root_dir=dataset_dir),
                       test=dict(root_dir=dataset_dir))
        log_dir = {os.path.join(tmp, f"logs_lr{lr:g}")!r}
        tot_train_steps = {steps}
        optim = dict(type="Adam", lr={lr!r}, eps=1e-15, betas=(0.9, 0.99))
    """))
    losses, train_s = [], [0.0]
    orig = Runner.train_range

    def train_range(self, *a, **k):
        t0 = time.perf_counter()
        loss = orig(self, *a, **k)
        losses.append(float(loss))  # waits for the device
        train_s[0] += time.perf_counter() - t0
        return loss

    Runner.train_range = train_range
    try:
        _, psnr = run_net.main(["--config-file", cfg, "--device", device,
                                "--task", "train"])
    finally:
        Runner.train_range = orig
    return {"lr": lr, "steps": steps, "steps_per_s": steps / train_s[0],
            "losses": losses, "test_psnr": psnr}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--lr", type=float, nargs="+", default=[1e-2, 5e-4])
    parser.add_argument("--steps", type=int, default=1024)
    parser.add_argument("--hw", type=int, default=256)
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)
    from jnerf_tpu_torch.dataset.synthetic import (
        background_psnr, make_synthetic_scene,
    )
    from jnerf_tpu_torch.tools.run_net import device_line

    card = device_line(args.device)
    with tempfile.TemporaryDirectory(prefix="nerf_lr_probe_") as tmp:
        scene = os.path.join(tmp, "scene")
        make_synthetic_scene(scene, n_train=24, n_val=2, n_test=4, H=args.hw,
                             W=args.hw, device=args.device)
        bg = background_psnr(scene, 4)
        for lr in args.lr:
            row = probe(lr, args.steps, scene, tmp, args.device)
            print(json.dumps(dict(row, background_psnr=bg, device=card)),
                  flush=True)


if __name__ == "__main__":
    main()

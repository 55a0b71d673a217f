"""Convergence ceiling of the small Plenoxels test config: the port's
counterpart of `tools/tiny_ceiling_svox2.py`.

    python3 -m jnerf_tpu_torch.tools.tiny_ceiling_svox2 [--iters 6000] \\
        [--eval-every 600] [--cpu] [--out logs/torch/tiny_ceiling_svox2.json]

Runs the config of the JAX package's Plenoxels end-to-end test
(`svox2_base.py` at a 48^3 grid, radius 1.4, 1024 rays a step, 192
samples a ray, over the analytic spheres at 64 x 64: 12 train, 2 val and
2 test views written to a temporary directory) far past the test's 600
iterations, reading the first test view's PSNR every ``--eval-every``
iterations, so that the test's bar can be a fraction of a measured
plateau.  Writes the trajectory and its best point, with the card's name
and power limit, to ``--out``, and prints the result without the
trajectory.  Runs on the card; without one it raises unless given
``--cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import textwrap
import time


def main(argv=None):
    from jnerf_tpu_torch.tools.tool_util import LOG_DIR, REPO

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=6000)
    ap.add_argument("--eval-every", type=int, default=600)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--out", default=str(LOG_DIR / "tiny_ceiling_svox2.json"))
    args = ap.parse_args(argv)
    from jnerf_tpu_torch.tools.tool_util import card, device_for, write_atomic

    device = device_for(args.cpu, "tiny_ceiling_svox2")
    from jnerf_tpu_torch.dataset.synthetic import make_synthetic_scene
    from jnerf_tpu_torch.runner.svox2_runner import Svox2Runner
    from jnerf_tpu_torch.utils.config import get_cfg, init_cfg

    base = REPO / "projects" / "svox2" / "configs" / "svox2_base.py"
    with tempfile.TemporaryDirectory(prefix="svox2_ceiling_") as tmp:
        scene = make_synthetic_scene(os.path.join(tmp, "spheres"), n_train=12,
                                     n_val=2, n_test=2, H=64, W=64,
                                     device=device)
        cfg_path = os.path.join(tmp, "svox2_ceiling.py")
        with open(cfg_path, "w") as f:
            f.write(textwrap.dedent(f"""
                _base_ = {str(base)!r}
                exp_name = "svox2_ceiling"
                log_dir = {os.path.join(tmp, 'logs')!r}
                dataset_dir = {scene!r}
                dataset = dict(
                    train=dict(root=dataset_dir, split='train'),
                    test=dict(root=dataset_dir, split='test'),
                )
                model = dict(reso=48, radius=1.4)
                reso_list = [[48]*3]
                batch_size = 1024
                n_iters = {args.iters}
                render_n_samples = 192
                lr_sigma_delay_steps = 0
                seed = 0
            """))
        get_cfg().clear()
        init_cfg(cfg_path)
        runner = Svox2Runner(device=device)

        t0 = time.perf_counter()
        trajectory = []
        i = 0
        while i < args.iters:
            runner.train(min(args.eval_every, args.iters - i))
            i += args.eval_every
            psnr = float(runner.eval_psnr(n_images=1))
            trajectory.append({"iters": i, "psnr": round(psnr, 3),
                               "elapsed_s": round(time.perf_counter() - t0,
                                                  1)})
            print(f"[svox2-ceiling] iters={i} psnr={psnr:.3f} "
                  f"({time.perf_counter() - t0:.0f}s)", flush=True)

    result = {
        "psnr_ceiling": max(t["psnr"] for t in trajectory),
        "test_point_iters": 600,
        "trajectory": trajectory,
        "scene": "synthetic-spheres-64 (test fixture config)",
        "backend": device.type,
        "card": card(device),
    }
    write_atomic(args.out, json.dumps(result, indent=1))
    print(json.dumps({k: v for k, v in result.items() if k != "trajectory"}),
          flush=True)
    return result


if __name__ == "__main__":
    main()

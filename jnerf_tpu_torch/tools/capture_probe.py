"""Train the real-capture configs on captures of two camera layouts each
and print what separates them: the test PSNR, the PSNR of predicting each
test frame's mean colour, and two training views' PSNR.

    python3 -m jnerf_tpu_torch.tools.capture_probe [--device cuda]

- ``ngp_fox.py`` (aabb_scale 4, cone-angle steps) on fox-layout captures
  (`dataset/synthetic.py::make_fox_capture`) at a quarter of the fox's
  size (270 x 480), for ``--fox-steps``: cameras 2 units from the spheres
  with a 1.2 rad view (the writer's default, as the fox's cameras sit)
  against 4 units with 0.69 rad in a room of radius 5.5;
- ``ngp_llff.py`` (aabb_scale 64) on LLFF-layout captures
  (`make_llff_capture`) at fern's 4032 x 3024, for ``--llff-steps``:
  cameras on an ellipse (the default) against a grid.

The configs run at full width through ``Runner`` (not the CLI); each
result is one JSON line.  The tests render with one fixed march jitter.
It runs on the card and refuses to run without one unless given
``--device cpu`` (there only with small ``--scale`` and steps).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import textwrap
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

VARIANTS = (
    ("fox near", "ngp_fox.py", {}),
    ("fox far", "ngp_fox.py", dict(radius=4.0, room=5.5,
                                   camera_angle_x=0.6911112070083618)),
    ("llff ellipse", "ngp_llff.py", dict(layout="ellipse")),
    ("llff grid", "ngp_llff.py", dict(layout="grid")),
)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--fox-steps", type=int, default=1536)
    ap.add_argument("--llff-steps", type=int, default=1024)
    ap.add_argument("--scale", type=int, default=1,
                    help="divide both captures' sizes (CPU smokes)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap.parse_args(argv)


def _psnr(mse: float) -> float:
    import math

    return -10.0 * math.log10(mse)


def mean_colour_psnr(ds) -> float:
    """Mean PSNR, over a split's (opaque) images, of predicting each
    image's mean colour everywhere."""
    out = []
    for i in range(ds.n_images):
        img = ds.image(i)[..., :3].astype("float64")
        out.append(_psnr(float(((img - img.mean(axis=(0, 1))) ** 2).mean())))
    return sum(out) / len(out)


def main(argv=None):
    args = parse_args(argv)
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("capture_probe needs an NVIDIA GPU (or --device "
                         "cpu): torch.cuda.is_available() is false")
    from jnerf_tpu_torch.dataset import synthetic
    from jnerf_tpu_torch.runner import Runner
    from jnerf_tpu_torch.utils.config import get_cfg, init_cfg

    dev = torch.device(args.device)
    tmp = tempfile.mkdtemp(prefix="capture_probe_")
    results = []
    try:
        for name, base, kw in VARIANTS:
            root = os.path.join(tmp, name.replace(" ", "_"))
            fox = base == "ngp_fox.py"
            steps = args.fox_steps if fox else args.llff_steps
            if fox:
                synthetic.make_fox_capture(root, H=270 // args.scale,
                                           W=480 // args.scale, device=dev,
                                           **kw)
            else:
                synthetic.make_llff_capture(root, H=3024 // args.scale,
                                            W=4032 // args.scale, device=dev,
                                            **kw)
            cfg = Path(tmp) / f"{name.replace(' ', '_')}.py"
            cfg.write_text(textwrap.dedent(f"""\
                _base_ = {str(REPO / 'projects/ngp/configs' / base)!r}
                dataset_dir = {root!r}
                dataset = dict(train=dict(root_dir=dataset_dir),
                               val=dict(root_dir=dataset_dir),
                               test=dict(root_dir=dataset_dir))
                log_dir = {os.path.join(tmp, 'logs')!r}
                tot_train_steps = {steps}
            """))
            init_cfg(str(cfg))
            runner = Runner(device=dev)
            u = torch.rand((runner.render_chunk_rays,), device=dev,
                           generator=torch.Generator(dev).manual_seed(0))
            runner.train_range(0, steps)
            mses = runner.render_test(save_img=False, u=u)
            train_views = []
            for i in range(2):
                img, _a, tar = runner.render_img("train", img_id=i, u=u)
                train_views.append(_psnr(float(((img - tar) ** 2).mean())))
            res = {"variant": name, "config": base, "steps": steps,
                   "test_psnr": sum(map(_psnr, mses)) / len(mses),
                   "mean_colour_psnr": mean_colour_psnr(
                       runner.dataset["test"]),
                   "train_view_psnr": train_views,
                   "size": [runner.W, runner.H],
                   "rays": runner.sampler.n_rays_per_batch}
            print(json.dumps(res), flush=True)
            results.append(res)
            del runner
            get_cfg().clear()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return results


if __name__ == "__main__":
    main()

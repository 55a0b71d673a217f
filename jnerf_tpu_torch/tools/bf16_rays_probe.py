"""The quality run (`ceiling_run`) with the ray directions computed as a
TPU computes them by default: both operands of the camera-to-world product
rounded to bf16, products summed in f32 (XLA's DEFAULT precision for an
f32 matmul on a TPU), in the training rays (`rays_from_pixels`, the JAX
package's ``einsum`` at `jnerf_tpu/dataset/dataset.py:84`) and in the
rendered ones (`rays_for_image`, `:105`).

    python3 -m jnerf_tpu_torch.tools.bf16_rays_probe <ceiling_run flags>

The JAX package's logged hard-scene trajectories were measured on a TPU;
this probe shows how much of their shape that rounding explains (PERF.md
§6).  Same flags and JSON as ``ceiling_run``; the default output name
ends in ``_bf16rays``.  A diagnostic: nothing else in the port rounds the
rays.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

from jnerf_tpu_torch.tools import ceiling_run


def _bf(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _unit(d: torch.Tensor) -> torch.Tensor:
    return d / torch.linalg.norm(d, dim=-1, keepdim=True)


def rays_from_pixels(pixel_index, transforms, focal_lengths, principal_points,
                     W, H):
    """`dataset.rays_from_pixels` with its einsum's operands in bf16."""
    hw = H * W
    img_id = pixel_index // hw
    off = pixel_index % hw
    x = ((off % W).to(torch.float32) + 0.5) / W
    y = ((off // W).to(torch.float32) + 0.5) / H
    xy = torch.stack([x, y], dim=-1)
    xf = transforms[img_id]
    res = torch.tensor([W, H], dtype=torch.float32, device=xy.device)
    d_cam = torch.cat([(xy - principal_points[img_id]) * res
                       / focal_lengths[img_id], torch.ones_like(x)[:, None]],
                      dim=-1)
    d_world = torch.einsum("bij,bj->bi", _bf(xf[:, :, :3]), _bf(d_cam))
    return img_id, xf[:, :, 3], _unit(d_world)


def rays_for_image(transform, focal_length, principal_point, W, H):
    """`dataset.rays_for_image` with its product's operands in bf16."""
    dev = transform.device
    ys = (torch.arange(H, dtype=torch.float32, device=dev) + 0.5) / H
    xs = (torch.arange(W, dtype=torch.float32, device=dev) + 0.5) / W
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    xy = torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1)
    res = torch.tensor([W, H], dtype=torch.float32, device=dev)
    d_cam = torch.cat([(xy - principal_point) * res / focal_length,
                       torch.ones((H * W, 1), device=dev)], dim=-1)
    d_world = _bf(d_cam) @ _bf(transform[:, :3]).T
    return transform[:, 3].expand(H * W, 3), _unit(d_world)


def main(argv=None):
    from jnerf_tpu_torch.dataset import procedural
    from jnerf_tpu_torch.runner import runner

    argv = list(sys.argv[1:] if argv is None else argv)
    if "--out" not in argv:
        name = ceiling_run.config_name(ceiling_run.parse_args(argv))
        argv += ["--out", str(Path(ceiling_run.REPO) / "logs" / "torch"
                              / f"ceiling_{name}_bf16rays.json")]
    saved = runner.rays_from_pixels, procedural.rays_for_image
    runner.rays_from_pixels = rays_from_pixels
    procedural.rays_for_image = rays_for_image
    try:
        return ceiling_run.main(argv)
    finally:
        runner.rays_from_pixels, procedural.rays_for_image = saved


if __name__ == "__main__":
    sys.exit(0 if main() else 1)

"""NGP mesh extraction: density field -> iso-surface -> coloured PLY.

    python -m jnerf_tpu_torch.tools.extract_mesh --config-file <cfg> \\
        [--resolution 512] [--device cuda|cpu]

Counterpart of `tools/extract_mesh.py`, with its flags plus ``--device``
(``cuda``, the default, refuses to run without a card).  The trained
runner is loaded from its checkpoint; the raw density head is sampled on
an N^3 grid over the unit cube, built on the device in x-slabs (kernel F
encodes every query); sigma is clamped at 0 and truncated to an integer,
as the reference does, and the sigma > 0.5 surface is extracted, its x
and y swapped, and written as ``mesh-origin.ply``.  The largest connected
component is then coloured by rendering, with the render chunk (kernel F
again), a ray from ``vertex - 0.2 * normal`` along each vertex normal, and
written as ``mesh-color.ply``, both under the run's save path.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from jnerf_tpu_torch.ops.marching import (
    QUERY_ROWS,
    largest_component,
    marching_tetrahedra,
    write_ply,
)


def vertex_normals(vertices, triangles):
    """Area-weighted average of incident face normals (numpy [V, 3])."""
    v = np.asarray(vertices)
    t = np.asarray(triangles)
    fn = np.cross(v[t[:, 1]] - v[t[:, 0]], v[t[:, 2]] - v[t[:, 0]])
    normals = np.zeros_like(v)
    for k in range(3):
        np.add.at(normals, t[:, k], fn)
    norm = np.linalg.norm(normals, axis=-1, keepdims=True)
    return normals / np.maximum(norm, 1e-12)


@torch.no_grad()
def density_grid(model, resolution: int, device) -> np.ndarray:
    """The integer-truncated, non-negative raw density on the N^3 grid over
    the unit cube (numpy's f32 linspace on each axis), as numpy f32
    [N, N, N] (`tools/extract_mesh.py:58-72`)."""
    n = resolution
    lin = torch.from_numpy(np.linspace(0, 1, n, dtype=np.float32)).to(device)
    sigma = torch.empty((n, n, n), dtype=torch.float32)
    rows = max(1, QUERY_ROWS // (n * n))
    for x0 in range(0, n, rows):
        gx, gy, gz = torch.meshgrid(lin[x0:x0 + rows], lin, lin, indexing="ij")
        pts = torch.stack([gx.reshape(-1), gy.reshape(-1), gz.reshape(-1)], -1)
        raw = model.density(pts)[:, 0]
        slab = torch.clamp(raw, min=0).to(torch.int32).to(torch.float32)
        sigma[x0:x0 + rows] = slab.reshape(-1, n, n).cpu()
    return sigma.numpy()


def vertex_colors(runner, vertices, normals, u=None) -> np.ndarray:
    """Render a ray from ``vertex - 0.2 * normal`` along the normal for each
    vertex (sampler space: x and y swapped back, scaled by the aabb)
    with the runner's render chunk; returns rgb [V, 3] over the run's
    background (`tools/extract_mesh.py:91-110`).  ``u`` [chunk] is the
    march jitter of every chunk."""
    aabb_scale = runner.dataset["train"].aabb_scale
    v_s = vertices[:, [1, 0, 2]]
    n_s = normals[:, [1, 0, 2]]
    rays_o = (v_s - n_s * 0.2 - 0.5) * aabb_scale + 0.5
    dev = runner.device
    rgb, alpha = runner._render_rays_chunked(
        torch.from_numpy(np.ascontiguousarray(rays_o, np.float32)).to(dev),
        torch.from_numpy(np.ascontiguousarray(n_s, np.float32)).to(dev),
        len(vertices), 1, u=u)
    bg = runner.background_color.numpy()
    return rgb[:, 0] + bg * (1 - alpha[:, 0])


def extract_mesh(runner, resolution: int, u=None):
    """Write ``mesh-origin.ply`` and ``mesh-color.ply`` of a trained NGP
    runner under its save path; returns their paths.  ``u`` [chunk]: the
    colour render's march jitter, drawn from the runner's generator
    unless given."""
    mesh_dir = runner.save_path
    os.makedirs(mesh_dir, exist_ok=True)
    sigma = density_grid(runner.model, resolution, runner.device)
    vertices, triangles = marching_tetrahedra(sigma, 0.5)
    vertices = vertices / resolution
    # The reference swaps x and y after extraction (`extract_mesh.py:80-85`).
    vertices = vertices[:, [1, 0, 2]]
    origin = write_ply(os.path.join(mesh_dir, "mesh-origin.ply"), vertices,
                       triangles)
    print("mesh origin generated mesh-origin.ply", flush=True)

    vertices, triangles = largest_component(vertices, triangles)
    normals = vertex_normals(vertices, triangles)
    colors = vertex_colors(runner, vertices, normals, u=u)
    color = write_ply(os.path.join(mesh_dir, "mesh-color.ply"), vertices,
                      triangles, colors)
    print("mesh color generated mesh-color.ply", flush=True)
    return origin, color


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--config-file", default="", metavar="FILE", type=str)
    parser.add_argument("--resolution", type=int, default=512)
    parser.add_argument("--mcube_smooth", type=bool, default=False)
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="cuda (the default) or cpu")
    return parser.parse_args(argv)


def mesh(argv=None):
    """The tool's entry point; returns the two PLYs' paths."""
    args = parse_args(argv)
    from jnerf_tpu_torch.runner import Runner
    from jnerf_tpu_torch.tools.run_net import device_line
    from jnerf_tpu_torch.utils.config import init_cfg

    print(device_line(args.device), flush=True)
    if args.config_file:
        init_cfg(args.config_file)
    runner = Runner(device=args.device)
    runner.load_ckpt(runner.ckpt_path)
    return extract_mesh(runner, args.resolution)


if __name__ == "__main__":
    mesh()

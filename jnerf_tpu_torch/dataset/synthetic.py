"""Procedural blender-style test scenes: the plain spheres and the "hard"
quality scene (textured spheres, a thin helix and a tilted ring).

The analytic renderer of `jnerf_tpu/dataset/synthetic.py`, copied so that
the port builds its datasets without importing the JAX package.  The
scene definitions stay numpy; the ray tracing is float64 tensor code on
the caller's device, with every sum written out in the order numpy takes
it, so that on the CPU the plain scene's images equal the JAX package's bit
for bit and the hard scene's within float64 rounding.
``make_synthetic_scene`` writes the plain scene to disk in blender format
(jsons and PNGs), as the JAX package's writer does; the NeuS scene writer
is not ported.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from .dataset_util import write_image

# Scene definition in NeRF world space (cameras orbit at radius ~4).
# Spheres: (center xyz, radius, rgb color)
_SPHERES = [
    (np.array([0.0, 0.0, 0.0]), 0.55, np.array([0.85, 0.3, 0.25])),
    (np.array([0.6, 0.35, 0.3]), 0.3, np.array([0.25, 0.7, 0.35])),
    (np.array([-0.5, -0.2, 0.45]), 0.25, np.array([0.3, 0.4, 0.9])),
    (np.array([0.1, -0.55, -0.35]), 0.28, np.array([0.9, 0.8, 0.3])),
]
_LIGHT_DIR = np.array([0.5, 0.6, 0.62])


def _hard_scene():
    """Object list of the "hard" quality scene: 4 large spheres with a
    smooth single-frequency albedo texture, a helix of 72 spheres of radius
    0.035 around the main one and a tilted ring of 28 spheres of radius
    0.045 (thin structure that stresses the occupancy grid).

    Returns (centers [K,3], radii [K], colors [K,3], tex_freq [K],
    tex_phase [K,3]); tex_freq 0 disables texturing for an object.
    """
    centers, radii, colors, freqs, phases = [], [], [], [], []

    def add(c, r, col, f=0.0, ph=(0.0, 0.0, 0.0)):
        centers.append(c)
        radii.append(r)
        colors.append(col)
        freqs.append(f)
        phases.append(ph)

    add([0.0, 0.0, -0.05], 0.52, [0.85, 0.45, 0.35], 22.0, (0.3, 1.7, 0.9))
    add([0.62, 0.3, 0.28], 0.27, [0.3, 0.75, 0.45], 34.0, (2.1, 0.4, 1.2))
    add([-0.55, -0.25, 0.4], 0.24, [0.35, 0.45, 0.9], 27.0, (1.0, 2.6, 0.2))
    add([0.05, -0.6, -0.3], 0.22, [0.9, 0.85, 0.4], 40.0, (0.6, 1.1, 2.8))

    n_h = 72
    for i in range(n_h):
        t = 4.0 * np.pi * i / n_h
        centers.append([0.78 * np.cos(t), 0.78 * np.sin(t),
                        -0.5 + 1.0 * i / n_h])
        radii.append(0.035)
        hue = i / n_h
        colors.append([0.75 + 0.25 * np.cos(2 * np.pi * hue),
                       0.55 + 0.35 * np.sin(2 * np.pi * hue),
                       0.85 - 0.45 * hue])
        freqs.append(0.0)
        phases.append((0.0, 0.0, 0.0))

    n_r = 28
    tilt = np.radians(35.0)
    for i in range(n_r):
        t = 2.0 * np.pi * i / n_r
        x, y = 0.95 * np.cos(t), 0.95 * np.sin(t)
        centers.append([x, y * np.cos(tilt), y * np.sin(tilt)])
        radii.append(0.045)
        colors.append([0.4 + 0.5 * (i % 2), 0.55, 0.9 - 0.5 * (i % 2)])
        freqs.append(0.0)
        phases.append((0.0, 0.0, 0.0))

    return (np.asarray(centers, np.float64), np.asarray(radii, np.float64),
            np.asarray(colors, np.float64), np.asarray(freqs, np.float64),
            np.asarray(phases, np.float64))


def _look_at_pose(eye: np.ndarray) -> np.ndarray:
    """Camera-to-world [3,4]; -z looks from eye at the origin (OpenGL/blender)."""
    fwd = -eye / np.linalg.norm(eye)  # viewing direction
    up = np.array([0.0, 0.0, 1.0])
    right = np.cross(fwd, up)
    right = right / np.linalg.norm(right)
    true_up = np.cross(right, fwd)
    # Blender convention: columns are [right, up, -view_dir], translation eye.
    m = np.stack([right, true_up, -fwd, eye], axis=1)
    return m.astype(np.float32)


def _scene_arrays(scene: str):
    if scene == "hard":
        return _hard_scene()
    if scene != "spheres":
        raise ValueError(f"unknown scene {scene!r}: 'spheres' or 'hard'")
    centers = np.asarray([s[0] for s in _SPHERES], np.float64)
    radii = np.asarray([s[1] for s in _SPHERES], np.float64)
    colors = np.asarray([s[2] for s in _SPHERES], np.float64)
    k = len(_SPHERES)
    return centers, radii, colors, np.zeros(k), np.zeros((k, 3))


def _dot3(v: torch.Tensor, w) -> torch.Tensor:
    """sum_i v[..., i] * w_i over the last axis of 3, in numpy's order
    ((v0 w0 + v1 w1) + v2 w2); w is a tensor [..., 3] or 3 floats."""
    w = w.unbind(-1) if torch.is_tensor(w) else [float(x) for x in w]
    return v[..., 0] * w[0] + v[..., 1] * w[1] + v[..., 2] * w[2]


def _trace(origin, dirs, centers, radii, colors, freqs, phases):
    """Nearest-hit shade of rays from one camera against textured spheres.

    origin: numpy [3] float64; dirs: float64 tensor [N, 3]; returns (rgb
    [N, 3] float64, hit [N] bool) on dirs' device.  Texture: a smooth
    per-object albedo modulation 0.6 + 0.4 * sin(f px + ph0 + 2.1 pz) *
    sin(f py + ph1 - 1.3 pz), one frequency per object, so a converged
    NeRF can represent it exactly.
    """
    dev, f64 = dirs.device, torch.float64
    light = _LIGHT_DIR / np.linalg.norm(_LIGHT_DIR)
    n = dirs.shape[0]
    best_t = torch.full((n,), float("inf"), dtype=f64, device=dev)
    rgb = torch.zeros((n, 3), dtype=f64, device=dev)
    hit = torch.zeros((n,), dtype=torch.bool, device=dev)
    origin_t = torch.as_tensor(origin, dtype=f64, device=dev)
    for k in range(len(radii)):
        center, radius = centers[k], float(radii[k])
        oc = [float(v) for v in origin - center]  # the same for every ray
        b = _dot3(dirs, oc)
        c = oc[0] * oc[0] + oc[1] * oc[1] + oc[2] * oc[2] - radius * radius
        disc = b * b - c
        valid = disc > 0
        t_hit = -b - torch.sqrt(torch.where(valid, disc, 0.0))
        valid &= (t_hit > 0) & (t_hit < best_t)
        p = origin_t + t_hit[:, None] * dirs
        nrm = (p - torch.as_tensor(center, dtype=f64, device=dev)) / radius
        shade = 0.35 + 0.65 * torch.clamp(_dot3(nrm, light), 0, 1)
        albedo = torch.as_tensor(colors[k], dtype=f64, device=dev)
        if freqs[k] > 0:
            f, ph = float(freqs[k]), [float(v) for v in phases[k]]
            mod = 0.6 + 0.4 * (
                torch.sin(f * p[:, 0] + ph[0] + 2.1 * p[:, 2])
                * torch.sin(f * p[:, 1] + ph[1] - 1.3 * p[:, 2]))
            albedo = albedo * mod[:, None]
        rgb = torch.where(valid[:, None], albedo * shade[:, None], rgb)
        best_t = torch.where(valid, t_hit, best_t)
        hit |= valid
    return rgb, hit


def render_analytic(pose: np.ndarray, H: int, W: int,
                    camera_angle_x: float, scene: str = "spheres",
                    ssaa: int = 1, device=None) -> torch.Tensor:
    """Ray-trace a scene for one camera; returns RGBA float32 [H, W, 4] on
    ``device``.

    ssaa > 1 traces ssaa * ssaa subpixel rays per pixel and box-filters in
    premultiplied space (as the trainer composites rgb * a + bg * (1 - a)),
    then un-premultiplies: the soft edges a volume renderer produces.
    """
    f64 = torch.float64
    Hs, Ws = H * ssaa, W * ssaa
    focal = float(0.5 * Ws / np.tan(0.5 * camera_angle_x))
    xs = torch.arange(Ws, dtype=f64, device=device)
    ys = torch.arange(Hs, dtype=f64, device=device)
    dirs_cam = torch.stack([
        ((xs + 0.5 - Ws / 2) / focal).expand(Hs, Ws),
        (-(ys + 0.5 - Hs / 2) / focal)[:, None].expand(Hs, Ws),
        torch.full((Hs, Ws), -1.0, dtype=f64, device=device),
    ], dim=-1)
    pose = np.asarray(pose, np.float64)
    R = torch.as_tensor(pose[:, :3], device=device)
    dirs = dirs_cam @ R.T
    dirs = dirs / torch.sqrt(_dot3(dirs, dirs))[..., None]

    rgb, hit = _trace(pose[:, 3], dirs.reshape(-1, 3), *_scene_arrays(scene))
    rgb, alpha = rgb.reshape(Hs, Ws, 3), hit.to(f64).reshape(Hs, Ws)
    if ssaa > 1:
        premul = rgb * alpha[..., None]
        premul = premul.reshape(H, ssaa, W, ssaa, 3).mean(dim=(1, 3))
        alpha = alpha.reshape(H, ssaa, W, ssaa).mean(dim=(1, 3))
        rgb = premul / torch.clamp(alpha[..., None], min=1e-8)
    return torch.cat([rgb, alpha[..., None]], dim=-1).float()


def make_synthetic_scene(
    out_dir: str,
    n_train: int = 24,
    n_val: int = 2,
    n_test: int = 4,
    H: int = 128,
    W: int = 128,
    camera_angle_x: float = 0.6911112070083618,
    seed: int = 0,
    device=None,
) -> str:
    """Write the plain scene to disk in blender format (the JAX package's
    cameras for the same seed, images traced on ``device``); returns
    out_dir."""
    rng = np.random.default_rng(seed)
    os.makedirs(out_dir, exist_ok=True)

    def make_split(name, n, offset):
        frames = []
        os.makedirs(os.path.join(out_dir, name), exist_ok=True)
        for i in range(n):
            # Quasi-uniform orbit with jitter, elevation in [-25, 55] deg.
            theta = 2 * np.pi * (i / n + offset) + rng.uniform(-0.05, 0.05)
            phi = np.radians(rng.uniform(-25, 55))
            eye = 4.0 * np.array(
                [np.cos(theta) * np.cos(phi), np.sin(theta) * np.cos(phi), np.sin(phi)]
            )
            pose = _look_at_pose(eye)
            img = render_analytic(pose, H, W, camera_angle_x, device=device)
            rel = f"{name}/r_{i}.png"
            write_image(os.path.join(out_dir, rel), img.cpu().numpy())
            pose4 = np.concatenate([pose, [[0, 0, 0, 1]]], axis=0)
            frames.append(
                {"file_path": rel[: -len(".png")], "transform_matrix": pose4.tolist()}
            )
        with open(os.path.join(out_dir, f"transforms_{name}.json"), "w") as f:
            json.dump(
                {"camera_angle_x": camera_angle_x, "aabb_scale": 1, "frames": frames},
                f,
            )

    make_split("train", n_train, 0.0)
    make_split("val", n_val, 0.37)
    make_split("test", n_test, 0.11)
    return out_dir

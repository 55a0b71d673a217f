"""Procedural blender-style test scene: opaque coloured spheres.

The analytic renderer of `jnerf_tpu/dataset/synthetic.py` (``spheres``
scene), copied so that the port builds its dataset without importing the
JAX package.  The textured ``hard`` scene, supersampling and the on-disk
scene writers are not ported yet.
"""

from __future__ import annotations

import numpy as np

# Scene definition in NeRF world space (cameras orbit at radius ~4).
# Spheres: (center xyz, radius, rgb color)
_SPHERES = [
    (np.array([0.0, 0.0, 0.0]), 0.55, np.array([0.85, 0.3, 0.25])),
    (np.array([0.6, 0.35, 0.3]), 0.3, np.array([0.25, 0.7, 0.35])),
    (np.array([-0.5, -0.2, 0.45]), 0.25, np.array([0.3, 0.4, 0.9])),
    (np.array([0.1, -0.55, -0.35]), 0.28, np.array([0.9, 0.8, 0.3])),
]
_LIGHT_DIR = np.array([0.5, 0.6, 0.62])


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


def _trace(origin, dirs):
    """Nearest-hit shade of rays against the spheres.

    origin/dirs: [..., 3]; returns (rgb [..., 3], hit [...] bool).
    """
    light = _LIGHT_DIR / np.linalg.norm(_LIGHT_DIR)
    best_t = np.full(origin.shape[:-1], np.inf)
    rgb = np.zeros(origin.shape[:-1] + (3,))
    hit = np.zeros(origin.shape[:-1], bool)
    for center, radius, color in _SPHERES:
        oc = origin - center
        b = np.sum(oc * dirs, axis=-1)
        c = np.sum(oc * oc, axis=-1) - radius * radius
        disc = b * b - c
        valid = disc > 0
        t_hit = -b - np.sqrt(np.where(valid, disc, 0.0))
        valid &= (t_hit > 0) & (t_hit < best_t)
        if not valid.any():
            continue
        p = origin + t_hit[..., None] * dirs
        n = (p - center) / radius
        shade = 0.35 + 0.65 * np.clip(np.sum(n * light, axis=-1), 0, 1)
        albedo = np.asarray(color, np.float64)[None] * np.ones_like(p)
        rgb = np.where(valid[..., None], albedo * shade[..., None], rgb)
        best_t = np.where(valid, t_hit, best_t)
        hit |= valid
    return rgb, hit


def render_analytic(pose: np.ndarray, H: int, W: int,
                    camera_angle_x: float) -> np.ndarray:
    """Ray-trace the spheres for one camera; returns RGBA float [H,W,4]."""
    focal = 0.5 * W / np.tan(0.5 * camera_angle_x)
    ys, xs = np.mgrid[0:H, 0:W]
    dirs_cam = np.stack(
        [
            (xs + 0.5 - W / 2) / focal,
            -(ys + 0.5 - H / 2) / focal,
            -np.ones_like(xs, dtype=np.float64),
        ],
        axis=-1,
    )
    R, t = pose[:, :3], pose[:, 3]
    dirs = dirs_cam @ R.T
    dirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    origin = np.broadcast_to(t, dirs.shape)

    rgb, hit = _trace(origin, dirs)
    alpha = hit.astype(np.float64)
    rgba = np.concatenate([rgb, alpha[..., None]], axis=-1)
    return rgba.astype(np.float32)

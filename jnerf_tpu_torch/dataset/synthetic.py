"""Procedural blender-style test scenes: the plain spheres and the "hard"
quality scene (textured spheres, a thin helix and a tilted ring).

The analytic renderer of `jnerf_tpu/dataset/synthetic.py`, copied so that
the port builds its datasets without importing the JAX package.  The
scene definitions stay numpy; the ray tracing is float64 tensor code on
the caller's device, with every sum written out in the order numpy takes
it, so that on the CPU the plain scene's images equal the JAX package's bit
for bit and the hard scene's within float64 rounding.
``make_synthetic_scene`` writes the plain scene to disk in blender format
(jsons and PNGs), as the JAX package's writer does; ``make_fox_capture``
and ``make_llff_capture`` write it, inside a room with patterned walls,
as the real captures' layouts hold them (opaque JPEG photographs, with
the fox's COLMAP json keys or LLFF's ``poses_bounds.npy``), for the
real-capture configs.
``make_synthetic_neus_scene`` writes the NeuS test object (two spheres
inside the unit sphere) in DTU format, traced in numpy as the JAX package
traces it; ``neus_sdf`` is its analytic SDF.
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


def background_psnr(scene_dir: str, n_test: int) -> float:
    """Mean PSNR, over the first ``n_test`` test images of a blender-format
    scene, of predicting a black background everywhere (the images'
    colours composited over black): the floor a trained field must
    clear."""
    from .dataset_util import read_image

    out = []
    for i in range(n_test):
        img = read_image(os.path.join(scene_dir, "test", f"r_{i}.png"))
        mse = float(((img[..., :3] * img[..., 3:]) ** 2).mean())
        out.append(-10.0 * np.log10(mse))
    return float(np.mean(out))


# ----------------------------------------------------------- real captures
def _photo(pose, H, W, camera_angle_x, device, room):
    """The spheres in a room, float [H, W, 3] on the host: the room is a
    sphere of radius ``room`` around them, seen from inside, whose wall
    carries a smooth colour pattern, so that the photographs are opaque
    and every view sees geometry at a finite depth."""
    rgba = render_analytic(pose, H, W, camera_angle_x, device=device)
    f64 = torch.float64
    dev = rgba.device
    focal = float(0.5 * W / np.tan(0.5 * camera_angle_x))
    xs = (torch.arange(W, dtype=f64, device=dev) + 0.5 - W / 2) / focal
    ys = -(torch.arange(H, dtype=f64, device=dev) + 0.5 - H / 2) / focal
    dirs = torch.stack([xs.expand(H, W), ys[:, None].expand(H, W),
                        torch.full((H, W), -1.0, dtype=f64, device=dev)], -1)
    dirs = dirs @ torch.as_tensor(np.asarray(pose, np.float64)[:, :3].T,
                                  device=dev)
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    eye = torch.as_tensor(np.asarray(pose, np.float64)[:, 3], device=dev)
    # The far root of |eye + t d| = R from inside the room.
    b = dirs @ eye
    t = -b + torch.sqrt(b * b - (eye @ eye - room ** 2))
    p = eye + t[..., None] * dirs
    wall = torch.stack([
        0.5 + 0.22 * torch.sin(0.9 * p[..., 0] + 0.3) * torch.cos(0.7 * p[..., 1]),
        0.45 + 0.2 * torch.sin(0.8 * p[..., 1] - 0.5) * torch.cos(0.6 * p[..., 2]),
        0.4 + 0.2 * torch.sin(0.7 * p[..., 2] + 1.1) * torch.cos(0.9 * p[..., 0]),
    ], -1)
    rgb = rgba[..., :3] * rgba[..., 3:] + wall.float() * (1 - rgba[..., 3:])
    return rgb.cpu().numpy()


def make_fox_capture(out_dir: str, n_train: int = 50, n_test: int = 2,
                     H: int = 1080, W: int = 1920, seed: int = 0,
                     device=None, radius: float = 2.0, room: float = 3.0,
                     camera_angle_x: float = 1.2) -> str:
    """Write the plain scene, in a room of radius ``room``, as a capture in
    the fox's layout: opaque photographs ``images/0001.jpg``, ... (JPEG at
    quality 95, through `dataset_util.write_image`), and
    ``transforms_train.json`` / ``transforms_test.json`` with the keys of
    a COLMAP export: ``fl_x``, ``fl_y``, ``cx``, ``cy``, ``w``, ``h``,
    distortion ``k1``, ``k2``, ``p1``, ``p2`` (nonzero; the loaders carry
    them and do not apply them) and ``aabb_scale`` 4.  The cameras orbit
    ``radius`` out with the jitter of make_synthetic_scene; by default
    close to the spheres with a wide field of view, as the fox's are (its
    fl_x of ~1375 px at 1920 is ~1.2 rad): from 4 units away the trainer's
    march, at most 256 samples a ray in cone-angle steps, reaches no
    surface through the initial grid, and the field overfits the training
    views (`tools/capture_probe.py`, PERF.md §6).  Returns out_dir."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(out_dir, "images"), exist_ok=True)
    focal = float(0.5 * W / np.tan(0.5 * camera_angle_x))
    head = {"fl_x": focal, "fl_y": focal, "cx": W / 2, "cy": H / 2, "w": W,
            "h": H, "k1": 0.0125, "k2": -0.0041, "p1": 0.0007, "p2": -0.0003,
            "aabb_scale": 4}
    number = 0
    for split, n, offset in (("train", n_train, 0.0), ("test", n_test, 0.11)):
        frames = []
        for i in range(n):
            theta = 2 * np.pi * (i / n + offset) + rng.uniform(-0.05, 0.05)
            phi = np.radians(rng.uniform(-25, 55))
            eye = radius * np.array([np.cos(theta) * np.cos(phi),
                                     np.sin(theta) * np.cos(phi), np.sin(phi)])
            pose = _look_at_pose(eye)
            number += 1
            rel = f"images/{number:04d}.jpg"
            write_image(os.path.join(out_dir, rel),
                        _photo(pose, H, W, camera_angle_x, device, room),
                        quality=95)
            pose4 = np.concatenate([pose, [[0, 0, 0, 1]]], axis=0)
            frames.append({"file_path": rel, "transform_matrix": pose4.tolist()})
        with open(os.path.join(out_dir, f"transforms_{split}.json"), "w") as f:
            json.dump(dict(head, frames=frames), f)
    return out_dir


def make_llff_capture(out_dir: str, n_views: int = 20, H: int = 3024,
                      W: int = 4032, seed: int = 0, device=None,
                      layout: str = "ellipse") -> str:
    """Write the plain scene, in a room of radius 5.5, as a
    forward-facing capture in the LLFF layout: ``images/IMG_0000.JPG``,
    ... (JPEG at quality 95; no ``images_{factor}/``, so the loader
    minifies the JPEGs) and ``poses_bounds.npy`` ([down, right, back]
    rotation, position, and [H, W, focal] per view, then the near and far
    scene depths, by which the loader scales the poses).  The cameras sit
    4 units in front of the spheres, all looking at the origin with a 1.1
    rad field of view: on an ellipse (1.2 x 0.8 units), in order around
    it as a hand-held sweep takes them, so that every llffhold-th view
    lies between two training views; or, ``layout="grid"``, row by row on
    a 1.2 x 0.8 grid, whose held-out views fall on its corners and edges
    (`tools/capture_probe.py`).  The bounds are the scene's own depths
    from there (the big sphere's front at ~3.4, the wall behind at ~9.5),
    as a capture's are.  Returns out_dir."""
    if layout not in ("ellipse", "grid"):
        raise ValueError(f"layout {layout!r}: 'ellipse' or 'grid'")
    distance, room, camera_angle_x, bounds = 4.0, 5.5, 1.1, (3.3, 9.5)
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(out_dir, "images"), exist_ok=True)
    focal = float(0.5 * W / np.tan(0.5 * camera_angle_x))
    cols = int(np.ceil(np.sqrt(n_views)))
    rows = []
    for i in range(n_views):
        if layout == "ellipse":
            theta = 2 * np.pi * i / n_views
            u, v = 0.5 * np.cos(theta), 0.5 * np.sin(theta)
        else:
            u = (i % cols) / max(cols - 1, 1) - 0.5
            v = (i // cols) / max((n_views - 1) // cols, 1) - 0.5
        eye = np.array([distance, 1.2 * u, 0.8 * v]) \
            + rng.uniform(-0.03, 0.03, 3)
        pose = _look_at_pose(eye)  # columns: right, up, back, eye
        write_image(os.path.join(out_dir, "images", f"IMG_{i:04d}.JPG"),
                    _photo(pose, H, W, camera_angle_x, device, room),
                    quality=95)
        llff = np.stack([-pose[:, 1], pose[:, 0], pose[:, 2], pose[:, 3],
                         np.array([H, W, focal], np.float32)], axis=1)
        rows.append(np.concatenate([llff.reshape(-1), bounds]))
    np.save(os.path.join(out_dir, "poses_bounds.npy"),
            np.asarray(rows, np.float64))
    return out_dir


# --------------------------------------------------------------------- NeuS
_NEUS_SPHERES = [
    (np.array([0.0, 0.0, -0.1]), 0.45, np.array([0.8, 0.45, 0.3])),
    (np.array([0.0, 0.0, 0.42]), 0.22, np.array([0.35, 0.55, 0.8])),
]


def neus_sdf(pts: np.ndarray) -> np.ndarray:
    """Analytic SDF of the NeuS test scene (union of spheres); for tests."""
    d = np.full(pts.shape[:-1], np.inf)
    for center, radius, _ in _NEUS_SPHERES:
        d = np.minimum(d, np.linalg.norm(pts - center, axis=-1) - radius)
    return d


def make_synthetic_neus_scene(out_dir: str, n_images: int = 12, H: int = 96,
                              W: int = 96, seed: int = 0) -> str:
    """Write a DTU-format scene (cameras_sphere.npz + image/ + mask/ PNGs,
    through the port's PNG codec) of an analytic two-sphere object inside
    the unit sphere: the JAX package's cameras and images for the same
    arguments; returns out_dir."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(out_dir, "image"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "mask"), exist_ok=True)

    focal = 1.2 * max(H, W)
    K = np.array(
        [[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]], np.float64
    )
    light = _LIGHT_DIR / np.linalg.norm(_LIGHT_DIR)
    cams = {}
    for i in range(n_images):
        theta = 2 * np.pi * i / n_images + rng.uniform(-0.05, 0.05)
        phi = np.radians(rng.uniform(-10, 45))
        eye = 3.0 * np.array(
            [np.cos(theta) * np.cos(phi), np.sin(theta) * np.cos(phi), np.sin(phi)]
        )
        # Camera looks at origin; +z camera axis = viewing direction (OpenCV).
        fwd = -eye / np.linalg.norm(eye)
        up = np.array([0.0, 0.0, 1.0])
        right = np.cross(fwd, up)
        right /= np.linalg.norm(right)
        dn = np.cross(fwd, right)
        R_w2c = np.stack([right, dn, fwd], axis=0)  # rows
        t = -R_w2c @ eye
        world_mat = np.eye(4)
        world_mat[:3, :] = K @ np.concatenate([R_w2c, t[:, None]], axis=1)
        cams[f"world_mat_{i}"] = world_mat.astype(np.float32)
        cams[f"scale_mat_{i}"] = np.eye(4, dtype=np.float32)

        # Ray-trace the spheres through the OpenCV camera.
        ys, xs = np.mgrid[0:H, 0:W]
        d_cam = np.stack(
            [(xs + 0.5 - W / 2) / focal, (ys + 0.5 - H / 2) / focal,
             np.ones_like(xs, np.float64)], axis=-1,
        )
        dirs = d_cam @ np.stack([right, dn, fwd], axis=0)
        dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
        origin = np.broadcast_to(eye, dirs.shape)
        best_t = np.full((H, W), np.inf)
        rgb = np.full((H, W, 3), 0.05)
        hit = np.zeros((H, W), bool)
        for center, radius, color in _NEUS_SPHERES:
            oc = origin - center
            b = np.sum(oc * dirs, axis=-1)
            c = np.sum(oc * oc, axis=-1) - radius * radius
            disc = b * b - c
            valid = disc > 0
            t_hit = -b - np.sqrt(np.where(valid, disc, 0.0))
            valid &= (t_hit > 0) & (t_hit < best_t)
            p = origin + t_hit[..., None] * dirs
            nrm = (p - center) / radius
            shade = 0.35 + 0.65 * np.clip(np.sum(nrm * light, axis=-1), 0, 1)
            rgb = np.where(valid[..., None], color * shade[..., None], rgb)
            best_t = np.where(valid, t_hit, best_t)
            hit |= valid
        write_image(os.path.join(out_dir, "image", f"{i:03d}.png"),
                    rgb.astype(np.float32))
        write_image(os.path.join(out_dir, "mask", f"{i:03d}.png"),
                    np.repeat(hit[..., None].astype(np.float32), 3, axis=-1))
    np.savez(os.path.join(out_dir, "cameras_sphere.npz"), **cams)
    return out_dir

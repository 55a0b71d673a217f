"""The benchmark's scene: the procedural "hard" scene, frozen.

A plain copy of the hard scene's analytic ray tracer (textured spheres, a
thin helix of 72 small spheres and a tilted ring of 28), kept here so that
a change to the program's own scene generator cannot move the inputs.  It
is written once per checkout in Blender format: ``transforms_train.json``
with the training images as 8-bit RGBA PNGs, and ``transforms_test.json``
with the test poses alone (the render cell renders them; no test image is
compared).  Cameras lie on the upper hemisphere at radius 4 and look at the
origin, as the Blender lego split's do: the training views spread over the
hemisphere, the test views on an orbit at 30 degrees of elevation.

The scene does not depend on the run's seed.  ``read_png`` reads back the
files ``write_png`` writes (filter type 0), so that the reference reads the
same bytes as the program without the program's decoder.
"""

from __future__ import annotations

import json
import os
import shutil
import struct
import zlib

import numpy as np
import torch

LIGHT_DIR = np.array([0.5, 0.6, 0.62])
RADIUS = 4.0
TEST_ELEVATION_DEG = 30.0


def hard_scene():
    """(centers [K,3], radii [K], colors [K,3], tex_freq [K], tex_phase
    [K,3]) of the hard scene; tex_freq 0 means an untextured object."""
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
        hue = i / n_h
        add([0.78 * np.cos(t), 0.78 * np.sin(t), -0.5 + 1.0 * i / n_h], 0.035,
            [0.75 + 0.25 * np.cos(2 * np.pi * hue),
             0.55 + 0.35 * np.sin(2 * np.pi * hue), 0.85 - 0.45 * hue])
    n_r = 28
    tilt = np.radians(35.0)
    for i in range(n_r):
        t = 2.0 * np.pi * i / n_r
        x, y = 0.95 * np.cos(t), 0.95 * np.sin(t)
        add([x, y * np.cos(tilt), y * np.sin(tilt)], 0.045,
            [0.4 + 0.5 * (i % 2), 0.55, 0.9 - 0.5 * (i % 2)])
    return tuple(np.asarray(a, np.float64)
                 for a in (centers, radii, colors, freqs, phases))


def solids(spec: dict):
    """(centers [K, 3], radii [K]) of the spheres of ``spec``'s scene, in
    Blender space."""
    if spec["kind"] != "hard":
        raise ValueError(f"unknown scene kind {spec['kind']!r}")
    return hard_scene()[:2]


def look_at(eye: np.ndarray) -> np.ndarray:
    """Blender camera-to-world [3, 4] at ``eye`` looking at the origin."""
    fwd = -eye / np.linalg.norm(eye)
    right = np.cross(fwd, np.array([0.0, 0.0, 1.0]))
    right = right / np.linalg.norm(right)
    up = np.cross(right, fwd)
    return np.stack([right, up, -fwd, eye], axis=1).astype(np.float32)


def _trace(origin, dirs, centers, radii, colors, freqs, phases):
    """Nearest-hit shade (rgb [N, 3] f64, hit [N] bool) of unit rays
    ``dirs`` [N, 3] f64 from ``origin`` [3]."""
    dev, f64 = dirs.device, torch.float64
    light = torch.as_tensor(LIGHT_DIR / np.linalg.norm(LIGHT_DIR), dtype=f64,
                            device=dev)
    n = dirs.shape[0]
    best_t = torch.full((n,), float("inf"), dtype=f64, device=dev)
    rgb = torch.zeros((n, 3), dtype=f64, device=dev)
    hit = torch.zeros((n,), dtype=torch.bool, device=dev)
    o = torch.as_tensor(origin, dtype=f64, device=dev)
    for k in range(len(radii)):
        center = torch.as_tensor(centers[k], dtype=f64, device=dev)
        radius = float(radii[k])
        oc = o - center
        b = dirs @ oc
        disc = b * b - (oc @ oc - radius * radius)
        valid = disc > 0
        t_hit = -b - torch.sqrt(torch.clamp(disc, min=0.0))
        valid &= (t_hit > 0) & (t_hit < best_t)
        p = o + t_hit[:, None] * dirs
        shade = 0.35 + 0.65 * torch.clamp(((p - center) / radius) @ light, 0, 1)
        albedo = torch.as_tensor(colors[k], dtype=f64, device=dev)
        if freqs[k] > 0:
            f, ph = float(freqs[k]), phases[k]
            mod = 0.6 + 0.4 * (torch.sin(f * p[:, 0] + ph[0] + 2.1 * p[:, 2])
                               * torch.sin(f * p[:, 1] + ph[1] - 1.3 * p[:, 2]))
            albedo = albedo * mod[:, None]
        rgb = torch.where(valid[:, None], albedo * shade[:, None], rgb)
        best_t = torch.where(valid, t_hit, best_t)
        hit |= valid
    return rgb, hit


def render(pose: np.ndarray, H: int, W: int, camera_angle_x: float,
           ssaa: int = 2, device=None) -> np.ndarray:
    """Ray-trace one view; RGBA float32 [H, W, 4], ``ssaa`` x ``ssaa``
    subpixel rays box-filtered in premultiplied colour."""
    f64 = torch.float64
    hs, ws = H * ssaa, W * ssaa
    focal = 0.5 * ws / np.tan(0.5 * camera_angle_x)
    xs = (torch.arange(ws, dtype=f64, device=device) + 0.5 - ws / 2) / focal
    ys = -(torch.arange(hs, dtype=f64, device=device) + 0.5 - hs / 2) / focal
    cam = torch.stack([xs.expand(hs, ws), ys[:, None].expand(hs, ws),
                       torch.full((hs, ws), -1.0, dtype=f64, device=device)],
                      dim=-1)
    pose = np.asarray(pose, np.float64)
    dirs = cam @ torch.as_tensor(pose[:, :3], device=device).T
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    rgb, hit = _trace(pose[:, 3], dirs.reshape(-1, 3), *hard_scene())
    rgb = rgb.reshape(hs, ws, 3)
    alpha = hit.to(f64).reshape(hs, ws)
    premul = (rgb * alpha[..., None]).reshape(H, ssaa, W, ssaa, 3).mean((1, 3))
    alpha = alpha.reshape(H, ssaa, W, ssaa).mean((1, 3))
    rgb = premul / torch.clamp(alpha[..., None], min=1e-8)
    return torch.cat([rgb, alpha[..., None]], dim=-1).float().cpu().numpy()


def train_poses(n: int) -> list:
    """``n`` cameras spread over the upper hemisphere (a Fibonacci
    spiral in the height above the ground)."""
    golden = np.pi * (3.0 - np.sqrt(5.0))
    out = []
    for i in range(n):
        z = 0.05 + 0.9 * (i + 0.5) / n
        r = np.sqrt(1.0 - z * z)
        eye = RADIUS * np.array([r * np.cos(golden * i), r * np.sin(golden * i),
                                 z])
        out.append(look_at(eye))
    return out


def test_poses(n: int) -> list:
    """``n`` cameras on an orbit at TEST_ELEVATION_DEG."""
    phi = np.radians(TEST_ELEVATION_DEG)
    return [look_at(RADIUS * np.array([np.cos(t) * np.cos(phi),
                                       np.sin(t) * np.cos(phi), np.sin(phi)]))
            for t in 2 * np.pi * (np.arange(n) + 0.25) / n]


def write_png(path: str, img_u8: np.ndarray) -> None:
    """8-bit RGBA [H, W, 4] as a PNG, every row with filter type 0."""
    h, w, c = img_u8.shape
    assert c == 4 and img_u8.dtype == np.uint8
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          img_u8.reshape(h, w * 4)], axis=1).tobytes()

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    """A file of ``write_png`` back as uint8 [H, W, 4]."""
    with open(path, "rb") as f:
        data = f.read()
    pos, idat, h, w = 8, b"", 0, 0
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        if kind == b"IHDR":
            w, h = struct.unpack(">II", body[:8])
            if body[8:13] != bytes([8, 6, 0, 0, 0]):
                raise ValueError(f"{path}: not an 8-bit RGBA PNG of write_png")
        elif kind == b"IDAT":
            idat += body
        pos += 12 + length
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 4 * w)
    if rows[:, 0].any():
        raise ValueError(f"{path}: a row filter other than 0")
    return rows[:, 1:].reshape(h, w, 4).copy()


def scene_dir(root: str, spec: dict) -> str:
    """The scene's fixed directory under ``root`` for its parameters."""
    return os.path.join(root, f"{spec['kind']}_{spec['n_train']}x"
                        f"{spec['H']}x{spec['W']}_{spec['n_test']}")


def ensure_scene(root: str, spec: dict, device=None) -> str:
    """Write the scene of ``spec`` (keys kind, n_train, n_test, H, W,
    camera_angle_x) under ``root`` unless it is there; returns its
    directory.  A partial write never takes the fixed name: the files go
    to a sibling directory that is renamed when complete."""
    if spec["kind"] != "hard":
        raise ValueError(f"unknown scene kind {spec['kind']!r}")
    out = scene_dir(root, spec)
    if os.path.exists(os.path.join(out, "transforms_train.json")):
        return out
    tmp = out + ".partial"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(os.path.join(tmp, "train"))
    H, W, angle = spec["H"], spec["W"], spec["camera_angle_x"]
    frames = []
    for i, pose in enumerate(train_poses(spec["n_train"])):
        img = render(pose, H, W, angle, device=device)
        u8 = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
        write_png(os.path.join(tmp, "train", f"r_{i}.png"), u8)
        frames.append({"file_path": f"train/r_{i}",
                       "transform_matrix": _homogeneous(pose)})
    _write_json(tmp, "train", angle, frames)
    _write_json(tmp, "test", angle,
                [{"file_path": f"test/r_{i}", "transform_matrix": _homogeneous(p)}
                 for i, p in enumerate(test_poses(spec["n_test"]))])
    os.replace(tmp, out)
    return out


def _homogeneous(pose):
    return np.concatenate([pose, [[0, 0, 0, 1]]], axis=0).tolist()


def _write_json(out, split, angle, frames):
    with open(os.path.join(out, f"transforms_{split}.json"), "w") as f:
        json.dump({"camera_angle_x": angle, "aabb_scale": 1,
                   "frames": frames}, f)


def load_split(out: str, split: str):
    """(camera_angle_x, [N, 3, 4] f32 Blender poses, file paths) of a
    split."""
    with open(os.path.join(out, f"transforms_{split}.json")) as f:
        meta = json.load(f)
    poses = np.asarray([fr["transform_matrix"] for fr in meta["frames"]],
                       np.float32)[:, :3]
    return (meta["camera_angle_x"], poses,
            [os.path.join(out, fr["file_path"] + ".png")
             for fr in meta["frames"]])

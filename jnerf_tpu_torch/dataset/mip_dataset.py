"""Mip-NeRF datasets: the ray-pool Blender loader and the multiscale Multicam.

Counterpart of `jnerf_tpu/dataset/mip_dataset.py`.  The rays of every image
are made and pooled on the host in numpy, and the pool is permuted by
``np.random.default_rng(seed)`` as in the JAX loader, so both yield the same
batches in the same order; ``__next__`` and ``rays_for_image`` hand out
tensors on ``device``.  The loader's quirks are kept: the train split also
takes every json whose stem contains ``val``, val and test keep every 10th
frame, and each cone radius comes from the spacing of neighbouring rows of
ray directions.

Rays are the 7-field namedtuple the whole Mip-NeRF pipeline shares.
"""

from __future__ import annotations

import collections
import json
import os
from math import pi

import numpy as np
import torch

from jnerf_tpu_torch.utils.registry import DATASETS
from .dataset_util import fov_to_focal_length, read_image

Rays = collections.namedtuple(
    "Rays",
    ("origins", "directions", "viewdirs", "radii", "lossmult", "near", "far"),
)


def namedtuple_map(fn, tup):
    return type(tup)(*(fn(x) for x in tup))


def rays_for_camera(c2w, H, W, focal, near, far, lossmult=1.0):
    """Per-pixel rays for one camera in mip-NeRF's convention (numpy):
    unnormalized directions, cone radii = neighbour spacing * 2/sqrt(12)."""
    x, y = np.meshgrid(
        np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32),
        indexing="xy",
    )
    camera_dirs = np.stack(
        [(x - W * 0.5 + 0.5) / focal, -(y - H * 0.5 + 0.5) / focal,
         -np.ones_like(x)], axis=-1,
    )
    directions = camera_dirs @ np.asarray(c2w)[:3, :3].T
    origins = np.broadcast_to(np.asarray(c2w)[:3, 3], directions.shape).copy()
    viewdirs = directions / np.linalg.norm(directions, axis=-1, keepdims=True)
    dx = np.sqrt(np.sum((directions[:-1] - directions[1:]) ** 2, -1))
    dx = np.concatenate([dx, dx[-2:-1]], 0)
    radii = (dx * 2 / np.sqrt(12))[..., None]
    ones = np.ones_like(origins[..., :1])
    return Rays(
        origins=origins.astype(np.float32),
        directions=directions.astype(np.float32),
        viewdirs=viewdirs.astype(np.float32),
        radii=radii.astype(np.float32),
        lossmult=(ones * lossmult).astype(np.float32),
        near=(ones * near).astype(np.float32),
        far=(ones * far).astype(np.float32),
    )


class _RayPoolDataset:
    """Shared machinery: flatten per-image rays into a shuffled host pool."""

    def _to_device(self, x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    def _build_pool(self, per_image_rays, images):
        flat = [namedtuple_map(lambda r: r.reshape(-1, r.shape[-1]), rr)
                for rr in per_image_rays]
        self.rays = Rays(*[
            np.concatenate([getattr(r, f) for r in flat], axis=0)
            for f in Rays._fields
        ])
        self.image_data = np.concatenate(
            [im.reshape(-1, im.shape[-1]) for im in images], axis=0
        )
        self._reshuffle()
        self.idx_now = 0

    def _reshuffle(self):
        perm = self._rng.permutation(self.rays.origins.shape[0])
        self.rays = namedtuple_map(lambda r: r[perm], self.rays)
        self.image_data = self.image_data[perm]

    def __iter__(self):
        return self

    def next_host(self) -> np.ndarray:
        """The next batch on the host, [batch, sum C]: the Rays fields'
        columns, then the rgba's (`split_batch` takes it apart)."""
        if self.idx_now + self.batch_size >= self.rays.origins.shape[0]:
            self._reshuffle()
            self.idx_now = 0
        sl = slice(self.idx_now, self.idx_now + self.batch_size)
        self.idx_now += self.batch_size
        return np.concatenate([r[sl] for r in self.rays]
                              + [self.image_data[sl]], axis=1)

    def split_batch(self, t):
        """A [batch, sum C] batch (`next_host`) -> (Rays of [batch, C]
        column views, rgba [batch, 4])."""
        widths = [r.shape[1] for r in self.rays] + [self.image_data.shape[1]]
        *fields, rgb = torch.split(t, widths, dim=1)
        return Rays(*fields), rgb

    def __next__(self):
        """(Rays of [batch, C] tensors, rgba [batch, 4]) on the device,
        copied in one transfer (from pinned memory, without waiting for the
        device, on a card)."""
        t = torch.from_numpy(self.next_host())
        if self.device.type == "cuda":
            t = t.pin_memory().to(self.device, non_blocking=True)
        return self.split_batch(t)

    def rays_for_image(self, idx):
        """Rays of [H, W, C] tensors of image ``idx`` on the device."""
        return namedtuple_map(self._to_device, self._image_rays[idx])

    def image(self, idx):
        return self._images[idx]


@DATASETS.register_module()
class Blender(_RayPoolDataset):
    def __init__(self, root_dir, batch_size, mode="train", H=0, W=0, near=2.0,
                 far=6.0, img_alpha=True, have_img=True, preload_shuffle=True,
                 white_bkgd=False, seed=0, device="cuda"):
        if mode not in ("train", "val", "test"):
            raise ValueError(f"mode {mode!r}")
        self.device = torch.device(device)
        self.root_dir = root_dir
        self.batch_size = batch_size
        self.mode = mode
        self.near, self.far = near, far
        self._rng = np.random.default_rng(seed)

        json_data = None
        for root, _dirs, files in os.walk(root_dir):
            for fname in files:
                stem, ext = os.path.splitext(fname)
                if ext != ".json":
                    continue
                if mode in stem or (mode == "train" and "val" in stem):
                    with open(os.path.join(root, fname)) as f:
                        data = json.load(f)
                    if json_data is None:
                        json_data = data
                    else:
                        json_data["frames"] += data["frames"]
        if json_data is None:
            raise FileNotFoundError(f"dataset not found at {root_dir}")
        frames = json_data["frames"]
        if mode in ("val", "test"):
            frames = frames[::10]

        images, poses = [], []
        for frame in frames:
            rel = frame["file_path"]
            rel = rel[2:] if rel.startswith("./") else rel
            path = os.path.join(root_dir, rel)
            if not os.path.exists(path):
                path += ".png"
                if not os.path.exists(path):
                    continue
            img = read_image(path)
            if H == 0 or W == 0:
                H, W = int(img.shape[0]), int(img.shape[1])
            if img_alpha and img.shape[-1] == 3:
                img = np.concatenate([img, np.ones_like(img[..., :1])], -1)
            images.append(img.astype(np.float32))
            poses.append(np.array(frame["transform_matrix"], np.float32))
        self.H, self.W = H, W
        self.resolution = [W, H]
        self.n_images = len(images)
        self.focal = fov_to_focal_length(
            W, json_data["camera_angle_x"] * 180 / pi
        )

        self._images = images
        self._image_rays = [
            rays_for_camera(p, H, W, self.focal, near, far) for p in poses
        ]
        self._build_pool(self._image_rays, images)


@DATASETS.register_module(name="Blenders")
class Blenders(Blender):
    """Alias kept for registry parity."""


@DATASETS.register_module()
class Multicam(_RayPoolDataset):
    """Multiscale blender: per-image cameras + lossmult from metadata.json."""

    def __init__(self, root_dir, batch_size, mode="train", seed=0,
                 device="cuda", **_kw):
        if mode not in ("train", "val", "test"):
            raise ValueError(f"mode {mode!r}")
        self.device = torch.device(device)
        self.root_dir = root_dir
        self.batch_size = batch_size
        self.mode = mode
        self._rng = np.random.default_rng(seed)
        with open(os.path.join(root_dir, "metadata.json")) as f:
            meta = json.load(f)[mode if mode != "val" else "test"]

        images, rays = [], []
        n = len(meta["file_path"])
        for i in range(n):
            img = read_image(os.path.join(root_dir, meta["file_path"][i]))
            if img.shape[-1] == 3:
                img = np.concatenate([img, np.ones_like(img[..., :1])], -1)
            images.append(img.astype(np.float32))
            rays.append(
                rays_for_camera(
                    np.asarray(meta["cam2world"][i]),
                    int(meta["height"][i]),
                    int(meta["width"][i]),
                    float(meta["focal"][i]),
                    float(meta["near"][i]),
                    float(meta["far"][i]),
                    float(meta["lossmult"][i]),
                )
            )
        self.n_images = n
        self._images = images
        self._image_rays = rays
        self.H = int(meta["height"][0])
        self.W = int(meta["width"][0])
        self.resolution = [self.W, self.H]
        self._build_pool(rays, images)

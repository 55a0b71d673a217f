"""Plenoxels dataset: a blender scene as a flat shuffled ray pool.

Counterpart of `jnerf_tpu/dataset/svox_dataset.py`: per-pixel (origin,
unit direction, rgb) rows made in numpy on the host, the white background
composited at load (svox2's background_brightness), ``test`` keeping
every 10th frame, and the pool permuted by ``np.random.default_rng(seed)``
as in the JAX loader, so both yield the same batches.  ``next_batch`` and
``rays_for_image`` hand out tensors on ``device``.
"""

from __future__ import annotations

import json
import os
from math import pi

import numpy as np
import torch

from jnerf_tpu_torch.utils.registry import DATASETS
from .dataset_util import fov_to_focal_length, read_image


@DATASETS.register_module()
class SvoxNeRFDataset:
    def __init__(self, root, split="train", epoch_size=None, batch_size=5000,
                 background_brightness=1.0, seed=0, device="cuda", **_unused):
        if split not in ("train", "val", "test"):
            raise ValueError(f"split {split!r}")
        self.device = torch.device(device)
        self.root_dir = root
        self.split = split
        self.batch_size = batch_size
        self._rng = np.random.default_rng(seed)

        with open(os.path.join(root, f"transforms_{split}.json")) as f:
            meta = json.load(f)
        frames = meta["frames"]
        if split == "test":
            frames = frames[::10]

        images, poses = [], []
        for fr in frames:
            rel = fr["file_path"]
            rel = rel[2:] if rel.startswith("./") else rel
            p = os.path.join(root, rel)
            if not os.path.exists(p):
                p += ".png"
            img = read_image(p)
            if img.shape[-1] == 3:
                img = np.concatenate([img, np.ones_like(img[..., :1])], -1)
            images.append(img.astype(np.float32))
            poses.append(np.array(fr["transform_matrix"], np.float32))
        self.n_images = len(images)
        self.H, self.W = images[0].shape[:2]
        self.focal = fov_to_focal_length(self.W,
                                         meta["camera_angle_x"] * 180 / pi)
        self._images = images
        self._poses = poses
        self.bg = background_brightness

        x, y = np.meshgrid(
            np.arange(self.W, dtype=np.float32),
            np.arange(self.H, dtype=np.float32), indexing="xy",
        )
        cam_dirs = np.stack(
            [(x - self.W * 0.5 + 0.5) / self.focal,
             -(y - self.H * 0.5 + 0.5) / self.focal, -np.ones_like(x)], -1,
        )
        origins, dirs, rgbs = [], [], []
        for img, c2w in zip(images, poses):
            d = cam_dirs @ c2w[:3, :3].T
            d = d / np.linalg.norm(d, axis=-1, keepdims=True)
            origins.append(np.broadcast_to(c2w[:3, 3], d.shape).reshape(-1, 3))
            dirs.append(d.reshape(-1, 3))
            rgb = img[..., :3] * img[..., 3:] + self.bg * (1 - img[..., 3:])
            rgbs.append(rgb.reshape(-1, 3))
        self._origins = np.concatenate(origins).astype(np.float32)
        self._dirs = np.concatenate(dirs).astype(np.float32)
        self._rgbs = np.concatenate(rgbs).astype(np.float32)
        self._perm = self._rng.permutation(len(self._origins))
        self._cursor = 0

    def next_host(self, batch_size=None) -> np.ndarray:
        """The next batch on the host: [batch, 9] f32, the origins', unit
        dirs' and rgb's columns."""
        bs = batch_size or self.batch_size
        if self._cursor + bs > len(self._perm):
            self._perm = self._rng.permutation(len(self._origins))
            self._cursor = 0
        idx = self._perm[self._cursor:self._cursor + bs]
        self._cursor += bs
        return np.concatenate(
            [self._origins[idx], self._dirs[idx], self._rgbs[idx]], axis=1)

    def next_batch(self, batch_size=None):
        """(origins, unit dirs, rgb), each [batch, 3] on the device, copied
        in one transfer (from pinned memory on a card)."""
        t = torch.from_numpy(self.next_host(batch_size))
        if self.device.type == "cuda":
            t = t.pin_memory().to(self.device, non_blocking=True)
        return t[:, 0:3], t[:, 3:6], t[:, 6:9]

    def rays_for_image(self, i):
        """(origins, unit dirs) [H * W, 3] of test image ``i`` on the device."""
        sl = slice(i * self.H * self.W, (i + 1) * self.H * self.W)
        return (torch.from_numpy(self._origins[sl]).to(self.device),
                torch.from_numpy(self._dirs[sl]).to(self.device))

    def image(self, i):
        return self._images[i]

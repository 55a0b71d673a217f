"""In-memory procedural dataset (no disk IO, no network).

Counterpart of `jnerf_tpu/dataset/procedural.py`: ``SyntheticSpheresDataset``
ray-traces the analytic scene (``spheres``, or the ``hard`` quality scene,
with ``ssaa`` x ``ssaa`` subpixel rays a pixel) on its device and keeps
images, poses and intrinsics there as tensors, with the same fields as the
JAX package's dataset, so the same config and seed give the same pixels
and cameras in both packages, in each of the train, val and test modes
(each mode offsets the seed), and the same full-image rays for rendering.

The JAX package traces on the host in numpy and keeps an npz cache of the
expensive scenes (its ``_render_cached``).  Here the trace is float64
tensor code on the dataset's device: the quality run's hard scene (16
train and 4 val images of 512x512 at ssaa 2, 1,048,576 subpixel rays an
image against 104 objects) builds in 0.935-1.208 s on an NVIDIA H100 80GB
HBM3 at 700.00 W (`chip_smoke.py`), so the port keeps no scene cache.
"""

from __future__ import annotations

import numpy as np
import torch

from jnerf_tpu_torch.utils.registry import DATASETS
from .dataset import PixelBatches, matrix_nerf2ngp, rays_for_image
from .dataset_util import NERF_SCALE, fov_to_focal_length
from .synthetic import _look_at_pose, render_analytic


@DATASETS.register_module()
class SyntheticSpheresDataset(PixelBatches):
    def __init__(
        self,
        batch_size=4096,
        mode="train",
        n_images=16,
        H=256,
        W=256,
        camera_angle_x=0.6911112070083618,
        aabb_scale=1,
        scale=None,
        offset=None,
        seed=0,
        have_img=True,
        root_dir=None,  # accepted for config-surface parity, unused
        preload_shuffle=True,
        scene="spheres",
        ssaa=1,
        device=None,
    ):
        del root_dir, preload_shuffle
        self.mode = mode
        self.batch_size = batch_size
        self.n_images = int(n_images)
        self.H, self.W = int(H), int(W)
        self.have_img = have_img
        self.scale = NERF_SCALE if scale is None else scale
        self.offset = [0.5, 0.5, 0.5] if offset is None else list(offset)
        self.aabb_scale = aabb_scale
        self.aabb_range = (0.5 - aabb_scale / 2, 0.5 + aabb_scale / 2)
        self.resolution = [self.W, self.H]

        rng = np.random.default_rng(seed + {"train": 0, "val": 1, "test": 2}[mode])
        poses = []
        for i in range(self.n_images):
            theta = 2 * np.pi * i / self.n_images + rng.uniform(-0.1, 0.1)
            phi = np.radians(rng.uniform(-20, 50))
            eye = 4.0 * np.array(
                [np.cos(theta) * np.cos(phi), np.sin(theta) * np.cos(phi), np.sin(phi)]
            )
            poses.append(_look_at_pose(eye))
        images = [render_analytic(p, self.H, self.W, camera_angle_x,
                                  scene=scene, ssaa=int(ssaa), device=device)
                  for p in poses]
        transforms = [matrix_nerf2ngp(p, self.scale, self.offset) for p in poses]

        focal = fov_to_focal_length(self.W, np.degrees(camera_angle_x))
        self.focal_lengths = torch.full((self.n_images, 2), focal,
                                        dtype=torch.float32, device=device)
        self.principal_points = torch.full((self.n_images, 2), 0.5,
                                           dtype=torch.float32, device=device)
        self.image_data = torch.stack(images).reshape(
            self.n_images * self.H * self.W, 4)
        self.transforms_gpu = torch.from_numpy(np.stack(transforms)).to(device)
        self._rng = np.random.default_rng(seed)  # draws the batch iterator's pixels

    def generate_rays_total_test(self, img_id: int):
        """Full-image rays (rays_o, rays_d) [H*W, 3] of dataset camera
        ``img_id``."""
        return rays_for_image(self.transforms_gpu[img_id],
                              self.focal_lengths[img_id],
                              self.principal_points[img_id], self.W, self.H)

    def generate_rays_with_pose(self, pose):
        """Full-image rays for an external NeRF-space [3,4] pose."""
        ngp = torch.from_numpy(
            matrix_nerf2ngp(np.asarray(pose), self.scale, self.offset)
        ).to(self.transforms_gpu.device)
        return rays_for_image(ngp, self.focal_lengths[0],
                              self.principal_points[0], self.W, self.H)

    def image(self, img_id: int) -> np.ndarray:
        """Image ``img_id`` as a numpy [H, W, 4] RGBA array."""
        hw = self.H * self.W
        rows = self.image_data[img_id * hw:(img_id + 1) * hw]
        return rows.cpu().numpy().reshape(self.H, self.W, -1)

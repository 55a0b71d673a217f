"""In-memory procedural dataset (no disk IO, no network).

Counterpart of `jnerf_tpu/dataset/procedural.py`: ``SyntheticSpheresDataset``
renders the analytic sphere scene with numpy and keeps images, poses and
intrinsics as tensors on its device, with the same fields as the JAX
package's dataset, so the same config and seed give the same pixels and
cameras in both packages, in each of the train, val and test modes (each
mode offsets the seed), and the same full-image rays for rendering.
"""

from __future__ import annotations

import numpy as np
import torch

from jnerf_tpu_torch.utils.registry import DATASETS
from .dataset import matrix_nerf2ngp, rays_for_image
from .dataset_util import NERF_SCALE, fov_to_focal_length
from .synthetic import _look_at_pose, render_analytic


@DATASETS.register_module()
class SyntheticSpheresDataset:
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
        if scene != "spheres" or int(ssaa) != 1:
            raise NotImplementedError(
                "only the plain 'spheres' scene at ssaa=1 is ported (ROADMAP.md, "
                "port queue: datasets)")
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
        images = [render_analytic(p, self.H, self.W, camera_angle_x)
                  for p in poses]
        transforms = [matrix_nerf2ngp(p, self.scale, self.offset) for p in poses]

        focal = fov_to_focal_length(self.W, np.degrees(camera_angle_x))
        self.focal_lengths = torch.full((self.n_images, 2), focal,
                                        dtype=torch.float32, device=device)
        self.principal_points = torch.full((self.n_images, 2), 0.5,
                                           dtype=torch.float32, device=device)
        self.image_data = torch.from_numpy(
            np.stack(images).reshape(self.n_images * self.H * self.W, 4)
        ).to(device)
        self.transforms_gpu = torch.from_numpy(np.stack(transforms)).to(device)

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

"""Blender/NGP-json dataset, camera-pose conversion and ray generation on
device tensors.

Counterpart of `jnerf_tpu/dataset/dataset.py`: the pose helpers,
``rays_from_pixels``, ``rays_for_image`` and ``NerfDataset``, which finds
the split's json files as the JAX loader does (train mode also takes the
val split; val mode keeps every 10th frame), reads the images with the
port's own PNG decoder (`dataset_util.read_image`) and keeps images,
poses and intrinsics on its device as tensors, with the fields that
`SyntheticSpheresDataset` gives the runner.  As in the JAX package, the
distortion coefficients k1, k2, p1, p2 are carried in ``metadata`` and not
applied to the rays.
"""

from __future__ import annotations

import json
import os
from math import pi

import numpy as np
import torch

from jnerf_tpu_torch.utils.registry import DATASETS
from .dataset_util import NERF_SCALE, fov_to_focal_length, read_image


def matrix_nerf2ngp(matrix: np.ndarray, scale, offset, correct_pose=(1, -1, -1)):
    """NeRF [3,4] camera-to-world -> NGP coordinates.

    Axis sign flips, translation scale+offset into the unit cube, then the
    row cycle [1,2,0] (`dataset.py:255-262` of the reference).
    """
    m = np.array(matrix, dtype=np.float32, copy=True)
    m[:, 0] *= correct_pose[0]
    m[:, 1] *= correct_pose[1]
    m[:, 2] *= correct_pose[2]
    m[:, 3] = m[:, 3] * scale + np.asarray(offset, dtype=np.float32)
    return m[[1, 2, 0]]


def matrix_ngp2nerf(matrix: np.ndarray, scale, offset, correct_pose=(1, -1, -1)):
    """Inverse of ``matrix_nerf2ngp``."""
    m = np.array(matrix, dtype=np.float32, copy=True)
    m = m[[2, 0, 1]]
    m[:, 0] *= correct_pose[0]
    m[:, 1] *= correct_pose[1]
    m[:, 2] *= correct_pose[2]
    m[:, 3] = (m[:, 3] - np.asarray(offset, dtype=np.float32)) / scale
    return m


def rays_from_pixels(pixel_index, transforms, focal_lengths, principal_points,
                     W, H):
    """Camera rays for flat pixel indices over [n_images, H, W].

    Pixel centres normalized to [0,1], displaced from the principal point
    in focal-length units, rotated by the camera-to-world rotation and
    normalized.

    Args:
      pixel_index: [B] int, flat index into n_images*H*W.
      transforms: [n_images, 3, 4] NGP-space camera-to-world.
      focal_lengths: [n_images, 2].
      principal_points: [n_images, 2] (normalized cx, cy).
    Returns:
      img_ids [B], rays_o [B,3], rays_d [B,3] (unit norm).
    """
    hw = H * W
    img_id = pixel_index // hw
    off = pixel_index % hw
    x = ((off % W).to(torch.float32) + 0.5) / W
    y = ((off // W).to(torch.float32) + 0.5) / H
    xy = torch.stack([x, y], dim=-1)
    xf = transforms[img_id]
    fl = focal_lengths[img_id]
    pp = principal_points[img_id]
    res = torch.tensor([W, H], dtype=torch.float32, device=xy.device)
    d_cam = torch.cat([(xy - pp) * res / fl, torch.ones_like(x)[:, None]], dim=-1)
    d_world = torch.einsum("bij,bj->bi", xf[:, :, :3], d_cam)
    rays_d = d_world / torch.linalg.norm(d_world, dim=-1, keepdim=True)
    rays_o = xf[:, :, 3]
    return img_id, rays_o, rays_d


def rays_for_image(transform, focal_length, principal_point, W, H):
    """Full-image rays for one [3,4] NGP-space pose, pixels in row-major
    order (y outer, x inner) at their centres.

    Returns rays_o [H*W,3], rays_d [H*W,3] (unit norm) on the pose's device.
    """
    dev = transform.device
    ys = (torch.arange(H, dtype=torch.float32, device=dev) + 0.5) / H
    xs = (torch.arange(W, dtype=torch.float32, device=dev) + 0.5) / W
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    xy = torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1)
    res = torch.tensor([W, H], dtype=torch.float32, device=dev)
    d_cam = torch.cat([(xy - principal_point) * res / focal_length,
                       torch.ones((H * W, 1), device=dev)], dim=-1)
    d_world = d_cam @ transform[:, :3].T
    rays_d = d_world / torch.linalg.norm(d_world, dim=-1, keepdim=True)
    rays_o = transform[:, 3].expand(H * W, 3)
    return rays_o, rays_d


@DATASETS.register_module()
class NerfDataset:
    def __init__(
        self,
        root_dir,
        batch_size,
        mode="train",
        H=0,
        W=0,
        correct_pose=(1, -1, -1),
        aabb_scale=None,
        scale=None,
        offset=None,
        img_alpha=True,
        have_img=True,
        preload_shuffle=True,
        device=None,
    ):
        assert mode in ("train", "val", "test")
        del preload_shuffle  # pixels are drawn by the runner
        self.root_dir = root_dir
        self.batch_size = batch_size
        self.mode = mode
        self.H, self.W = int(H), int(W)
        self.correct_pose = list(correct_pose)
        self.aabb_scale = aabb_scale
        self.scale = NERF_SCALE if scale is None else scale
        self.offset = [0.5, 0.5, 0.5] if offset is None else list(offset)
        self.img_alpha = img_alpha
        self.have_img = have_img
        self.device = torch.device(device) if device is not None else None
        self.n_images = 0
        self.load_data()

    # ------------------------------------------------------------------ load
    def _find_json_paths(self, root_dir):
        paths = []
        for root, _dirs, files in os.walk(root_dir):
            for fname in files:
                stem, ext = os.path.splitext(fname)
                if ext != ".json":
                    continue
                if self.mode in stem or (self.mode == "train" and "val" in stem):
                    paths.append(os.path.join(root, fname))
        return sorted(paths)

    def load_data(self):
        json_data = None
        for path in self._find_json_paths(self.root_dir):
            with open(path, "r") as f:
                data = json.load(f)
            if json_data is None:
                json_data = data
            else:
                json_data["frames"] += data["frames"]
        assert json_data is not None, f"dataset not found at {self.root_dir}"

        if "h" in json_data:
            self.H = int(json_data["h"])
        if "w" in json_data:
            self.W = int(json_data["w"])

        frames = json_data["frames"]
        if self.mode == "val":
            frames = frames[::10]

        images, transforms = [], []
        for frame in frames:
            if self.have_img:
                img_path = os.path.join(self.root_dir, frame["file_path"])
                if not os.path.exists(img_path):
                    img_path = img_path + ".png"
                    if not os.path.exists(img_path):
                        continue
                img = read_image(img_path)
                if self.H == 0 or self.W == 0:
                    self.H, self.W = int(img.shape[0]), int(img.shape[1])
                images.append(img)
            else:
                images.append(np.zeros((self.H, self.W, 3), np.float32))
            matrix = np.array(frame["transform_matrix"], np.float32)[:3, :]
            transforms.append(
                matrix_nerf2ngp(matrix, self.scale, self.offset, self.correct_pose)
            )
        self.n_images = len(images)
        assert self.n_images > 0, f"no frames loaded from {self.root_dir}"

        self.resolution = [self.W, self.H]
        if self.aabb_scale is None:
            self.aabb_scale = json_data.get("aabb_scale", 1)
        self.aabb_range = (0.5 - self.aabb_scale / 2, 0.5 + self.aabb_scale / 2)

        def read_focal(res, axis):
            if "fl_" + axis in json_data:
                return json_data["fl_" + axis]
            if "camera_angle_" + axis in json_data:
                return fov_to_focal_length(
                    res, json_data["camera_angle_" + axis] * 180 / pi)
            return 0.0

        fx = read_focal(self.W, "x")
        fy = read_focal(self.H, "y")
        if fx != 0:
            focal = [fx, fy if fy != 0 else fx]
        elif fy != 0:
            focal = [fy, fy]
        else:
            raise RuntimeError("couldn't read fov from transforms json")

        meta = np.zeros([11], np.float32)
        meta[0] = json_data.get("k1", 0)
        meta[1] = json_data.get("k2", 0)
        meta[2] = json_data.get("p1", 0)
        meta[3] = json_data.get("p2", 0)
        meta[4] = json_data.get("cx", self.W / 2) / self.W
        meta[5] = json_data.get("cy", self.H / 2) / self.H
        meta[6:8] = focal
        self.metadata = np.tile(meta[None], (self.n_images, 1))
        self._to_device(images, transforms,
                        np.tile(np.array(focal, np.float32)[None],
                                (self.n_images, 1)))

    def _to_device(self, images, transforms, focal_lengths):
        """Images [n*H*W, C] (alpha added to RGB when img_alpha), poses,
        focal lengths and principal points (from metadata) to the device."""
        imgs = np.stack(images, axis=0).astype(np.float32)
        if self.img_alpha and imgs.shape[-1] == 3:
            imgs = np.concatenate(
                [imgs, np.ones(imgs.shape[:-1] + (1,), np.float32)], axis=-1
            )
        dev = self.device
        self.image_data = torch.from_numpy(
            imgs.reshape(self.n_images * self.H * self.W, -1)).to(dev)
        self.transforms_gpu = torch.from_numpy(np.stack(transforms)).to(dev)
        self.focal_lengths = torch.from_numpy(
            np.ascontiguousarray(focal_lengths, np.float32)).to(dev)
        self.principal_points = torch.from_numpy(
            np.ascontiguousarray(self.metadata[:, 4:6])).to(dev)

    # --------------------------------------------------------------- render
    def generate_rays_total_test(self, img_id: int):
        """Full-image rays (rays_o, rays_d) [H*W, 3] of dataset camera
        ``img_id``."""
        return rays_for_image(self.transforms_gpu[img_id],
                              self.focal_lengths[img_id],
                              self.principal_points[img_id], self.W, self.H)

    def generate_rays_with_pose(self, pose):
        """Full-image rays for an external NeRF-space [3,4] pose."""
        ngp = torch.from_numpy(matrix_nerf2ngp(
            np.asarray(pose), self.scale, self.offset, self.correct_pose,
        )).to(self.transforms_gpu.device)
        return rays_for_image(ngp, self.focal_lengths[0],
                              self.principal_points[0], self.W, self.H)

    def image(self, img_id: int) -> np.ndarray:
        """Image ``img_id`` as a numpy [H, W, C] array."""
        hw = self.H * self.W
        rows = self.image_data[img_id * hw:(img_id + 1) * hw]
        return rows.cpu().numpy().reshape(self.H, self.W, -1)

"""DTU-style NeuS dataset: cameras_sphere.npz (world and scale matrices),
image/ and mask/ PNGs.

Counterpart of `jnerf_tpu/dataset/neus_dataset.py`: the projection matrix
decomposition (numpy RQ), the full-image, random and interpolated ray
generators and the unit-sphere near/far, with the images, masks and
cameras as f32 tensors on the dataset's device.  Images go through the
port's PNG codec.  ``image_at`` resizes as OpenCV's ``INTER_LINEAR`` does
on uint8 (`resize_linear_u8`), without OpenCV.
"""

from __future__ import annotations

import os
from glob import glob

import numpy as np
import torch

from jnerf_tpu_torch.ops.linspace import linspace
from jnerf_tpu_torch.utils.registry import DATASETS
from .dataset_util import read_image


def decompose_projection(P: np.ndarray):
    """P [3, 4] -> (K [3, 3] with K[2, 2] = 1, pose [4, 4] camera-to-world).

    What cv2.decomposeProjectionMatrix gives: an RQ decomposition of the
    left 3x3 into an upper-triangular K (positive diagonal) and a rotation,
    and the camera centre from the null space.
    """
    M = P[:3, :3]
    # RQ decomposition via QR of the flipped transpose.
    flip = np.array([[0, 0, 1], [0, 1, 0], [1, 0, 0]], np.float64)
    Q, R = np.linalg.qr((flip @ M).T)
    K = flip @ R.T @ flip
    Rmat = flip @ Q.T
    # Make K's diagonal positive.
    signs = np.sign(np.diag(K))
    signs[signs == 0] = 1
    K = K * signs[None, :]
    Rmat = signs[:, None] * Rmat
    if np.linalg.det(Rmat) < 0:
        Rmat = -Rmat
    K = K / K[2, 2]
    # Camera centre: P @ [c, 1] = 0.
    c = -np.linalg.inv(M) @ P[:3, 3]
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = Rmat.T
    pose[:3, 3] = c
    return K.astype(np.float32), pose


def _linear_taps(n_src: int, n_dst: int):
    """OpenCV's INTER_LINEAR taps along one axis: source indices (i0, i1)
    and 11-bit fixed-point weights (w0, w1), from half-pixel centres in
    f32, clamped at the borders (`resize.cpp`, resizeGeneric)."""
    f = ((np.arange(n_dst) + 0.5) * (n_src / n_dst) - 0.5).astype(np.float32)
    i0 = np.floor(f).astype(np.int64)
    f = (f - i0).astype(np.float32)
    clamp = (i0 < 0) | (i0 >= n_src - 1)
    f[clamp] = 0
    i0 = np.clip(i0, 0, n_src - 1)
    w0 = np.rint((np.float32(1) - f) * np.float32(2048)).astype(np.int64)
    w1 = np.rint(f * np.float32(2048)).astype(np.int64)
    return i0, np.minimum(i0 + 1, n_src - 1), w0, w1


def resize_linear_u8(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """Shrink a uint8 [H, W, C] image to [height, width, C] as
    ``cv2.resize(img, (width, height))`` (INTER_LINEAR) does: 11-bit
    fixed-point weights, a horizontal pass in integers, then the vertical
    pass rounded as OpenCV's vector path rounds it.  For downscaling (the
    only use here); OpenCV enlarges by other rules."""
    if width > img.shape[1] or height > img.shape[0]:
        raise ValueError("resize_linear_u8 only shrinks")
    src = img.astype(np.int64)
    x0, x1, a0, a1 = _linear_taps(img.shape[1], width)
    y0, y1, b0, b1 = _linear_taps(img.shape[0], height)
    rows = src[:, x0] * a0[None, :, None] + src[:, x1] * a1[None, :, None]
    s0, s1 = rows[y0] >> 4, rows[y1] >> 4
    out = (((s0 * b0[:, None, None]) >> 16)
           + ((s1 * b1[:, None, None]) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)


@DATASETS.register_module()
class NeuSDataset:
    def __init__(self, dataset_dir, render_cameras_name, object_cameras_name,
                 device=None):
        self.data_dir = dataset_dir
        self.device = torch.device(device) if device is not None else None
        cams = np.load(os.path.join(dataset_dir, render_cameras_name))
        self.images_lis = sorted(glob(os.path.join(dataset_dir, "image/*.png")))
        self.n_images = len(self.images_lis)
        if self.n_images == 0:
            raise FileNotFoundError(f"no images under {dataset_dir}/image")

        imgs = [read_image(p)[..., :3] for p in self.images_lis]
        self.masks_lis = sorted(glob(os.path.join(dataset_dir, "mask/*.png")))
        if self.masks_lis:
            masks = [read_image(p)[..., :1] for p in self.masks_lis]
        else:
            masks = [np.ones_like(im[..., :1]) for im in imgs]

        self.world_mats_np = [cams[f"world_mat_{i}"].astype(np.float32)
                              for i in range(self.n_images)]
        self.scale_mats_np = [cams[f"scale_mat_{i}"].astype(np.float32)
                              for i in range(self.n_images)]

        intrinsics_all, pose_all = [], []
        for scale_mat, world_mat in zip(self.scale_mats_np, self.world_mats_np):
            P = (world_mat @ scale_mat)[:3, :4]
            K, pose = decompose_projection(P)
            intr = np.eye(4, dtype=np.float32)
            intr[:3, :3] = K
            intrinsics_all.append(intr)
            pose_all.append(pose)

        dev = self.device

        def tensor(x):
            return torch.as_tensor(np.stack(x), dtype=torch.float32,
                                   device=dev)

        self.intrinsics_all = tensor(intrinsics_all)
        self.intrinsics_all_inv = tensor([np.linalg.inv(m)
                                          for m in intrinsics_all])
        self.pose_all = tensor(pose_all)
        self.focal = float(intrinsics_all[0][0, 0])
        self.images = tensor(imgs)  # [n, H, W, 3]
        self.masks = tensor(masks)  # [n, H, W, 1]
        self.H, self.W = int(self.images.shape[1]), int(self.images.shape[2])
        self.image_pixels = self.H * self.W

        object_scale_mat = np.load(
            os.path.join(self.data_dir, object_cameras_name))["scale_mat_0"]
        bb_min = np.array([-1.01, -1.01, -1.01, 1.0])
        bb_max = np.array([1.01, 1.01, 1.01, 1.0])
        inv0 = np.linalg.inv(self.scale_mats_np[0])
        self.object_bbox_min = (inv0 @ object_scale_mat @ bb_min[:, None])[:3, 0]
        self.object_bbox_max = (inv0 @ object_scale_mat @ bb_max[:, None])[:3, 0]

    # --------------------------------------------------------------- rays
    def _pixel_rays(self, img_idx, px, py):
        """Pixel coordinates [N] (f32) of image ``img_idx`` (an int, or a
        [1] int64 tensor on the device) -> (rays_o [N, 3], rays_v [N, 3])
        in world space."""
        if torch.is_tensor(img_idx):  # read on the device, not the host
            k_inv = self.intrinsics_all_inv.index_select(0, img_idx)[0]
            pose = self.pose_all.index_select(0, img_idx)[0]
        else:
            k_inv, pose = self.intrinsics_all_inv[img_idx], self.pose_all[img_idx]
        p = torch.stack([px, py, torch.ones_like(px)], dim=-1)
        p = p @ k_inv[:3, :3].T
        rays_v = p / torch.linalg.norm(p, dim=-1, keepdim=True)
        rays_v = rays_v @ pose[:3, :3].T
        rays_o = pose[:3, 3].expand(rays_v.shape)
        return rays_o, rays_v

    def _pixel_grid(self, resolution_level):
        lvl = resolution_level
        tx = linspace(0, self.W - 1, self.W // lvl, device=self.device)
        ty = linspace(0, self.H - 1, self.H // lvl, device=self.device)
        gy, gx = torch.meshgrid(ty, tx, indexing="ij")
        return gx, gy

    def gen_rays_at(self, img_idx, resolution_level=1):
        """Rays of a whole image, subsampled by resolution_level:
        ([H', W', 3], [H', W', 3])."""
        gx, gy = self._pixel_grid(resolution_level)
        rays_o, rays_v = self._pixel_rays(img_idx, gx.reshape(-1),
                                          gy.reshape(-1))
        shape = (*gx.shape, 3)
        return rays_o.reshape(shape), rays_v.reshape(shape)

    def gen_random_rays_at(self, img_idx, batch_size, generator=None, px=None,
                           py=None):
        """Random pixels of one image -> [B, 10] (o, v, rgb, mask).  The
        image is an int or a 0-dim or [1] integer tensor on the device (a
        CUDA graph reads it there); the pixel coordinates ``px``, ``py``
        [B] (int) are drawn from ``generator`` unless given."""
        dev = self.images.device
        if torch.is_tensor(img_idx):
            img = img_idx.reshape(1).to(torch.int64)
        else:
            img = torch.full((1,), int(img_idx), dtype=torch.int64, device=dev)
        if px is None:
            px = torch.randint(0, self.W, (batch_size,), generator=generator,
                               device=dev)
        if py is None:
            py = torch.randint(0, self.H, (batch_size,), generator=generator,
                               device=dev)
        px, py = px.to(dev, torch.int64), py.to(dev, torch.int64)
        pixel = (img * self.H + py) * self.W + px
        color = self.images.reshape(-1, self.images.shape[-1])[pixel]
        mask = self.masks.reshape(-1, self.masks.shape[-1])[pixel]
        rays_o, rays_v = self._pixel_rays(img, px.float(), py.float())
        return torch.cat([rays_o, rays_v, color, mask[:, :1]], dim=-1)

    def gen_rays_between(self, idx_0, idx_1, ratio, resolution_level=1):
        """Rays of a pose interpolated between two cameras (slerp of the
        rotations, lerp of the centres), with camera 0's intrinsics."""
        from scipy.spatial.transform import Rotation as Rot
        from scipy.spatial.transform import Slerp

        gx, gy = self._pixel_grid(resolution_level)
        p = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1).reshape(-1, 3)
        p = p @ self.intrinsics_all_inv[0, :3, :3].T
        rays_v = p / torch.linalg.norm(p, dim=-1, keepdim=True)

        pose_0 = np.linalg.inv(self.pose_all[idx_0].cpu().numpy())
        pose_1 = np.linalg.inv(self.pose_all[idx_1].cpu().numpy())
        rots = Rot.from_matrix(np.stack([pose_0[:3, :3], pose_1[:3, :3]]))
        rot = Slerp([0, 1], rots)(ratio).as_matrix()
        pose = np.eye(4, dtype=np.float32)
        pose[:3, :3] = rot
        pose[:3, 3] = ((1.0 - ratio) * pose_0 + ratio * pose_1)[:3, 3]
        pose = torch.as_tensor(np.linalg.inv(pose), dtype=torch.float32,
                               device=rays_v.device)
        rays_v = rays_v @ pose[:3, :3].T
        rays_o = pose[:3, 3].expand(rays_v.shape)
        shape = (*gx.shape, 3)
        return rays_o.reshape(shape), rays_v.reshape(shape)

    @staticmethod
    def near_far_from_sphere(rays_o, rays_d):
        """Where each ray meets the unit sphere's bounds: (near, far) [N, 1]."""
        a = torch.sum(rays_d ** 2, dim=-1, keepdim=True)
        b = 2.0 * torch.sum(rays_o * rays_d, dim=-1, keepdim=True)
        mid = 0.5 * (-b) / a
        return mid - 1.0, mid + 1.0

    def image_at(self, idx, resolution_level):
        """Image ``idx`` as uint8 RGB, shrunk by ``resolution_level``."""
        img = (self.images[idx].cpu().numpy() * 255).astype(np.uint8)
        return resize_linear_u8(img, self.W // resolution_level,
                                self.H // resolution_level)

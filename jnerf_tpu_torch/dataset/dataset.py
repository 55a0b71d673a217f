"""Camera-pose conversion and ray generation on device tensors.

Counterpart of the pose helpers, ``rays_from_pixels`` and
``rays_for_image`` of `jnerf_tpu/dataset/dataset.py`.  The blender/NGP-json ``NerfDataset``
loader is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch


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

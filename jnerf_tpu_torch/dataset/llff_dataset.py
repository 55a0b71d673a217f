"""LLFF real-capture dataset (poses_bounds.npy + images_{factor}/).

Counterpart of `jnerf_tpu/dataset/llff_dataset.py`: the same axis swap,
bound rescale and recentre, and the ``llffhold`` splits persisted in
``split.json``.  ``_minify`` writes ``images_{factor}/`` as PNGs with no
cv2: an area mean over factor x factor blocks that rounds as
``cv2.resize(..., INTER_AREA)`` does on 8-bit data (`_area_downsize`).
An existing ``images_{factor}/`` is read as it is; JPEG sources decode
through the port's codec (`dataset_util.read_image_u8`), so a capture
minifies on a machine without imageio or cv2 too.
"""

from __future__ import annotations

import json
import os

import numpy as np

from jnerf_tpu_torch.utils.registry import DATASETS
from .dataset import NerfDataset, matrix_nerf2ngp
from .dataset_util import NERF_SCALE, encode_png, read_image, read_image_u8


def _normalize(v):
    return v / np.linalg.norm(v)


def _viewmatrix(z, up, pos):
    vec2 = _normalize(z)
    vec0 = _normalize(np.cross(up, vec2))
    vec1 = _normalize(np.cross(vec2, vec0))
    return np.stack([vec0, vec1, vec2, pos], axis=1)


def _poses_avg(poses):
    center = poses[:, :3, 3].mean(0)
    vec2 = _normalize(poses[:, :3, 2].sum(0))
    up = poses[:, :3, 1].sum(0)
    return _viewmatrix(vec2, up, center)


def _recenter_poses(poses):
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :4] = _poses_avg(poses)
    bottom = np.tile(np.array([[[0, 0, 0, 1.0]]], np.float32), (len(poses), 1, 1))
    homog = np.concatenate([poses[:, :3, :4], bottom], axis=1)
    out = np.linalg.inv(c2w) @ homog
    return out[:, :3, :4].astype(np.float32)


def _area_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] share of each input pixel in each output pixel of an
    area resize (output pixel i covers [i, i + 1) * n_in / n_out)."""
    s = n_in / n_out
    lo = np.arange(n_out)[:, None] * s
    k = np.arange(n_in)[None, :]
    return np.clip(np.minimum(lo + s, k + 1) - np.maximum(lo, k), 0, None) / s


def _area_downsize(img: np.ndarray, factor: int) -> np.ndarray:
    """uint8 [H, W(, C)] -> [H // factor, W // factor(, C)] as
    ``cv2.resize(img, (W // f, H // f), interpolation=INTER_AREA)``: where
    the factor divides both sides, the block mean, rounded half up at
    factor 2 (cv2's vector path, (sum + 2) >> 2) and half to even
    otherwise; else the area-weighted mean, rounded half to even (cv2 sums
    in float there, so a pixel may differ from it by one level)."""
    h, w = img.shape[:2]
    oh, ow = h // factor, w // factor
    x = img.astype(np.int64)
    if oh * factor == h and ow * factor == w:
        s = x.reshape(oh, factor, ow, factor, *img.shape[2:]).sum(axis=(1, 3))
        if factor == 2:
            return ((s + 2) >> 2).astype(np.uint8)
        return np.rint(s / (factor * factor)).astype(np.uint8)
    out = np.einsum("ih,hw...->iw...", _area_weights(h, oh), x.astype(np.float64))
    out = np.einsum("jw,iw...->ij...", _area_weights(w, ow), out)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


@DATASETS.register_module()
class LLFFDataset(NerfDataset):
    def __init__(self, root_dir, batch_size, mode="train", factor=4, llffhold=0,
                 recenter=True, bd_factor=0.75, spherify=False,
                 correct_pose=(1, -1, -1), aabb_scale=None, scale=None,
                 offset=None, img_alpha=True, have_img=True,
                 preload_shuffle=True, device=None):
        del spherify  # accepted as the JAX package accepts it, unused
        self.factor = int(factor)
        self.llffhold = llffhold
        self.recenter = recenter
        self.bd_factor = bd_factor
        if aabb_scale is None:
            print("LLFF dataset needs aabb_scale in the config; defaulting to 32")
            aabb_scale = 32
        super().__init__(
            root_dir=root_dir, batch_size=batch_size, mode=mode,
            correct_pose=correct_pose, aabb_scale=aabb_scale,
            scale=NERF_SCALE if scale is None else scale, offset=offset,
            img_alpha=img_alpha, have_img=have_img,
            preload_shuffle=preload_shuffle, device=device,
        )

    # --------------------------------------------------------------- loading
    def _minify(self):
        """Write images_{factor}/ as PNGs unless it exists; returns it."""
        src = os.path.join(self.root_dir, "images")
        dst = os.path.join(self.root_dir, f"images_{self.factor}")
        if os.path.isdir(dst):
            return dst
        names = sorted(
            f for f in os.listdir(src)
            if f.lower().endswith((".jpg", ".jpeg", ".png"))
        )
        # Decode every source before the directory exists, so that a source
        # this machine cannot read leaves no half-written images_{factor}/.
        small = [_area_downsize(read_image_u8(os.path.join(src, name)),
                                self.factor) for name in names]
        os.makedirs(dst)
        for name, img in zip(names, small):
            stem = os.path.splitext(name)[0]
            with open(os.path.join(dst, stem + ".png"), "wb") as f:
                f.write(encode_png(img))
        return dst

    def load_data(self):
        root_dir = self.root_dir
        arr = np.load(os.path.join(root_dir, "poses_bounds.npy"))
        poses = arr[:, :-2].reshape(-1, 3, 5)  # [N, 3, 5]
        bds = arr[:, -2:]  # [N, 2]
        n_total = len(poses)

        img_dir = self._minify()
        img_files = sorted(
            os.path.join(img_dir, f) for f in os.listdir(img_dir)
            if f.lower().endswith((".jpg", ".png"))
        )
        assert len(img_files) == n_total, (len(img_files), n_total)

        first = read_image(img_files[0])
        self.H, self.W = int(first.shape[0]), int(first.shape[1])
        focal = float(poses[0, 2, 4]) / self.factor
        hwf_poses = poses[:, :3, :4].copy()
        # LLFF [down, right, back] -> [right, up, back].
        hwf_poses = np.concatenate(
            [hwf_poses[:, :, 1:2], -hwf_poses[:, :, 0:1], hwf_poses[:, :, 2:]],
            axis=2,
        )
        sc = 1.0 if self.bd_factor is None else 1.0 / (bds.min() * self.bd_factor)
        hwf_poses[:, :3, 3] *= sc
        if self.recenter:
            hwf_poses = _recenter_poses(hwf_poses)

        # Splits: llffhold stride or the view closest to the average pose.
        if self.llffhold and self.llffhold > 0:
            i_test = np.arange(n_total)[:: self.llffhold]
        else:
            c2w = _poses_avg(hwf_poses)
            dists = np.sum((c2w[:3, 3] - hwf_poses[:, :3, 3]) ** 2, -1)
            i_test = np.array([int(np.argmin(dists))])
        i_val = i_test
        i_train = np.array(
            [i for i in range(n_total) if i not in i_test and i not in i_val]
        )
        split_path = os.path.join(root_dir, "split.json")
        if not os.path.exists(split_path):
            with open(split_path, "w") as f:
                json.dump(
                    {"train": i_train.tolist(), "test": i_test.tolist(),
                     "val": i_val.tolist()}, f,
                )
        else:
            with open(split_path) as f:
                splits = json.load(f)
            i_train = np.asarray(splits["train"])
            i_val = np.asarray(splits["val"])
            i_test = np.asarray(splits["test"])
        i_select = {"train": i_train, "val": i_val, "test": i_test}[self.mode]

        images, transforms = [], []
        for i in i_select.tolist():
            images.append(read_image(img_files[i]))
            transforms.append(
                matrix_nerf2ngp(hwf_poses[i], self.scale, self.offset,
                                self.correct_pose)
            )
        self.n_images = len(images)
        self.resolution = [self.W, self.H]
        self.aabb_range = (0.5 - self.aabb_scale / 2, 0.5 + self.aabb_scale / 2)

        meta = np.zeros([11], np.float32)
        meta[4:6] = 0.5
        meta[6:8] = focal
        self.metadata = np.tile(meta[None], (self.n_images, 1))
        self._to_device(images, transforms,
                        np.full((self.n_images, 2), focal, np.float32))

"""The port's file datasets against the JAX package's: NerfDataset on the
blender-format scene, LLFFDataset on a small fake capture, and the scene
writer make_synthetic_scene."""

import os
import shutil

import numpy as np
import pytest
import torch

from jnerf_tpu.dataset.dataset import NerfDataset as JaxNerfDataset
from jnerf_tpu_torch.dataset import NerfDataset
from torch_parity import n


def _same_dataset(port, jax_ds):
    """Images, poses, intrinsics and full-image rays equal (rays rtol 1e-6:
    the same f32 operations in another library)."""
    assert (port.n_images, port.H, port.W) == (jax_ds.n_images, jax_ds.H,
                                                jax_ds.W)
    assert port.aabb_scale == jax_ds.aabb_scale
    assert port.aabb_range == jax_ds.aabb_range
    assert port.resolution == jax_ds.resolution
    np.testing.assert_array_equal(n(port.image_data), n(jax_ds.image_data))
    np.testing.assert_array_equal(n(port.transforms_gpu),
                                  n(jax_ds.transforms_gpu))
    np.testing.assert_array_equal(n(port.focal_lengths), n(jax_ds.focal_lengths))
    np.testing.assert_array_equal(n(port.principal_points),
                                  n(jax_ds.principal_points))
    np.testing.assert_array_equal(port.metadata, jax_ds.metadata)
    for i in (0, port.n_images - 1):
        for a, b in zip(port.generate_rays_total_test(i),
                        jax_ds.generate_rays_total_test(i)):
            np.testing.assert_allclose(n(a), n(b), rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(port.image(i), jax_ds.image(i))


@pytest.mark.parametrize("mode", ["train", "val", "test"])
def test_nerf_dataset_matches_jax(synthetic_scene, mode):
    """Each split as the JAX loader reads it: train also takes the val json
    (14 images), val keeps every 10th frame (1 of 2)."""
    port = NerfDataset(synthetic_scene, batch_size=64, mode=mode)
    ref = JaxNerfDataset(synthetic_scene, batch_size=64, mode=mode)
    assert port.n_images == {"train": 14, "val": 1, "test": 2}[mode]
    _same_dataset(port, ref)
    assert port.image_data.dtype == torch.float32
    assert port.image_data.device.type == "cpu"
    pose = np.eye(3, 4, dtype=np.float32)
    pose[:, 3] = [0.0, 0.0, 4.0]
    for a, b in zip(port.generate_rays_with_pose(pose),
                    ref.generate_rays_with_pose(pose)):
        np.testing.assert_allclose(n(a), n(b), rtol=1e-6, atol=1e-7)


def test_nerf_dataset_without_images(synthetic_scene):
    """have_img=False: zero RGB images with alpha one, as the JAX loader
    makes them, at the json's size."""
    port = NerfDataset(synthetic_scene, batch_size=64, mode="test", H=64,
                       W=64, have_img=False)
    ref = JaxNerfDataset(synthetic_scene, batch_size=64, mode="test", H=64,
                         W=64, have_img=False)
    _same_dataset(port, ref)
    assert float(port.image_data[:, 3].min()) == 1.0


def test_nerf_dataset_json_keys(tmp_path, synthetic_scene):
    """A json with fl_x / fl_y, cx / cy, the distortion keys and
    aabb_scale, and file paths that carry no .png, reads as the JAX loader
    reads it."""
    import json

    root = tmp_path / "keys"
    shutil.copytree(synthetic_scene, root)
    with open(root / "transforms_test.json") as f:
        data = json.load(f)
    del data["camera_angle_x"]
    data.update(fl_x=70.5, fl_y=71.25, cx=30.0, cy=33.5, k1=0.01, k2=-0.002,
                p1=0.0005, p2=0.0001, aabb_scale=4)
    with open(root / "transforms_test.json", "w") as f:
        json.dump(data, f)
    port = NerfDataset(str(root), batch_size=8, mode="test")
    _same_dataset(port, JaxNerfDataset(str(root), batch_size=8, mode="test"))
    assert port.aabb_scale == 4 and port.metadata[0, 0] == np.float32(0.01)


def test_make_synthetic_scene_matches_jax(tmp_path):
    """The port's scene writer and the JAX package's write the same cameras
    and, decoded, the same images for one seed."""
    import json

    from jnerf_tpu.dataset.synthetic import make_synthetic_scene as jax_make
    from jnerf_tpu_torch.dataset.dataset_util import read_image
    from jnerf_tpu_torch.dataset.synthetic import make_synthetic_scene

    kw = dict(n_train=3, n_val=1, n_test=2, H=24, W=32, seed=5)
    a = make_synthetic_scene(str(tmp_path / "port"), **kw)
    b = jax_make(str(tmp_path / "jax"), **kw)
    for split in ("train", "val", "test"):
        with open(os.path.join(a, f"transforms_{split}.json")) as f:
            ja = json.load(f)
        with open(os.path.join(b, f"transforms_{split}.json")) as f:
            jb = json.load(f)
        assert ja == jb
        for frame in ja["frames"]:
            np.testing.assert_array_equal(
                read_image(os.path.join(a, frame["file_path"] + ".png")),
                read_image(os.path.join(b, frame["file_path"] + ".png")))


@pytest.fixture()
def llff_scene(tmp_path):
    """A small fake LLFF capture, as tests/test_datasets.py builds it: 6
    images of 64 x 96 (PNG), poses_bounds.npy; copied twice, one copy per
    package, since each minifies into its own images_{factor}/."""
    from jnerf_tpu.dataset.dataset_util import write_image

    rng = np.random.default_rng(0)
    root = tmp_path / "port"
    (root / "images").mkdir(parents=True)
    H, W, focal, count = 64, 96, 80.0, 6
    poses = np.zeros((count, 3, 5), np.float32)
    for i in range(count):
        c2w = np.eye(3, 4, dtype=np.float32)
        c2w[:, 3] = [0.1 * i, 0.05 * i, 2.0]
        poses[i, :, :4] = c2w
        poses[i, :, 4] = [H, W, focal]
        write_image(str(root / "images" / f"img_{i:02d}.png"),
                    rng.uniform(0, 1, (H, W, 3)).astype(np.float32))
    bounds = np.tile(np.array([[1.0, 6.0]], np.float32), (count, 1))
    np.save(root / "poses_bounds.npy",
            np.concatenate([poses.reshape(count, 15), bounds], axis=1))
    shutil.copytree(root, tmp_path / "jax")
    return str(root), str(tmp_path / "jax")


@pytest.mark.parametrize("factor", [2, 3])
def test_llff_dataset_matches_jax(llff_scene, factor):
    """Splits, poses, intrinsics and rays equal the JAX loader's; the
    images minified without cv2 equal cv2's INTER_AREA bit for bit at
    factor 2 (64 x 96 divides: cv2's rounding of the block mean is
    reproduced), and within one 8-bit level at factor 3 (64 does not
    divide by 3: cv2 sums the partial-pixel areas in float, and a sum at a
    rounding midpoint can land on either side)."""
    from jnerf_tpu.dataset.llff_dataset import LLFFDataset as JaxLLFF
    from jnerf_tpu_torch.dataset import LLFFDataset

    port_root, jax_root = llff_scene
    for mode in ("train", "test"):
        port = LLFFDataset(port_root, batch_size=32, mode=mode, factor=factor,
                           llffhold=3, aabb_scale=16)
        ref = JaxLLFF(jax_root, batch_size=32, mode=mode, factor=factor,
                      llffhold=3, aabb_scale=16)
        assert port.n_images == {"train": 4, "test": 2}[mode]
        assert (port.H, port.W) == (64 // factor, 96 // factor)
        diff = np.abs(n(port.image_data) - n(ref.image_data))
        if factor == 2:
            assert diff.max() == 0
        else:
            assert diff.max() <= 1.0 / 255 + 1e-7
        np.testing.assert_allclose(n(port.transforms_gpu),
                                   n(ref.transforms_gpu), rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(n(port.focal_lengths),
                                      n(ref.focal_lengths))
        np.testing.assert_array_equal(n(port.principal_points),
                                      n(ref.principal_points))
    with open(os.path.join(port_root, "split.json")) as f, \
            open(os.path.join(jax_root, "split.json")) as g:
        assert f.read() == g.read()


def test_llff_reads_an_existing_minified_directory(llff_scene, monkeypatch):
    """An images_{factor}/ directory that exists is read as it is (a
    capture minified elsewhere), without the source images."""
    from jnerf_tpu_torch.dataset import LLFFDataset

    port_root, _ = llff_scene
    LLFFDataset(port_root, batch_size=32, factor=2, llffhold=3, aabb_scale=16)
    shutil.rmtree(os.path.join(port_root, "images"))
    ds = LLFFDataset(port_root, batch_size=32, mode="test", factor=2,
                     llffhold=3, aabb_scale=16)
    assert ds.n_images == 2 and ds.image_data.shape == (2 * 32 * 48, 4)

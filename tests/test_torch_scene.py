"""The port's analytic scenes against the JAX package's, on the CPU: the
hard quality scene's objects, its supersampled images and the dataset
built from it (`jnerf_tpu_torch/dataset/{synthetic,procedural}.py`)."""

import numpy as np
import pytest

from torch_parity import n

CAMERA_ANGLE_X = 0.6911112070083618


def _poses(k, seed=0):
    from jnerf_tpu.dataset.synthetic import _look_at_pose

    rng = np.random.default_rng(seed)
    poses = []
    for _ in range(k):
        theta = rng.uniform(0, 2 * np.pi)
        phi = np.radians(rng.uniform(-20, 50))
        eye = 4.0 * np.array([np.cos(theta) * np.cos(phi),
                              np.sin(theta) * np.cos(phi), np.sin(phi)])
        poses.append(_look_at_pose(eye))
    return poses


def test_hard_scene_arrays_equal_jax():
    """The 104 objects (4 textured spheres, a 72-sphere helix, a 28-sphere
    ring): centers, radii, colours, texture frequencies and phases equal."""
    from jnerf_tpu.dataset.synthetic import _scene_arrays as jax_arrays
    from jnerf_tpu_torch.dataset.synthetic import _scene_arrays

    got, want = _scene_arrays("hard"), jax_arrays("hard")
    assert len(got[1]) == 104 and int((got[3] > 0).sum()) == 4
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("ssaa", [1, 2])
@pytest.mark.parametrize("scene", ["hard", "spheres"])
def test_render_analytic_matches_jax(scene, ssaa):
    """24x24 images from three poses: the same float64 arithmetic in the
    same order on the CPU, so atol 1e-6 on the float32 RGBA (equal bit for
    bit on the reference CPU), with soft edges at ssaa 2."""
    from jnerf_tpu.dataset.synthetic import render_analytic as jax_render
    from jnerf_tpu_torch.dataset.synthetic import render_analytic

    for pose in _poses(3):
        want = jax_render(pose, 24, 24, CAMERA_ANGLE_X, scene=scene, ssaa=ssaa)
        got = n(render_analytic(pose, 24, 24, CAMERA_ANGLE_X, scene=scene,
                                ssaa=ssaa))
        assert got.dtype == np.float32 and got.shape == (24, 24, 4)
        assert got[..., 3].max() == 1.0  # the scene is in view
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        fractional = (want[..., 3] > 0) & (want[..., 3] < 1)
        assert fractional.any() == (ssaa > 1)


@pytest.mark.parametrize("mode", ["train", "val"])
def test_hard_dataset_matches_jax(mode, tmp_path, monkeypatch):
    """SyntheticSpheresDataset(scene='hard', ssaa=2) at 16x16: the same
    poses, so transforms and focal lengths equal, and images at atol 1e-6
    as above.  The JAX package's npz cache goes to a temporary directory."""
    from jnerf_tpu.dataset.procedural import SyntheticSpheresDataset as JaxDS
    from jnerf_tpu_torch.dataset import SyntheticSpheresDataset

    monkeypatch.setenv("JNERF_SCENE_CACHE", str(tmp_path))
    kw = dict(mode=mode, n_images=3, H=16, W=16, scene="hard", ssaa=2)
    jds, tds = JaxDS(**kw), SyntheticSpheresDataset(device="cpu", **kw)
    np.testing.assert_array_equal(n(tds.transforms_gpu), n(jds.transforms_gpu))
    np.testing.assert_array_equal(n(tds.focal_lengths), n(jds.focal_lengths))
    assert tds.image_data.shape == (3 * 16 * 16, 4)
    np.testing.assert_allclose(n(tds.image_data), n(jds.image_data), rtol=0,
                               atol=1e-6)


def test_unknown_scene_raises():
    from jnerf_tpu_torch.dataset.synthetic import render_analytic

    with pytest.raises(ValueError, match="unknown scene"):
        render_analytic(_poses(1)[0], 8, 8, CAMERA_ANGLE_X, scene="lego")

"""The port's render path (`Runner.render_img`, `render_test`, the
sampler's inference compositing, full-image rays, the demo camera path)
against the JAX package's, on the CPU, from the same params and grid."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_parity import both_cfgs, n, port_grid_state, t  # noqa: F401

# 256-ray chunks at the tiny config's 256 inference samples per ray: 65536
# model rows a chunk, a multiple of the fused MLP's 8192-row block.
CHUNK = 256


def _runners(both_cfgs, pallas_mlp):
    """A JAX runner after its step-0 grid refresh and a port runner with
    its params and grid state converted, both with the test split built
    and CHUNK-ray render chunks."""
    from jnerf_tpu.runner import Runner as JaxRunner
    from jnerf_tpu.utils.registry import DATASETS as JAX_DATASETS
    from jnerf_tpu.utils.registry import build_from_cfg as jax_build
    from jnerf_tpu_torch.runner import Runner
    from jnerf_tpu_torch.utils.convert import jax_params_to_state_dict
    from jnerf_tpu_torch.utils.registry import DATASETS, build_from_cfg

    for cfg in both_cfgs:
        cfg.use_pallas_mlp = pallas_mlp
    jr = JaxRunner()
    jr._update_grid(0, jax.random.PRNGKey(1))
    jr.dataset["test"] = jax_build(both_cfgs[0].dataset.test, JAX_DATASETS)
    tr = Runner(device="cpu")
    tr.model.load_state_dict(
        jax_params_to_state_dict(jax.tree.map(np.asarray, jr.params)))
    tr.sampler.load_state_dict(port_grid_state(jr.sampler.state))
    tr.dataset["test"] = build_from_cfg(both_cfgs[1].dataset.test, DATASETS,
                                        device="cpu")
    jr.render_chunk_rays = tr.render_chunk_rays = CHUNK
    assert jr.model._fused_ok == tr.model._fused_ok == pallas_mlp
    assert tr.sampler.inference_samples_per_ray == \
        jr.sampler.inference_samples_per_ray == 256
    return jr, tr


def _jax_render_u():
    """The jitter the JAX render draws for every chunk (PRNGKey(0))."""
    return t(jax.random.uniform(jax.random.PRNGKey(0), (CHUNK,)))


def _spy_fused(monkeypatch):
    from jnerf_tpu_torch.models.networks import ngp_network
    from jnerf_tpu_torch.ops import fused_mlp as fm

    calls = []
    real = fm.fused_ngp_mlp
    monkeypatch.setattr(ngp_network._fm, "fused_ngp_mlp",
                        lambda *a: calls.append(1) or real(*a))
    return calls


@pytest.mark.parametrize("pallas_mlp", [False, True])
def test_render_img_matches_jax(both_cfgs, monkeypatch, pallas_mlp):
    """Both test images: image, opacity and target.  The march takes the
    same samples from the same jitter; the bf16 MLP chains can differ by
    one bf16 ulp of a hidden activation (see tests/test_torch_ngp.py),
    which moves a pixel by well under 1e-3 after the sigmoid and the
    compositing: atol 1e-3 on image and opacity; the target is the same
    numpy arithmetic on the same pixels, rtol 1e-6."""
    jr, tr = _runners(both_cfgs, pallas_mlp)
    for cfg in both_cfgs:
        cfg.alpha_image = True
    jr.alpha_image = tr.alpha_image = True
    calls = _spy_fused(monkeypatch)
    for i in range(2):
        jimg, jalpha, jtar = jr.render_img(dataset_mode="test", img_id=i)
        img, alpha, tar = tr.render_img(dataset_mode="test", img_id=i,
                                        u=_jax_render_u())
        assert img.shape == (32, 32, 3) and alpha.shape == (32, 32, 1)
        assert float(np.asarray(jalpha).max()) > 0.05  # the field is seen
        np.testing.assert_allclose(img, np.asarray(jimg), rtol=0, atol=1e-3)
        np.testing.assert_allclose(alpha, np.asarray(jalpha), rtol=0,
                                   atol=1e-3)
        np.testing.assert_allclose(tar, np.asarray(jtar), rtol=1e-6)
    # 4 chunks of 256 rays per 32x32 image.
    assert len(calls) == (8 if pallas_mlp else 0)


@pytest.mark.parametrize("pallas_mlp", [False, True])
def test_render_test_mse_matches_jax(both_cfgs, pallas_mlp):
    """The render_test MSE list (background composited in): the images
    agree to 1e-3 per pixel, so each MSE to rtol 1e-2."""
    jr, tr = _runners(both_cfgs, pallas_mlp)
    jmse = jr.render_test(save_img=False)
    mse = tr.render_test(save_img=False, u=_jax_render_u())
    assert len(mse) == len(jmse) == 2
    np.testing.assert_allclose(mse, jmse, rtol=1e-2)


def test_rays_for_image_matches_jax():
    """Row-major full-image rays of a NeRF pose, with an off-centre
    principal point: f32 arithmetic in another order, atol 1e-6."""
    from jnerf_tpu.dataset.dataset import rays_for_image as jax_rays
    from jnerf_tpu.dataset.dataset import matrix_nerf2ngp
    from jnerf_tpu_torch.dataset.camera_path import pose_spherical
    from jnerf_tpu_torch.dataset.dataset import rays_for_image

    pose = matrix_nerf2ngp(pose_spherical(30.0, -30.0, 4.0), 0.33,
                           [0.5, 0.5, 0.5])
    fl = np.array([40.0, 42.0], np.float32)
    pp = np.array([0.45, 0.55], np.float32)
    jo, jd = jax_rays(jnp.asarray(pose), jnp.asarray(fl), jnp.asarray(pp),
                      24, 16)
    ro, rd = rays_for_image(t(pose), t(fl), t(pp), 24, 16)
    assert ro.shape == rd.shape == (24 * 16, 3)
    np.testing.assert_allclose(n(ro), n(jo), rtol=0, atol=1e-6)
    np.testing.assert_allclose(n(rd), n(jd), rtol=0, atol=1e-6)


def test_inference_composite_matches_jax(both_cfgs):
    """composite(inference=True) returns (rgb, opacity) with no background
    term, as the JAX sampler's: the same f32 formulas, atol 1e-6."""
    from jnerf_tpu.runner import Runner as JaxRunner
    from jnerf_tpu.ops.ray_march import RaySamples as JaxSamples
    from jnerf_tpu_torch.ops.ray_march import RaySamples
    from jnerf_tpu_torch.runner import Runner

    jr, tr = JaxRunner(), Runner(device="cpu")
    rng = np.random.default_rng(6)
    r, s = 64, 32
    raw = rng.normal(size=(r * s, 4)).astype(np.float32)
    dts = rng.uniform(0, 0.05, size=(r, s)).astype(np.float32)
    valid = rng.uniform(size=(r, s)) < 0.7
    zeros = np.zeros((r, s, 3), np.float32)
    jsamp = JaxSamples(zeros, zeros, jnp.asarray(dts), jnp.asarray(valid),
                       None, None, None)
    samp = RaySamples(t(zeros), t(zeros), t(dts), t(valid), None, None, None)
    jrgb, jop = jr.sampler.composite(jsamp, jnp.asarray(raw), inference=True)
    rgb, op = tr.sampler.composite(samp, t(raw), inference=True)
    np.testing.assert_allclose(n(rgb), n(jrgb), rtol=0, atol=1e-6)
    np.testing.assert_allclose(n(op), n(jop), rtol=0, atol=1e-6)
    # Training compositing adds the background over what is left.
    bg = rng.uniform(size=(r, 3)).astype(np.float32)
    np.testing.assert_allclose(
        n(tr.sampler.composite(samp, t(raw), background=t(bg))),
        n(jr.sampler.composite(jsamp, jnp.asarray(raw),
                               background=jnp.asarray(bg))),
        rtol=0, atol=1e-6)


def test_path_spherical_matches_jax():
    """The demo orbit is the same numpy arithmetic: exact."""
    from jnerf_tpu.dataset import camera_path as jcp
    from jnerf_tpu_torch.dataset import camera_path as cp

    got, want = cp.path_spherical(12), jcp.path_spherical(12)
    assert len(got) == 12
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)

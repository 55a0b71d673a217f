"""The reference-signature methods of the port against the JAX package's:
`DensityGridSampler.sample` / `rays2rgb`, and the batch methods
`sample_batch`, `__next__` and `__iter__` of `NerfDataset` and
`SyntheticSpheresDataset`, from the same draws."""

import jax
import numpy as np
import pytest
import torch

from torch_parity import both_cfgs, j, n, port_grid_state, t  # noqa: F401


def _same_batch(port, ref):
    """(img_ids, rays_o, rays_d, rgba): ids and pixels equal, rays at rtol
    1e-6 (the same f32 operations in another library)."""
    np.testing.assert_array_equal(n(port[0]), n(ref[0]))
    for a, b in zip(port[1:3], ref[1:3]):
        np.testing.assert_allclose(n(a), n(b), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(n(port[3]), n(ref[3]))


@pytest.mark.parametrize("is_training", [True, False])
def test_sampler_sample_and_rays2rgb_match_jax(both_cfgs, is_training):
    """On the JAX step-0 grid, a batch of the JAX key's pixels (the
    port's sample_batch; on the JAX side rays_from_pixels, as its
    sample_batch computes them) marched by sample() (the JAX key's start
    jitter passed in as u) gives the same flattened positions and dirs
    (rtol 1e-5 / atol 1e-6: the march's f32 arithmetic in another
    library), the same measured demand when training, and rays2rgb
    composites the same random raw outputs alike: over the default and a
    given background in training, as (rgb, opacity) in inference, at rtol
    1e-5 / atol 1e-6."""
    from jnerf_tpu.dataset.dataset import rays_from_pixels
    from jnerf_tpu.runner import Runner as JaxRunner
    from jnerf_tpu_torch.runner import Runner

    jr = JaxRunner()
    jr._update_grid(0, jax.random.PRNGKey(1))
    tr = Runner(device="cpu")
    tr.sampler.load_state_dict(port_grid_state(jr.sampler.state))
    js, ts = jr.sampler, tr.sampler
    key_batch, key_march = jax.random.split(jax.random.PRNGKey(5))
    ds, jds = tr.dataset["train"], jr.dataset["train"]
    n_pixels = ds.n_images * ds.H * ds.W
    idx = jax.random.randint(key_batch, (ds.batch_size,), 0, n_pixels)
    batch = (*rays_from_pixels(idx, jds.transforms_gpu, jds.focal_lengths,
                               jds.principal_points, jds.W, jds.H),
             jds.image_data[idx])
    port_batch = ds.sample_batch(idx=t(idx, torch.int64))
    _same_batch(port_batch, batch)

    img_ids, rays_o, rays_d, _ = batch
    u = jax.random.uniform(key_march, (rays_o.shape[0],))
    jpos, jdir = js.sample(img_ids, rays_o, rays_d, is_training=is_training,
                           key=key_march)
    ts.state["measured_batch_size"] = torch.zeros((), dtype=torch.int64)
    pos, dirs = ts.sample(port_batch[0], port_batch[1], port_batch[2],
                          is_training=is_training, u=t(u))
    np.testing.assert_allclose(n(pos), n(jpos), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(n(dirs), n(jdir), rtol=1e-5, atol=1e-6)
    assert int(ts.state["measured_batch_size"]) == int(
        js.state["measured_batch_size"]) == (
        int(js._last_samples.count.sum()) if is_training else 0)

    raw = np.random.default_rng(3).normal(size=(pos.shape[0], 4)).astype(
        np.float32)
    if is_training:
        bg = np.random.default_rng(4).uniform(size=(rays_o.shape[0], 3))
        bg = bg.astype(np.float32)
        pairs = [(ts.rays2rgb(t(raw)), js.rays2rgb(j(raw))),
                 (ts.rays2rgb(t(raw), t(bg)), js.rays2rgb(j(raw), j(bg)))]
    else:
        pairs = list(zip(ts.rays2rgb(t(raw), inference=True),
                         js.rays2rgb(j(raw), inference=True)))
    for got, ref in pairs:
        np.testing.assert_allclose(n(got), n(ref), rtol=1e-5, atol=1e-6)


def test_sampler_wrappers_refuse_a_missing_march(both_cfgs):
    """rays2rgb before any sample() raises rather than compositing
    nothing."""
    from jnerf_tpu_torch.runner import Runner

    tr = Runner(device="cpu")
    with pytest.raises(RuntimeError, match="sample"):
        tr.sampler.rays2rgb(torch.zeros((4, 4)))


def test_nerf_dataset_batches_match_jax(synthetic_scene):
    """NerfDataset: sample_batch of the JAX key's pixels, and two steps of
    the iterator, whose pixels both packages draw from numpy's
    default_rng(0), give the same batches; iter(ds) is ds, and
    sample_batch draws batch_size pixels from a generator when given
    none."""
    from jnerf_tpu.dataset.dataset import NerfDataset as JaxNerfDataset
    from jnerf_tpu_torch.dataset import NerfDataset

    port = NerfDataset(synthetic_scene, batch_size=64)
    ref = JaxNerfDataset(synthetic_scene, batch_size=64)
    key = jax.random.PRNGKey(2)
    idx = jax.random.randint(key, (64,), 0, ref.n_images * ref.H * ref.W)
    _same_batch(port.sample_batch(idx=t(idx, torch.int64)),
                ref.sample_batch(key))
    assert iter(port) is port
    for _ in range(2):
        _same_batch(next(port), next(ref))
    drawn = port.sample_batch(torch.Generator().manual_seed(0))
    assert [tuple(x.shape) for x in drawn] == [(64,), (64, 3), (64, 3),
                                               (64, 4)]


def test_synthetic_dataset_iterates_like_jax():
    """SyntheticSpheresDataset's iterator draws the JAX dataset's pixels
    (numpy's default_rng(seed)) and gives the same batches."""
    from jnerf_tpu.dataset.procedural import (
        SyntheticSpheresDataset as JaxSpheres,
    )
    from jnerf_tpu_torch.dataset import SyntheticSpheresDataset

    kw = dict(batch_size=32, n_images=2, H=8, W=8, seed=3)
    port, ref = SyntheticSpheresDataset(**kw), JaxSpheres(**kw)
    assert iter(port) is port
    for _ in range(2):
        _same_batch(next(port), next(ref))

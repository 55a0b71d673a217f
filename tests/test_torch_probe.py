"""The probe-mode grid refresh in the port (`ops.occupancy`'s
generate_grid_samples, splat_density and ema_grid_update, and the
sampler's probe branch) against the JAX package's on the CPU, with the
JAX keys' draws passed in, at the tiny NGP size of tests/torch_parity.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import both_cfgs, n, port_grid_state, t  # noqa: F401

from jnerf_tpu.ops import occupancy as jocc
from jnerf_tpu_torch.ops import occupancy as tocc


def jax_probe_draws(key, n_samples: int, n_cascades: int):
    """The cascade and jitter draws JAX's generate_grid_samples makes from
    its key (`jnerf_tpu/ops/occupancy.py:217-238`): (level [n], jitter
    [3, n])."""
    k_level, *k_xyz = jax.random.split(key, 4)
    level = jax.random.randint(k_level, (n_samples,), 0, n_cascades)
    jitter = np.stack([n(jax.random.uniform(k, (n_samples,))) for k in k_xyz])
    return t(level, torch.int64), t(jitter)


def _configs():
    jg = jocc.make_grid_config((-1.5, 2.5), grid_size=32, max_steps=128)
    tg = tocc.make_grid_config((-1.5, 2.5), grid_size=32, max_steps=128)
    assert jg.max_cascade == tg.max_cascade == 2
    return jg, tg


@pytest.mark.parametrize("step,thresh", [(0, -0.01), (3, 0.01), (70000, 0.01)])
def test_generate_grid_samples_matches_jax(step, thresh):
    """The probe sequence (uint32 arithmetic, wrapping for a large step),
    the first passing probe else the last, and the jittered positions: the
    same cells, and positions equal (the same f32 operations in the same
    order)."""
    jg, tg = _configs()
    rng = np.random.default_rng(step)
    shape = (tg.n_cascades, 32, 32, 32)
    grid = rng.exponential(0.01, size=shape).astype(np.float32)
    grid[rng.uniform(size=shape) < 0.2] = -1.0
    key = jax.random.PRNGKey(step)
    n_samples = 4096
    jidx, jpos = jocc.generate_grid_samples(key, jnp.asarray(grid), step,
                                            n_samples, thresh, jg)
    level, jitter = jax_probe_draws(key, n_samples, jg.max_cascade + 1)
    idx, pos = tocc.generate_grid_samples(t(grid), step, n_samples, thresh, tg,
                                          level=level, jitter=jitter)
    np.testing.assert_array_equal(n(idx), n(jidx))
    for got, want in zip(pos, jpos):
        np.testing.assert_array_equal(n(got), n(want))
    # A generator draws as many cells, inside the active cascades.
    idx, pos = tocc.generate_grid_samples(
        t(grid), step, n_samples, thresh, tg,
        generator=torch.Generator().manual_seed(0))
    assert idx.shape == (n_samples,) and int(idx.max()) < 3 * tg.n_cells


def test_splat_and_ema_match_jax():
    """The max-splat of exp-activated densities into repeated cells (f32
    exp: rtol 1e-6) and the decay-max EMA that keeps -1 cells."""
    jg, tg = _configs()
    rng = np.random.default_rng(5)
    shape = (tg.n_cascades, 32, 32, 32)
    idx = rng.integers(0, 3 * tg.n_cells, 20000)
    raw = rng.normal(0, 3, 20000).astype(np.float32)
    raw[:10] = 30.0  # over the density cap
    tmp = np.zeros(shape, np.float32)
    jtmp = jocc.splat_density(jnp.asarray(idx), jnp.asarray(raw),
                              jnp.asarray(tmp), jg)
    ttmp = tocc.splat_density(t(idx), t(raw), t(tmp), tg)
    np.testing.assert_allclose(n(ttmp), n(jtmp), rtol=1e-6)
    grid = rng.exponential(0.01, size=shape).astype(np.float32)
    grid[rng.uniform(size=shape) < 0.1] = -1.0
    np.testing.assert_array_equal(
        n(tocc.ema_grid_update(t(grid), ttmp, tg)),
        n(jocc.ema_grid_update(jnp.asarray(grid), jnp.asarray(n(ttmp)), jg)))


def _probe_samplers(both_cfgs):
    from jnerf_tpu.dataset.procedural import SyntheticSpheresDataset as JaxDS
    from jnerf_tpu.models.networks.ngp_network import NGPNetworks as JaxNGP
    from jnerf_tpu.models.samplers.density_grid_sampler import (
        DensityGridSampler as JaxSampler,
    )
    from jnerf_tpu_torch.dataset import SyntheticSpheresDataset
    from jnerf_tpu_torch.models.networks import NGPNetworks
    from jnerf_tpu_torch.models.samplers import DensityGridSampler
    from jnerf_tpu_torch.utils.convert import jax_params_to_state_dict

    jcfg, tcfg = both_cfgs
    for cfg in both_cfgs:
        cfg.grid_update_mode = "probe"
    jcfg.dataset_obj = JaxDS(n_images=4, H=32, W=32, batch_size=256)
    tcfg.dataset_obj = SyntheticSpheresDataset(n_images=4, H=32, W=32,
                                               batch_size=256)
    jnet = JaxNGP()
    params = jnet.init(jax.random.PRNGKey(0))
    net = NGPNetworks()
    net.load_state_dict(jax_params_to_state_dict(jax.tree.map(np.asarray,
                                                              params)))
    jcfg.model_obj, tcfg.model_obj = jnet, net
    jsamp, tsamp = JaxSampler(), DensityGridSampler()
    jsamp.init_state()
    tsamp.init_state()
    return jsamp, tsamp, params


def test_probe_refresh_matches_jax(both_cfgs):
    """The sampler's probe refresh at step 0 (every cell probed, > -0.01,
    on the untrained-cell mask) and at step 256 (a quarter each way,
    thresholds read from the step-0 grid), fed the JAX keys' draws: the
    sample counts, the grids and the bitfields.  Densities come out of the
    bf16 network: rtol 2e-2 on the grid and 99.9% of bits, as the sweep
    refresh is held (tests/test_torch_march.py)."""
    jsamp, tsamp, params = _probe_samplers(both_cfgs)
    g = tsamp.grid_config
    jstate = jsamp.state
    for step, key in ((0, jax.random.PRNGKey(10)), (256, jax.random.PRNGKey(11))):
        counts = tsamp.grid_update_counts(step)
        assert counts == jsamp.grid_update_counts(step)
        k_u, k_n = jax.random.split(key)
        draws = [jax_probe_draws(k, c, g.max_cascade + 1)
                 for k, c in zip((k_u, k_n), counts) if c]
        tstate = dict(port_grid_state(jstate),
                      measured_batch_size=torch.zeros((), dtype=torch.int64))
        tstate = {k: (t(v) if isinstance(v, np.ndarray) else v)
                  for k, v in tstate.items()}
        jstate = jax.jit(lambda p, s, k: jsamp.update_density_grid_fn(
            p, s, k, *counts, step == 0))(params, jstate, key)
        tnew = tsamp.update_density_grid_fn(tstate, step == 0, jitter=draws,
                                            n_uniform=counts[0],
                                            n_nonuniform=counts[1])
        assert tnew["ema_step"] == int(jstate["ema_step"])
        np.testing.assert_allclose(n(tnew["density_grid"]),
                                   n(jstate["density_grid"]), rtol=2e-2,
                                   atol=1e-6)
        np.testing.assert_allclose(float(tnew["mean"]), float(jstate["mean"]),
                                   rtol=2e-2)
        agree = np.mean(n(tnew["bitfield"]) == n(jstate["bitfield"]))
        assert agree >= 0.999, agree
        assert (n(tnew["density_grid"]) > 0).any()


def test_probe_mode_trains(both_cfgs):
    """A Runner with grid_update_mode='probe' trains 32 steps through two
    refreshes with its own draws; the refreshes query the density of every
    cell at step 0."""
    from jnerf_tpu_torch.runner import Runner

    for cfg in both_cfgs:
        cfg.grid_update_mode = "probe"
    tr = Runner(device="cpu")
    calls = []
    density = tr.model.density
    tr.model.density = lambda pos: calls.append(pos.shape[0]) or density(pos)
    losses = [float(tr.train_range(w * 16, (w + 1) * 16)) for w in range(2)]
    assert all(np.isfinite(losses))
    assert tr.sampler.state["ema_step"] == 2
    g = tr.sampler.grid_config
    assert sum(calls) == 2 * g.n_cells * (g.max_cascade + 1)

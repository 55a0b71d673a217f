"""Occupancy grid, ray march, compaction, compositing and the sweep refresh
of the PyTorch port against the JAX package (tiny 32^3 grids, 256 rays)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from jnerf_tpu.ops import compact as jcompact
from jnerf_tpu.ops import composite as jcomposite
from jnerf_tpu.ops import occupancy as jocc
from jnerf_tpu.ops import ray_march as jmarch
from jnerf_tpu_torch.ops import compact as tcompact
from jnerf_tpu_torch.ops import composite as tcomposite
from jnerf_tpu_torch.ops import occupancy as tocc
from jnerf_tpu_torch.ops import ray_march as tmarch
from torch_parity import (  # noqa: F401
    both_cfgs, j, jax_sweep_jitter, n, port_grid_state, t,
)


def _grid_configs(grid_size=32, max_steps=128, aabb=(-0.5, 1.5)):
    return (jocc.make_grid_config(aabb, grid_size, max_steps),
            tocc.make_grid_config(aabb, grid_size, max_steps))


def _rays(rng, r):
    """Rays from a sphere of radius 2.5 around the unit cube's centre,
    aimed at jittered points inside it."""
    o = rng.normal(size=(r, 3))
    o = 0.5 + 2.5 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = 0.5 + rng.uniform(-0.4, 0.4, size=(r, 3)) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def test_grid_config_matches_jax():
    for aabb in ((0.0, 1.0), (-0.5, 1.5), (-7.5, 8.5)):
        jg, tg = _grid_configs(aabb=aabb)
        assert jg.__dict__ == tg.__dict__
        assert (jg.stepsize, jg.max_cone_stepsize) == (tg.stepsize,
                                                       tg.max_cone_stepsize)


def test_occupancy_helpers_match_jax():
    """Mip selection and bitfield lookups are exact integer results."""
    jg, tg = _grid_configs()
    rng = np.random.default_rng(0)
    bits = rng.uniform(size=(tg.n_cascades, 32, 32, 32)) < 0.3
    p = rng.uniform(-1.0, 2.0, size=(3, 4096)).astype(np.float32)
    dt = rng.uniform(1e-3, 0.1, size=4096).astype(np.float32)
    jm = jocc.mip_from_dt_xyz(j(dt), *map(j, p), jg)
    tm = tocc.mip_from_dt_xyz(t(dt), *map(t, p), tg)
    np.testing.assert_array_equal(n(tm), n(jm))
    np.testing.assert_array_equal(
        n(tocc.occupancy_at_xyz(t(bits), *map(t, p), tm, tg)),
        n(jocc.occupancy_at_xyz(j(bits), *map(j, p), jm, jg)))


@pytest.mark.parametrize("pool_hi", [None, 1])
def test_grid_update_ops_match_jax(pool_hi):
    """EMA, mean and the bitfield with its cascade max-pool."""
    jg, tg = _grid_configs()
    rng = np.random.default_rng(1)
    shape = (tg.n_cascades, 32, 32, 32)
    grid = rng.exponential(0.01, size=shape).astype(np.float32)
    grid[rng.uniform(size=shape) < 0.1] = -1.0
    tmp = rng.exponential(0.01, size=shape).astype(np.float32)
    jnew = jocc.ema_grid_update(j(grid), j(tmp), jg)
    tnew = tocc.ema_grid_update(t(grid), t(tmp), tg)
    np.testing.assert_allclose(n(tnew), n(jnew), rtol=1e-6)
    jmean, tmean = jocc.density_grid_mean(jnew, jg), tocc.density_grid_mean(tnew, tg)
    np.testing.assert_allclose(float(tmean), float(jmean), rtol=1e-5)
    np.testing.assert_array_equal(
        n(tocc.update_bitfield(tnew, tmean, tg, pool_hi)),
        n(jocc.update_bitfield(jnew, jnp.float32(float(tmean)), jg, pool_hi)))


def test_mark_untrained_matches_jax(both_cfgs):
    from jnerf_tpu.dataset.procedural import SyntheticSpheresDataset as JaxDS
    from jnerf_tpu_torch.dataset import SyntheticSpheresDataset

    jg, tg = _grid_configs(aabb=(0.0, 1.0))
    jds, tds = JaxDS(n_images=4, H=32, W=32), SyntheticSpheresDataset(
        n_images=4, H=32, W=32)
    np.testing.assert_array_equal(n(tds.image_data), n(jds.image_data))
    np.testing.assert_array_equal(n(tds.transforms_gpu), n(jds.transforms_gpu))
    np.testing.assert_array_equal(n(tds.focal_lengths), n(jds.focal_lengths))
    jgrid = jocc.mark_untrained_grid(jds.transforms_gpu, jds.focal_lengths,
                                     jds.resolution, jg)
    tgrid = tocc.mark_untrained_grid(tds.transforms_gpu, tds.focal_lengths,
                                     tds.resolution, tg)
    assert float(n(tgrid).mean()) < 0  # some cells unseen
    np.testing.assert_array_equal(n(tgrid), n(jgrid))


def test_rays_from_pixels_matches_jax():
    """f32 ray math: atol 1e-6."""
    from jnerf_tpu.dataset.dataset import rays_from_pixels as jax_rays
    from jnerf_tpu_torch.dataset.dataset import rays_from_pixels

    rng = np.random.default_rng(2)
    xf = rng.normal(size=(4, 3, 4)).astype(np.float32)
    fl = rng.uniform(20, 40, size=(4, 2)).astype(np.float32)
    pp = rng.uniform(0.4, 0.6, size=(4, 2)).astype(np.float32)
    idx = rng.integers(0, 4 * 24 * 32, size=512)
    out = rays_from_pixels(t(idx), t(xf), t(fl), t(pp), 32, 24)
    ref = jax_rays(j(idx.astype(np.int32)), j(xf), j(fl), j(pp), 32, 24)
    for a, b in zip(out, ref):
        np.testing.assert_allclose(n(a), n(b), rtol=0, atol=1e-6)


def test_ts_at_cone_angle_matches_jax():
    """The closed-form cone-angle march times: f32 exp/log, rtol 1e-5."""
    jg, tg = _grid_configs(aabb=(-7.5, 8.5))
    jc = jmarch.MarchConfig(grid=jg, cone_angle=1 / 256, const_dt=False)
    tc = tmarch.MarchConfig(grid=tg, cone_angle=1 / 256, const_dt=False)
    assert (jc.n_candidates, jc.probe_stride) == (tc.n_candidates,
                                                  tc.probe_stride)
    t0 = np.random.default_rng(3).uniform(0.2, 3.0, size=64).astype(np.float32)
    k = np.arange(0, 600, 7, dtype=np.float32)[None, :]
    np.testing.assert_allclose(n(tmarch.ts_at(tc, t(t0), t(k))),
                               n(jmarch.ts_at(jc, j(t0), j(k))), rtol=1e-5)


@pytest.mark.parametrize("n_samples", [32, 6, 3])
def test_sample_rays_matches_jax(n_samples):
    """The march with the JAX key's start jitter injected: 32 samples take
    the strided probes (stride 8), 6 the halved stride 2, 3 the unstrided
    path.  Selection is integer work on identical f32 times, so masks and
    counts must agree exactly; positions and steps to f32 rounding."""
    jg, tg = _grid_configs()
    jc, tc = jmarch.MarchConfig(grid=jg), tmarch.MarchConfig(grid=tg)
    assert tc.probe_stride == jc.probe_stride == 8
    rng = np.random.default_rng(4)
    bits = rng.uniform(size=(tg.n_cascades, 32, 32, 32)) < 0.2
    o, d = _rays(rng, 256)
    key = jax.random.PRNGKey(5)
    ref = jax.jit(jmarch.sample_rays, static_argnums=(0, 5))(
        jc, j(bits), j(o), j(d), key, n_samples)
    u = n(jax.random.uniform(key, (256,)))
    got = tmarch.sample_rays(tc, t(bits), t(o), t(d), None, n_samples, u=t(u))
    for field in ("valid", "numsteps", "truncated", "count"):
        np.testing.assert_array_equal(n(getattr(got, field)),
                                      n(getattr(ref, field)), err_msg=field)
    assert int(n(got.valid).sum()) > 0
    for field in ("positions", "dirs", "dts"):
        np.testing.assert_allclose(n(getattr(got, field)),
                                   n(getattr(ref, field)), rtol=0, atol=1e-6,
                                   err_msg=field)


def _leading_valid(rng, r, s):
    counts = rng.integers(0, s + 1, size=r)
    counts[rng.uniform(size=r) < 0.2] = 0
    valid = np.arange(s)[None, :] < counts[:, None]
    valid[3, 5] = True  # a post-hole straggler (ray 3 may be short)
    return valid


@pytest.mark.parametrize("m", [256, 4096])
def test_compact_indices_matches_jax(m):
    """Integer bookkeeping: equal on every kept lane."""
    valid = _leading_valid(np.random.default_rng(6), 128, 16)
    ref = jcompact.compact_indices(j(valid), m)
    got = tcompact.compact_indices(t(valid), m)
    kept = n(ref.slot_valid)
    np.testing.assert_array_equal(n(got.slot_valid), kept)
    np.testing.assert_array_equal(n(got.idx)[kept], n(ref.idx)[kept])
    np.testing.assert_array_equal(n(got.slot_valid & (got.within == 0)),
                                  n(ref.head))  # segment heads
    for field in ("offsets", "counts", "truncated"):
        np.testing.assert_array_equal(n(getattr(got, field)),
                                      n(getattr(ref, field)), err_msg=field)


@pytest.mark.parametrize("m", [256, 4096])
def test_render_rays_compact_matches_jax(m):
    """Forward and gradient of the ragged compositing: the same f32
    products, the per-ray sums taken as a direct sum here and as a cumsum
    difference in JAX: rtol 1e-4, atol 1e-5."""
    rng = np.random.default_rng(7)
    valid = _leading_valid(rng, 128, 16)
    raw = rng.normal(size=(m, 4)).astype(np.float32) * 2
    dts = rng.uniform(0.001, 0.05, size=m).astype(np.float32)
    bg = rng.uniform(size=(128, 3)).astype(np.float32)
    r = rng.normal(size=(128, 4)).astype(np.float32)
    jinfo = jcompact.compact_indices(j(valid), m)
    tinfo = tcompact.compact_indices(t(valid), m)

    def jloss(x):
        rgb, op = jcompact.render_rays_compact(x, j(dts), jinfo, background=j(bg))
        return jnp.sum(rgb * r[:, :3]) + jnp.sum(op * r[:, 3]), (rgb, op)

    (_, (jrgb, jop)), jgrad = jax.jit(
        jax.value_and_grad(jloss, has_aux=True))(j(raw))
    x = t(raw).requires_grad_(True)
    rgb, op = tcompact.render_rays_compact(x, t(dts), tinfo, background=t(bg))
    ((rgb * t(r[:, :3])).sum() + (op * t(r[:, 3])).sum()).backward()
    np.testing.assert_allclose(n(rgb), n(jrgb), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(n(op), n(jop), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(n(x.grad), n(jgrad), rtol=1e-4, atol=1e-5)


def test_render_rays_and_l1_reg_match_jax():
    """Padded [R, S] compositing (forward + gradient) and the density
    regularizer: the same f32 ops, rtol 1e-5, atol 1e-6."""
    rng = np.random.default_rng(8)
    valid = _leading_valid(rng, 64, 16)
    raw = rng.normal(size=(64, 16, 4)).astype(np.float32) * 2
    dts = rng.uniform(0.001, 0.05, size=(64, 16)).astype(np.float32)
    trunc = rng.uniform(size=64) < 0.3
    bg = rng.uniform(size=(64, 3)).astype(np.float32)

    def jloss(x):
        rgb, op = jcomposite.render_rays(x, j(dts), j(valid), j(trunc), j(bg))
        reg = jcomposite.density_l1_reg(x[..., 3], j(valid), jnp.float32(0.001),
                                        0.5)
        return jnp.sum(rgb) + jnp.sum(op) + reg

    jval, jgrad = jax.jit(jax.value_and_grad(jloss))(j(raw))
    x = t(raw).requires_grad_(True)
    rgb, op = tcomposite.render_rays(x, t(dts), t(valid), t(trunc), t(bg))
    reg = tcomposite.density_l1_reg(x[..., 3], t(valid), torch.tensor(0.001), 0.5)
    val = rgb.sum() + op.sum() + reg
    val.backward()
    np.testing.assert_allclose(float(val.detach()), float(jval), rtol=1e-5)
    np.testing.assert_allclose(n(x.grad), n(jgrad), rtol=1e-5, atol=1e-6)


def _samplers(both_cfgs):
    """JAX and port samplers over the same tiny dataset and network
    (weights converted from the JAX init)."""
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
    jcfg.dataset_obj = JaxDS(n_images=4, H=32, W=32, batch_size=256)
    tcfg.dataset_obj = SyntheticSpheresDataset(n_images=4, H=32, W=32,
                                               batch_size=256)
    jnet = JaxNGP()
    params = jnet.init(jax.random.PRNGKey(0))
    net = NGPNetworks()
    net.load_state_dict(jax_params_to_state_dict(jax.tree.map(np.asarray, params)))
    jcfg.model_obj, tcfg.model_obj = jnet, net
    jsamp, tsamp = JaxSampler(), DensityGridSampler()
    jsamp.init_state()
    tsamp.init_state()
    return jsamp, tsamp, params


def test_sweep_refresh_matches_jax(both_cfgs):
    """The step-0 full sweep and the next half sweep, fed the JAX keys'
    jitter.  Densities come out of the bf16 network, so rtol 2e-2 on the
    grid (a raw density one bf16 ulp apart moves exp(raw) by ~0.8%); a cell
    whose density sits at the threshold may flip its bit, so the bitfields
    must agree on 99.9% of cells."""
    jsamp, tsamp, params = _samplers(both_cfgs)
    g = tsamp.grid_config
    jstate = jsamp.state
    for step, key in ((0, jax.random.PRNGKey(10)), (16, jax.random.PRNGKey(11))):
        first = step == 0
        n_sweep = g.n_cells if first else g.n_cells // 2
        jitter = jax_sweep_jitter(key, g.max_cascade + 1, n_sweep)
        tstate = dict(port_grid_state(jstate),
                      measured_batch_size=torch.zeros((), dtype=torch.int64))
        tstate = {k: (t(v) if isinstance(v, np.ndarray) else v)
                  for k, v in tstate.items()}
        jstate = jax.jit(lambda p, s, k: jsamp.update_density_grid_fn(
            p, s, k, 0, 0, first))(params, jstate, key)
        tnew = tsamp.update_density_grid_fn(tstate, first, jitter=t(jitter))
        assert tnew["ema_step"] == int(jstate["ema_step"])
        np.testing.assert_allclose(n(tnew["density_grid"]),
                                   n(jstate["density_grid"]), rtol=2e-2,
                                   atol=1e-6)
        np.testing.assert_allclose(float(tnew["mean"]), float(jstate["mean"]),
                                   rtol=2e-2)
        agree = np.mean(n(tnew["bitfield"]) == n(jstate["bitfield"]))
        assert agree >= 0.999, agree


def test_update_batch_rays_matches_jax(both_cfgs):
    """The deadband controller makes the same shape decisions on the same
    measured demand, lagged window by window."""
    jsamp, tsamp, _ = _samplers(both_cfgs)
    rng = np.random.default_rng(9)
    rays_then = tsamp.n_rays_per_batch
    for w in range(12):
        measured = int(rng.uniform(0.05, 4.0) * (1 << 12) * 16)
        a = jsamp.update_batch_rays(measured=measured, n_steps=16,
                                    rays_then=rays_then)
        b = tsamp.update_batch_rays(measured=measured, n_steps=16,
                                    rays_then=rays_then)
        assert a == b
        assert (tsamp.n_rays_per_batch, tsamp.n_samples_per_ray) == (
            jsamp.n_rays_per_batch, jsamp.n_samples_per_ray)
        rays_then = tsamp.n_rays_per_batch


def test_sampler_state_dict_round_trip(both_cfgs):
    _, tsamp, _ = _samplers(both_cfgs)
    tsamp.update_density_grid(0, generator=torch.Generator().manual_seed(0))
    sd = tsamp.state_dict()
    before = {k: v.clone() if torch.is_tensor(v) else v
              for k, v in tsamp.state.items()}
    tsamp.init_state()
    tsamp.load_state_dict(sd)
    for k in ("density_grid", "bitfield", "mean"):
        assert torch.equal(tsamp.state[k], before[k])
    assert tsamp.state["ema_step"] == before["ema_step"] == 1


def test_probe_refresh_mode_raises(both_cfgs):
    """The probe refresh is ported (tests/test_torch_probe.py); a refresh
    mode that neither package has raises when the sampler is built."""
    both_cfgs[1].grid_update_mode = "probe"
    assert _samplers(both_cfgs)[1].grid_update_mode == "probe"
    both_cfgs[1].grid_update_mode = "dense"
    with pytest.raises(ValueError, match="'sweep' or 'probe'"):
        _samplers(both_cfgs)

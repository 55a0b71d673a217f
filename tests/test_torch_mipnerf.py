"""Mip-NeRF in the port (`ops/mip.py`, `LinearLog`, `mip_dataset.py`,
`MipNerfMLP`, `MipSampler`, `MipRunner`, the Mip tree of
`utils/convert.py`) against the JAX package's on the CPU, with the JAX
draws passed in.

Tolerances: f32 arithmetic in the same order is held at rtol 1e-5 (most
of it bit for bit).  Where sin or cos takes large arguments (the IPE scales
coordinates by up to 2^7, so arguments reach ~10^3) the two libraries' f32
range reductions differ by an ulp or two of the argument: atol 1e-6 of the
argument's size, as tests/test_torch_vanilla_nerf.py states for the
frequency encoder.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import clear_cfgs, j, n, t, write_mip_cfg  # noqa: F401

from jnerf_tpu.ops import mip as jm
from jnerf_tpu_torch.ops import mip as tm

R, S = 64, 16
EPS = float(np.finfo(np.float32).eps)


def _rays(seed=0, r=R):
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(r, 3)).astype(np.float32)
    d = rng.normal(size=(r, 3)).astype(np.float32)
    radii = rng.uniform(1e-3, 5e-3, (r, 1)).astype(np.float32)
    near = np.full((r, 1), 2.0, np.float32)
    far = np.full((r, 1), 6.0, np.float32)
    return o, d, radii, near, far


def test_pos_enc_expected_sin_and_ndc():
    """pos_enc (with and without identity), expected_sin and
    convert_to_ndc on random inputs."""
    rng = np.random.default_rng(1)
    x = rng.uniform(-2, 2, (256, 3)).astype(np.float32)
    for ident in (True, False):
        np.testing.assert_allclose(n(tm.pos_enc(t(x), 0, 4, ident)),
                                   n(jm.pos_enc(j(x), 0, 4, ident)),
                                   rtol=0, atol=2e-6 * 16)
    var = rng.uniform(0, 3, (256, 3)).astype(np.float32)
    for a, b in zip(tm.expected_sin(t(x), t(var)),
                    jm.expected_sin(j(x), j(var))):
        np.testing.assert_allclose(n(a), n(b), rtol=1e-5, atol=1e-6)
    o, d, *_ = _rays(2)
    o[:, 2] = -np.abs(o[:, 2]) - 1.5
    d[:, 2] = -np.abs(d[:, 2]) - 0.5
    for a, b in zip(tm.convert_to_ndc(t(o), t(d), 100.0, 64, 48),
                    jm.convert_to_ndc(j(o), j(d), 100.0, 64, 48)):
        np.testing.assert_allclose(n(a), n(b), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("stable", [True, False])
def test_frustum_cylinder_and_lift(stable):
    """conical_frustum_to_gaussian (stable and unstable), cylinder_to_gaussian
    and lift_gaussian on bins of random rays."""
    o, d, radii, *_ = _rays(3)
    tv = np.sort(np.random.default_rng(4).uniform(2, 6, (R, S + 1)), -1)
    tv = tv.astype(np.float32)
    t0, t1 = tv[:, :-1], tv[:, 1:]
    # Integer powers round as lax.integer_pow does, so even the unstable
    # form, which cancels t1^3 - t0^3, agrees at rtol 1e-5.
    for a, b in zip(tm.conical_frustum_to_gaussian(t(d), t(t0), t(t1),
                                                   t(radii), stable=stable),
                    jm.conical_frustum_to_gaussian(j(d), j(t0), j(t1),
                                                   j(radii), stable=stable)):
        np.testing.assert_allclose(n(a), n(b), rtol=1e-5, atol=1e-9)
    for a, b in zip(tm.cylinder_to_gaussian(t(d), t(t0), t(t1), t(radii)),
                    jm.cylinder_to_gaussian(j(d), j(t0), j(t1), j(radii))):
        np.testing.assert_allclose(n(a), n(b), rtol=1e-6)
    tmean, tvar, rvar = (x.astype(np.float32) for x in
                         (t0, (t1 - t0) ** 2, radii * np.ones_like(t0)))
    for a, b in zip(tm.lift_gaussian(t(d), t(tmean), t(tvar), t(rvar)),
                    jm.lift_gaussian(j(d), j(tmean), j(tvar), j(rvar))):
        np.testing.assert_allclose(n(a), n(b), rtol=1e-5, atol=1e-9)


def _ipe_atol(means):
    return 1e-6 * float(np.abs(means).max()) * 2 ** 7 + 1e-6


@pytest.mark.parametrize("ray_shape", ["cone", "cylinder"])
@pytest.mark.parametrize("randomized", [True, False])
def test_sampling_ipe_rendering_resampling(ray_shape, randomized):
    """The coarse level (sample_along_rays with the JAX key's jitter, the
    IPE at degrees [0, 8)), volumetric_rendering of random fields, and the
    fine level's resampling (resample_along_rays with the JAX key's draw)
    against JAX, on cones and on cylinders."""
    o, d, radii, near, far = _rays(5)
    key0, key1 = jax.random.split(jax.random.PRNGKey(9))
    jt, (jmeans, jcovs) = jm.sample_along_rays(
        key0, j(o), j(d), j(radii), S, j(near), j(far), randomized, False,
        ray_shape)
    u0 = n(jax.random.uniform(key0, (R, S + 1)))
    tt, (means, covs) = tm.sample_along_rays(
        t(o), t(d), t(radii), S, t(near), t(far), randomized, False,
        ray_shape, u=t(u0))
    np.testing.assert_allclose(n(tt), n(jt), rtol=1e-6)
    np.testing.assert_allclose(n(means), n(jmeans), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(n(covs), n(jcovs), rtol=1e-5, atol=1e-12)
    enc = tm.integrated_pos_enc((means, covs), 0, 8)
    jenc = jm.integrated_pos_enc((jmeans, jcovs), 0, 8)
    np.testing.assert_allclose(n(enc), n(jenc), rtol=0,
                               atol=_ipe_atol(n(means)))

    rng = np.random.default_rng(6)
    rgb = rng.uniform(size=(R, S, 3)).astype(np.float32)
    dens = rng.uniform(0, 2, (R, S, 1)).astype(np.float32)
    out = tm.volumetric_rendering(t(rgb), t(dens), tt, t(d), True)
    jout = jm.volumetric_rendering(j(rgb), j(dens), jt, j(d), True)
    for a, b in zip(out, jout):
        np.testing.assert_allclose(n(a), n(b), rtol=1e-5, atol=1e-6)

    s = 1.0 / (S + 1)
    u1 = n(jax.random.uniform(key1, (R, S + 1), maxval=s - EPS))
    nt, (m1, c1) = tm.resample_along_rays(
        t(o), t(d), t(radii), tt, out[3], randomized, True, 0.01, ray_shape,
        u=t(u1))
    jnt, (jm1, jc1) = jm.resample_along_rays(
        key1, j(o), j(d), j(radii), jt, jout[3], randomized, True, 0.01,
        ray_shape)
    np.testing.assert_allclose(n(nt), n(jnt), rtol=1e-5)
    np.testing.assert_allclose(n(m1), n(jm1), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(n(c1), n(jc1), rtol=1e-4, atol=1e-12)


@pytest.mark.parametrize("weights,draw", [
    ([1.0, 1.0, 1.0, 1.0], 0.0),      # u on every CDF step: 0, .25, .5, .75
    ([1.0, 0.0, 0.0, 1.0], 0.0),      # a flat CDF: repeated 0.5 at u = .5
    ([1.0, 1.0, 0.0, 0.0], 0.0),      # trailing repeated ones
    ([0.0, 0.0, 0.0, 0.0], 0.0),      # all-zero weights: the eps padding
    ([2.0, 1.0, 0.0, 1.0], 0.25 - 4 * EPS),  # the largest draws
    ([3.0, 0.0, 1.0, 0.0], 0.125),
])
def test_pdf_pick_matches_the_mask_at_cdf_steps(weights, draw):
    """searchsorted(cdf, u, right=True) picks the bins the JAX code's
    [R, B+1, S] mask picks where u equals a CDF step, on flat stretches of
    the CDF and on its trailing ones, randomized (the JAX draw passed in)
    and deterministic.  At a step of a rising CDF either neighbouring pick
    gives the same sample (t = 0 or 1); on a flat stretch a wrong pick
    moves the sample by a whole bin (0.67-1.0 here), so rtol 1e-6 (the
    interpolation's last bit, which XLA rounds otherwise) tells them
    apart."""
    bins = np.linspace(2.0, 6.0, 5, dtype=np.float32)[None].repeat(2, 0)
    w = np.array([weights, weights[::-1]], np.float32)
    u = np.full((2, 4), draw, np.float32)
    key = jax.random.PRNGKey(0)
    got = tm.sorted_piecewise_constant_pdf(t(bins), t(w), 4, True, u=t(u))
    # The JAX function draws u from its key; feed it the same u instead.
    orig = jax.random.uniform
    try:
        jax.random.uniform = lambda *a, **k: j(u)
        want = jm.sorted_piecewise_constant_pdf(key, j(bins), j(w), 4, True)
    finally:
        jax.random.uniform = orig
    np.testing.assert_allclose(n(got), n(want), rtol=1e-6, atol=0)
    got = tm.sorted_piecewise_constant_pdf(t(bins), t(w), 7, False)
    want = jm.sorted_piecewise_constant_pdf(key, j(bins), j(w), 7, False)
    np.testing.assert_allclose(n(got), n(want), rtol=1e-6, atol=0)


def test_linearlog_schedule_matches_jax():
    """LinearLog.schedule over steps 0-3000 (the delay ends at 2500) with
    mip_base.py's numbers, and without a delay: within 3 f32 ulps (numpy's
    f32 sin, exp and log against XLA's, each within an ulp or so)."""
    from jnerf_tpu.optims import Adam as JaxAdam
    from jnerf_tpu.optims.linearlog import LinearLog as JaxLinearLog
    from jnerf_tpu_torch.optims import Adam, LinearLog

    for delay in (2500, 0):
        args = dict(end_lr=5e-6, max_steps=40001, lr_delay_steps=delay,
                    lr_delay_mult=0.01)
        ours = LinearLog(Adam(lr=8e-3, eps=1e-15), **args)
        ref = JaxLinearLog(JaxAdam(lr=8e-3, eps=1e-15), **args)
        steps = np.arange(0, 3001)
        got = np.array([ours.schedule(int(s)) for s in steps], np.float32)
        want = np.asarray(jax.vmap(ref.schedule)(jnp.asarray(steps)))
        np.testing.assert_allclose(got, want, rtol=3 * 2.0 ** -23, atol=0)


def _mip_cfgs(tmp_path, scene, **extra):
    from jnerf_tpu.utils.config import init_cfg as jax_init
    from jnerf_tpu_torch.utils.config import init_cfg

    path = write_mip_cfg(tmp_path, scene, **extra)
    jax_init(path)
    init_cfg(path)
    return path


def _net_pair():
    """The JAX MipNerfMLP's params (numpy tree) and the port's network on
    the same weights."""
    from jnerf_tpu.models.networks.mip_network import MipNerfMLP as JaxMLP
    from jnerf_tpu_torch.models.networks import MipNerfMLP
    from jnerf_tpu_torch.utils.convert import jax_params_to_state_dict

    jnet = JaxMLP()
    params = jax.tree.map(np.asarray, jnet.init(jax.random.PRNGKey(0)))
    net = MipNerfMLP(device="cpu")
    net.load_state_dict(jax_params_to_state_dict(params))
    return jnet, params, net


def test_mip_mlp_and_tree_match_jax(tmp_path, synthetic_scene, clear_cfgs):
    """MipNerfMLP (depth 4, width 64, condition 32: the skip after layer 4
    does not fire, so depth 6 checks it too): the JAX tree converts both
    ways bit for bit; the forward and the parameter gradients of a random
    projection agree (f32 products: rtol 1e-5; gradients atol 1e-5 of the
    tensor's largest entry)."""
    from jnerf_tpu.models.networks.mip_network import MipNerfMLP as JaxMLP
    from jnerf_tpu_torch.utils.convert import (
        jax_params_to_state_dict, state_dict_to_jax_params,
    )

    for depth in (4, 6):
        _mip_cfgs(tmp_path, synthetic_scene, net_depth=depth)
        jnet, params, net = _net_pair()
        assert isinstance(jnet, JaxMLP)
        back = state_dict_to_jax_params(net.state_dict())
        assert jax.tree.structure(back) == jax.tree.structure(params)
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
            np.testing.assert_array_equal(a, b)
        assert [tuple(layer.w.shape) for layer in net.trunk][-1] == (
            (64 + 48, 64) if depth == 6 else (64, 64))
        rng = np.random.default_rng(depth)
        enc = rng.uniform(-1, 1, (8, 16, 48)).astype(np.float32)
        venc = rng.uniform(-1, 1, (8, 27)).astype(np.float32)
        rr = rng.normal(size=(8, 16, 3)).astype(np.float32)
        rd = rng.normal(size=(8, 16, 1)).astype(np.float32)
        rgb, dens = net(t(enc), t(venc))
        jrgb, jdens = jnet(params, j(enc), j(venc))
        np.testing.assert_allclose(n(rgb), n(jrgb), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(n(dens), n(jdens), rtol=1e-5, atol=1e-6)
        ((rgb * t(rr)).sum() + (dens * t(rd)).sum()).backward()
        jg = jax.grad(lambda p: jnp.sum(jnet(p, j(enc), j(venc))[0] * j(rr))
                      + jnp.sum(jnet(p, j(enc), j(venc))[1] * j(rd)))(
            jax.tree.map(jnp.asarray, params))
        jsd = jax_params_to_state_dict(jax.tree.map(np.asarray, jg))
        for name, p in net.named_parameters():
            ref = n(jsd[name])
            np.testing.assert_allclose(n(p.grad), ref, rtol=1e-5,
                                       atol=1e-5 * float(np.abs(ref).max()),
                                       err_msg=name)


def _assert_rays_equal(a, b):
    for f in a._fields:
        np.testing.assert_array_equal(n(getattr(a, f)), n(getattr(b, f)),
                                      err_msg=f)


def _write_multicam(root, scene):
    """A two-scale multicam scene from the blender fixture: each image at
    full size and decimated by 2, metadata.json with per-image cameras."""
    import json
    import os

    from jnerf_tpu_torch.dataset.dataset_util import read_image, write_image

    os.makedirs(root, exist_ok=True)
    meta = {}
    for split in ("train", "test"):
        with open(os.path.join(scene, f"transforms_{split}.json")) as f:
            frames = json.load(f)
        keys = ("file_path", "cam2world", "width", "height", "focal",
                "lossmult", "near", "far")
        m = {k: [] for k in keys}
        for i, fr in enumerate(frames["frames"][:3]):
            img = read_image(os.path.join(scene, fr["file_path"] + ".png"))
            for lvl in range(2):
                im = img[::2 ** lvl, ::2 ** lvl]
                rel = f"{split}_{i}_d{lvl}.png"
                write_image(os.path.join(root, rel), im)
                h, w = im.shape[:2]
                m["file_path"].append(rel)
                m["cam2world"].append(fr["transform_matrix"][:3])
                m["width"].append(w)
                m["height"].append(h)
                m["focal"].append(0.5 * w / np.tan(0.5 * frames["camera_angle_x"]))
                m["lossmult"].append(4.0 ** lvl)
                m["near"].append(2.0)
                m["far"].append(6.0)
        meta[split] = m
    with open(os.path.join(root, "metadata.json"), "w") as f:
        json.dump(meta, f)
    return root


@pytest.mark.parametrize("kind", ["Blender", "Multicam"])
def test_datasets_match_jax(tmp_path, synthetic_scene, kind):
    """Blender (the fixture: train takes the val json too; val and test
    every 10th frame) and Multicam (a two-scale scene this test writes):
    the images, each image's rays and the first three batches equal the
    JAX loader's bit for bit."""
    from jnerf_tpu.dataset import mip_dataset as jds
    from jnerf_tpu_torch.dataset import mip_dataset as tds

    root = (synthetic_scene if kind == "Blender"
            else _write_multicam(str(tmp_path / "multicam"), synthetic_scene))
    for mode in ("train", "val", "test"):
        a = getattr(tds, kind)(root, 200, mode=mode, device="cpu")
        b = getattr(jds, kind)(root, 200, mode=mode)
        assert a.n_images == b.n_images and (a.H, a.W) == (b.H, b.W)
        for i in range(a.n_images):
            np.testing.assert_array_equal(a.image(i), b.image(i))
            _assert_rays_equal(a.rays_for_image(i), b.rays_for_image(i))
        for _ in range(3):
            (ra, ca), (rb, cb) = next(a), next(b)
            _assert_rays_equal(ra, rb)
            np.testing.assert_array_equal(n(ca), n(cb))
    assert tds.Blenders is not None and "Blenders" in tds.DATASETS


def _jax_step_draws(key, n_levels, r, s):
    """The uniform draws the JAX step makes from its key
    (`jnerf_tpu/runner/mip_runner.py::_levels_forward`, `ops/mip.py:150,
    175`), one dict a level."""
    draws = []
    for lvl in range(n_levels):
        key, k_s, _k_n = jax.random.split(key, 3)
        if lvl == 0:
            u = jax.random.uniform(k_s, (r, s + 1))
        else:
            u = jax.random.uniform(k_s, (r, s + 1),
                                   maxval=1.0 / (s + 1) - EPS)
        draws.append({"u": t(n(u))})
    return draws


def _runner_pair(tmp_path, scene):
    """The JAX and the port's MipRunner from one config, the port on the
    JAX runner's initial weights."""
    from jnerf_tpu.runner.mip_runner import MipRunner as JaxRunner
    from jnerf_tpu_torch.runner import MipRunner
    from jnerf_tpu_torch.utils.convert import jax_params_to_state_dict

    _mip_cfgs(tmp_path, scene)
    jr = JaxRunner()
    tr = MipRunner(device="cpu")
    tr.model.load_state_dict(jax_params_to_state_dict(
        jax.tree.map(np.asarray, jr.params)))
    return jr, tr


def test_one_mip_step_matches_jax(tmp_path, synthetic_scene, clear_cfgs):
    """One training step of both runners (the JAX smoke test's shrunk
    mip_base.py) from the same params, the same first batch and the JAX
    key's draws: the loss and fine MSE at rtol 1e-4 (two levels of f32
    MLPs over IPE features whose sin arguments reach ~10^3), every
    parameter after the Adam step, and the Adam moments.  At step 0 Adam's
    update is lr * g / (|g| + eps), so a parameter moves by lr_0 = 8e-5
    (delay 0.01 x 8e-3) for any gradient far above eps: the parameters
    agree at atol 1e-7 wherever the two gradients agree in sign, and the
    first moments at 1e-3 of the tensor's largest entry."""
    from jnerf_tpu_torch.utils.convert import state_dict_to_jax_params

    jr, tr = _runner_pair(tmp_path, synthetic_scene)
    (rays, rgb), (jrays, jrgb) = next(tr.dataset["train"]), next(jr.dataset["train"])
    _assert_rays_equal(rays, jrays)
    key = jax.random.PRNGKey(3)
    step = jr._build_train_step()
    p0 = jax.tree.map(np.asarray, jr.params)
    jp, jopt, jloss, jfine = step(jr.params, jr.opt_state, jrays, jrgb, key)
    loss, fine = tr.train_step(rays, rgb, draws=_jax_step_draws(
        key, 2, 256, 32))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
    np.testing.assert_allclose(float(fine), float(jfine), rtol=1e-4)
    assert tr.optimizer.count == 1
    got = state_dict_to_jax_params(tr.model.state_dict())
    jmu = jopt[0].mu
    mu = tr._jax_tree([tr.optimizer.state[p]["mu"] for p in tr.params])
    lr0 = tr.schedule_wrap.schedule(0)
    np.testing.assert_allclose(lr0, 8e-5, rtol=1e-6)
    flipped = 0
    for a, b, a0, m, jmm in zip(jax.tree.leaves(got), jax.tree.leaves(jp),
                                jax.tree.leaves(p0), jax.tree.leaves(mu),
                                jax.tree.leaves(jmu)):
        b, jmm = np.asarray(b), np.asarray(jmm)
        same = np.sign(a - a0) == np.sign(b - a0)
        flipped += int((~same).sum())
        np.testing.assert_allclose(a[same], b[same], rtol=0, atol=1e-7)
        np.testing.assert_allclose(m, jmm, rtol=0,
                                   atol=1e-3 * float(np.abs(jmm).max()))
    n_params = sum(p.numel() for p in tr.params)
    assert flipped <= n_params // 1000, flipped


def test_render_image_matches_jax(tmp_path, synthetic_scene, clear_cfgs):
    """render_image of val view 0 (4096 rays: a 3072-ray chunk and a
    padded one, not randomized) on the same weights: atol 1e-5."""
    jr, tr = _runner_pair(tmp_path, synthetic_scene)
    img = tr.render_image(tr.dataset["val"], 0)
    jimg = jr.render_image(jr.dataset["val"], 0)
    assert img.shape == (64, 64, 3) and np.isfinite(img).all()
    np.testing.assert_allclose(img, jimg, rtol=0, atol=1e-5)


def test_checkpoints_pass_both_ways(tmp_path, synthetic_scene, clear_cfgs):
    """A JAX pickle (its optax state with set moments and count) loads into
    the port bit for bit, and the port's pickle, after two port steps,
    loads into the JAX MipRunner, which renders val view 0 as the port
    does (atol 1e-5); the port's own pickle reloads bit for bit and
    records the steps taken."""
    from jnerf_tpu_torch.runner import MipRunner

    jr, tr = _runner_pair(tmp_path, synthetic_scene)
    rng = np.random.default_rng(5)
    mu = jax.tree.map(lambda p: jnp.asarray(
        rng.normal(size=p.shape).astype(np.float32)), jr.params)
    nu = jax.tree.map(jnp.abs, mu)
    adam, rest = jr.opt_state[0], jr.opt_state[1:]
    jr.opt_state = (adam._replace(count=jnp.int32(7), mu=mu, nu=nu),) + rest
    jr.cfg.m_training_step = 7
    path = str(tmp_path / "jax.pkl")
    jr.save_ckpt(path)
    tr.load_ckpt(path)
    assert tr.start == 7 and tr.optimizer.count == 7
    got = {"model": tr._jax_tree(tr.params),
           "mu": tr._jax_tree([tr.optimizer.state[p]["mu"] for p in tr.params]),
           "nu": tr._jax_tree([tr.optimizer.state[p]["nu"] for p in tr.params])}
    for k, want in (("model", jr.params), ("mu", mu), ("nu", nu)):
        for a, b in zip(jax.tree.leaves(got[k]), jax.tree.leaves(want)):
            np.testing.assert_array_equal(a, np.asarray(b))

    for _ in range(2):
        tr.train_step(*next(tr.dataset["train"]))
    tr.start += 2
    path = str(tmp_path / "port.pkl")
    tr.save_ckpt(path)
    with open(path, "rb") as f:
        ckpt = pickle.load(f)
    assert set(ckpt) == {"global_step", "model", "optimizer"}
    assert ckpt["global_step"] == 9 and ckpt["optimizer"]["count"] == 9
    jr.load_ckpt(path)
    assert jr.start == 9
    np.testing.assert_allclose(tr.render_image(tr.dataset["val"], 0),
                               jr.render_image(jr.dataset["val"], 0),
                               rtol=0, atol=1e-5)
    again = MipRunner(device="cpu")
    again.load_ckpt(path)
    for a, b in zip(again.params, tr.params):
        assert torch.equal(a, b)
    for a, b in zip(again.params, tr.params):
        for k in ("mu", "nu"):
            assert torch.equal(again.optimizer.state[a][k],
                               tr.optimizer.state[b][k])


# The port's versions of tests/test_mipnerf.py's math tests.
class TestMipMath:
    def test_expected_sin_zero_var_is_sin(self):
        x = torch.linspace(-3, 3, 32)
        y, y_var = tm.expected_sin(x, torch.zeros_like(x))
        np.testing.assert_allclose(n(y), np.sin(n(x)), atol=1e-6)
        np.testing.assert_allclose(n(y_var), 0.0, atol=1e-6)

    def test_expected_sin_large_var_vanishes(self):
        x = torch.linspace(-3, 3, 32)
        y, _ = tm.expected_sin(x, torch.full_like(x, 100.0))
        np.testing.assert_allclose(n(y), 0.0, atol=1e-6)

    def test_conical_frustum_moments_match_monte_carlo(self):
        rng = np.random.default_rng(0)
        t0, t1, r = 0.9, 1.1, 0.05
        u = rng.uniform(size=200_000)
        ts = (t0 ** 3 + u * (t1 ** 3 - t0 ** 3)) ** (1 / 3)
        d = torch.tensor([0.0, 0.0, 1.0])
        t_mean, t_var, _ = tm.conical_frustum_to_gaussian(
            d, torch.tensor(t0), torch.tensor(t1), r)
        np.testing.assert_allclose(float(t_mean), ts.mean(), rtol=1e-3)
        np.testing.assert_allclose(float(t_var), ts.var(), rtol=0.05)

    def test_ipe_reduces_to_pe_at_zero_cov(self):
        x = t(np.random.default_rng(1).normal(size=(4, 3)).astype(np.float32))
        ipe = tm.integrated_pos_enc((x, torch.zeros_like(x)), 0, 4)
        pe = tm.pos_enc(x, 0, 4, append_identity=False)
        np.testing.assert_allclose(n(ipe), n(pe), atol=1e-5)

    def test_cast_rays_shapes(self):
        r, s = 8, 16
        t_vals = torch.broadcast_to(torch.linspace(2.0, 6.0, s + 1), (r, s + 1))
        o = torch.zeros((r, 3))
        d = t(np.tile([[0.0, 0.0, 1.0]], (r, 1)).astype(np.float32))
        radii = torch.full((r, 1), 0.001)
        means, covs = tm.cast_rays(t_vals, o, d, radii)
        assert means.shape == (r, s, 3) and covs.shape == (r, s, 3)
        assert (np.diff(n(means[..., 2]), axis=-1) > 0).all()

    def test_volumetric_rendering_opaque_wall(self):
        r, s = 4, 32
        t_vals = torch.broadcast_to(torch.linspace(0.0, 2.0, s + 1), (r, s + 1))
        rgb = torch.ones((r, s, 3)) * torch.tensor([1.0, 0.5, 0.25])
        density = torch.full((r, s, 1), 1e4)
        dirs = t(np.tile([[0.0, 0.0, 1.0]], (r, 1)).astype(np.float32))
        comp, _dist, acc, _w = tm.volumetric_rendering(rgb, density, t_vals,
                                                       dirs)
        np.testing.assert_allclose(n(comp[:, 0]), 1.0, atol=1e-4)
        np.testing.assert_allclose(n(acc), 1.0, atol=1e-4)

    def test_pdf_sampling_concentrates(self):
        r, b, s = 2, 32, 64
        bins = torch.broadcast_to(torch.linspace(0.0, 1.0, b + 1), (r, b + 1))
        w = np.full((r, b), 1e-4, np.float32)
        w[:, 20] = 10.0
        samples = n(tm.sorted_piecewise_constant_pdf(
            bins, t(w), s, True, generator=torch.Generator().manual_seed(0)))
        frac = ((samples >= 20 / 32) & (samples <= 21 / 32)).mean()
        assert frac > 0.9, frac

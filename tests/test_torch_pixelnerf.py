"""pixelNeRF in the port (`models/networks/pixelnerf.py`, the script
`jnerf_tpu_torch/projects/pixelnerf/main.py` and the pixelNeRF tree of
`utils/convert.py`) against the JAX package's on the CPU.

Tolerances: the encoder, the network and the render are f32 in the same
order of operations up to summation order: rtol 1e-5 with a small atol.
The two libraries' f32 sin and cos differ by up to one ulp on the same
argument (the arguments themselves agree bit for bit), so the encodings
are held at atol 2^-23.  A step's loss is held at rtol 1e-5 and each
gradient within 1e-5 of its largest entry; lock-step training at rtol 1e-4
(see the test).
"""

import importlib.util
import pickle
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_parity import j, n, t

from jnerf_tpu.models.networks import pixelnerf as jp
from jnerf_tpu_torch.models.networks import pixelnerf as tp
from jnerf_tpu_torch.projects.pixelnerf import main as tmain
from jnerf_tpu_torch.utils.convert import (
    jax_params_to_state_dict, state_dict_to_jax_params,
)

REPO = Path(__file__).resolve().parents[1]
ULP1 = 2.0 ** -23  # one ulp of f32 at 1


def _jax_main():
    """The JAX script, `projects/pixelnerf/main.py`, imported by path."""
    spec = importlib.util.spec_from_file_location(
        "jax_pixelnerf_main", REPO / "projects" / "pixelnerf" / "main.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jmain = _jax_main()


def _jax_params(net_width=32, img_f_ch=None, seed=999):
    """The JAX script's init (PRNGKey(999) split in three) at a width."""
    enc = jp.ImageEncoder()
    net = jp.PixelNeRF(img_f_ch=img_f_ch or enc.out_channels,
                       net_width=net_width)
    k1, k2, key = jax.random.split(jax.random.PRNGKey(seed), 3)
    params = {"enc": enc.init(k1), "net": net.init(k2)}
    return enc, net, jax.device_get(params), key


def _port_model(params):
    net = params["net"]
    model = torch.nn.ModuleDict({
        "enc": tp.ImageEncoder(),
        "net": tp.PixelNeRF(img_f_ch=net["f1_0"]["img"]["w"].shape[0],
                            net_width=net["stem"]["w"].shape[1])})
    model.load_state_dict(jax_params_to_state_dict(params))
    return model


def test_positional_encoding():
    """PE(L=6, w=1.5): x passes through bit for bit, sin/cos within one
    ulp."""
    x = np.random.default_rng(0).uniform(-6, 6, (64, 16, 3)).astype(
        np.float32)
    got, want = n(tp.positional_encoding(t(x), 6)), n(
        jp.positional_encoding(j(x), 6))
    assert got.shape == want.shape == (64, 16, 39)
    np.testing.assert_array_equal(got[..., :3], want[..., :3])
    np.testing.assert_allclose(got, want, rtol=0, atol=ULP1)
    # interleaved per octave: sin(w x), cos(w x), sin(2 w x), ...
    np.testing.assert_allclose(got[..., 6:9], np.cos(1.5 * x), atol=1e-6)


@pytest.mark.parametrize("hw", [100, 64])
def test_encoder_matches_jax(hw):
    """The encoder on [2, hw, hw, 3] images: at 100^2 the stride-2 convs
    pad (2, 3) and (0, 1) asymmetrically and the stages of 25, 13 and 7
    are resized to 50, non-integer ratios; rtol 1e-5, atol 1e-5."""
    enc, _, params, _ = _jax_params()
    img = np.random.default_rng(hw).uniform(0, 1, (2, hw, hw, 3)).astype(
        np.float32)
    want = n(enc(params["enc"], j(img)))
    got = n(_port_model(params)["enc"](t(img)))
    assert got.shape == want.shape == (2, hw // 2, hw // 2, 512)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_same_padding_is_jaxs():
    """(low, high) of JAX's "SAME" at the shapes the encoder meets."""
    assert tp._same_pad(100, 7, 2) == (2, 3)
    assert tp._same_pad(50, 3, 2) == (0, 1)
    assert tp._same_pad(25, 3, 2) == (1, 1)
    assert tp._same_pad(50, 3, 1) == (1, 1)


def test_bilinear_sample_and_gradient():
    """bilinear_sample on points inside and outside the map (clipped to
    W - 1.001), and its gradient to the map (a scatter of 4 corners) and
    to the coordinates: rtol 1e-5, atol 1e-6."""
    rng = np.random.default_rng(1)
    feat = rng.normal(size=(9, 13, 5)).astype(np.float32)
    uv = rng.uniform(-2, 15, (300, 2)).astype(np.float32)
    cot = rng.normal(size=(300, 5)).astype(np.float32)
    want, vjp = jax.vjp(jp.bilinear_sample, j(feat), j(uv))
    gf_want, guv_want = vjp(j(cot))
    f_t, uv_t = t(feat).requires_grad_(), t(uv).requires_grad_()
    got = tp.bilinear_sample(f_t, uv_t)
    got.backward(t(cot))
    np.testing.assert_allclose(n(got), n(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(n(f_t.grad), n(gf_want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(n(uv_t.grad), n(guv_want), rtol=1e-5,
                               atol=1e-6)
    # exact at pixel centres, as the JAX package's own test checks
    at = n(tp.bilinear_sample(t(feat), t(np.array([[2.0, 3.0]], np.float32))))
    np.testing.assert_array_equal(at[0], feat[3, 2])


def test_network_and_render_match_jax():
    """PixelNeRF at img_f_ch=16, net_width=32 and render_rays_pixelnerf
    with the JAX key's jitter passed in as ``u``: the maps at rtol 1e-5,
    atol 1e-6, and every parameter's gradient of a loss on them within
    1e-5 of its largest entry."""
    R, S, n_ref = 32, 16, 3
    net = jp.PixelNeRF(img_f_ch=16, net_width=32)
    params = jax.device_get(net.init(jax.random.PRNGKey(1)))
    rng = np.random.default_rng(2)
    feats = rng.normal(size=(n_ref, R, S, 16)).astype(np.float32)
    ro = rng.normal(scale=0.3, size=(R, 3)).astype(np.float32)
    rd = rng.normal(size=(R, 3)).astype(np.float32)
    key = jax.random.PRNGKey(2)
    u = jax.random.uniform(key, (S,))

    def jloss(p):
        rgb, depth, acc = jp.render_rays_pixelnerf(
            net, p, j(ro), j(rd), (2.0, 6.0), S, lambda pts: j(feats),
            key=key)
        return jnp.sum(rgb ** 2) + jnp.sum(depth) + jnp.sum(acc), (rgb, depth,
                                                                    acc)

    (_, want), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    tnet = tp.PixelNeRF(img_f_ch=16, net_width=32)
    tnet.load_state_dict(jax_params_to_state_dict(params))
    got = tp.render_rays_pixelnerf(tnet, t(ro), t(rd), (2.0, 6.0), S,
                                   lambda pts: t(feats), u=t(u))
    for a, b in zip(got, want):
        np.testing.assert_allclose(n(a), n(b), rtol=1e-5, atol=1e-6)
    (torch.sum(got[0] ** 2) + torch.sum(got[1]) + torch.sum(got[2])).backward()
    ref = jax_params_to_state_dict(jgrads)
    for name, p in tnet.named_parameters():
        scale = float(ref[name].abs().max())
        np.testing.assert_allclose(n(p.grad), n(ref[name]), rtol=0,
                                   atol=1e-5 * scale, err_msg=name)


def test_make_synthetic_load_tiny_nerf_and_rays_match_jax(tmp_path):
    """make_synthetic (the port's analytic renderer), load_tiny_nerf and
    the script's rays equal the JAX script's bit for bit."""
    a, b = tmain.make_synthetic(4, 20, 20), jmain.make_synthetic(4, 20, 20)
    npz = tmp_path / "tiny.npz"
    np.savez(npz, images=a[0], poses=a[1], focal=a[2])
    for x, y in zip(tmain.load_tiny_nerf(npz), jmain.load_tiny_nerf(npz)):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    assert a[2] == b[2]
    ro, rd, rgb = tmain.camera_rays(a[0][1:], a[1][1:], a[2])
    H, W = 20, 20
    focal = a[2]
    ys, xs = np.mgrid[0:H, 0:W]
    cam = np.stack([(xs - W * 0.5 + 0.5) / focal,
                    -(ys - H * 0.5 + 0.5) / focal,
                    -np.ones_like(xs, np.float32)], -1).astype(np.float32)
    np.testing.assert_array_equal(
        rd[H * W:2 * H * W], (cam @ a[1][2][:3, :3].T).reshape(-1, 3))
    np.testing.assert_array_equal(ro[-1], a[1][-1][:3, 3])
    np.testing.assert_array_equal(rgb[:H * W], a[0][1].reshape(-1, 3))


def test_reference_projector_matches_jax():
    """ReferenceProjector against the JAX script's on 3 reference views of
    the analytic scene: projected features of points in the scene at rtol
    1e-5, atol 1e-5 (the encoder's tolerance)."""
    enc, _, params, _ = _jax_params()
    images, poses, focal = jmain.make_synthetic(4, 32, 32)
    pts = np.random.default_rng(3).uniform(-1.5, 1.5, (16, 8, 3)).astype(
        np.float32)
    want = jmain.ReferenceProjector(enc, params["enc"], images[:3],
                                    poses[:3], focal)(j(pts))
    got = tmain.ReferenceProjector(_port_model(params)["enc"],
                                   t(images[:3]), poses[:3], focal)(t(pts))
    assert got.shape == want.shape == (3, 16, 8, 512)
    np.testing.assert_allclose(n(got), n(want), rtol=1e-5, atol=1e-5)


def _jax_script_step(net, images, poses, focal, n_ref, n_samples):
    """The JAX script's loss_fn and jitted Adam step
    (`projects/pixelnerf/main.py:118-143`) at the given sizes."""
    tx = optax.adam(1e-4)
    ref_images = jnp.asarray(images[:n_ref])
    ref_poses = poses[:n_ref]

    def loss_fn(p, ro, rd, target, k):
        proj = jmain.ReferenceProjector(jp.ImageEncoder(), p["enc"],
                                        ref_images, ref_poses, focal)
        rgb, _, _ = jp.render_rays_pixelnerf(
            net, p["net"], ro, rd, (2.0, 6.0), n_samples, proj, key=k)
        return jnp.mean((rgb - target) ** 2)

    @jax.jit
    def step(p, o, ro, rd, target, k):
        loss, grads = jax.value_and_grad(loss_fn)(p, ro, rd, target, k)
        updates, o = tx.update(grads, o, p)
        return optax.apply_updates(p, updates), o, loss

    return tx, loss_fn, step


def test_script_step_and_lockstep_training():
    """The scripts' loss and gradients on one batch from the same weights
    (the loss at rtol 1e-5, each gradient within 1e-5 of its largest
    entry), then 4 steps of both loops from the same weights, batches
    (np.random.default_rng(0)) and jitter (the JAX keys' draws, passed in):
    every step's loss at rtol 1e-4 and the parameters after them.

    At Adam's first steps a parameter moves by ~lr = 1e-4 for any gradient
    far above eps, in the gradient's sign: where the two gradients differ
    in sign the parameters part by up to 2 lr a step.  So the parameters
    are held at atol 1e-6 (1% of a step) on all but 1 in 1000 entries, and
    within 2 lr per step on those."""
    n_ref, n_samples, batch, width = 3, 8, 288, 32
    images, poses, focal = jmain.make_synthetic(5, 24, 24)
    enc, net, params, key = _jax_params(width)
    model = _port_model(params)
    tx, jloss_fn, jstep = _jax_script_step(net, images, poses, focal, n_ref,
                                           n_samples)

    # one batch: loss and gradients
    ro, rd, rgb = tmain.camera_rays(images[n_ref:], poses[n_ref:], focal)
    sel = np.random.default_rng(5).integers(0, len(ro), batch)
    k = jax.random.PRNGKey(7)
    jl, jg = jax.value_and_grad(jloss_fn)(params, j(ro[sel]), j(rd[sel]),
                                          j(rgb[sel]), k)
    loss = tmain.loss_fn(model, t(images[:n_ref]), poses[:n_ref], focal,
                         t(ro[sel]), t(rd[sel]), t(rgb[sel]),
                         t(jax.random.uniform(k, (n_samples,))), n_samples)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    ref = jax_params_to_state_dict(jax.device_get(jg))
    for name, p in model.named_parameters():
        scale = float(ref[name].abs().max())
        np.testing.assert_allclose(n(p.grad), n(ref[name]), rtol=0,
                                   atol=1e-5 * scale, err_msg=name)

    # lock-step: the JAX script's loop (main.py:145-158) beside the port's
    model = _port_model(params)
    steps = len(ro) // batch
    opt_state = tx.init(params)
    p, rng, jlosses, us = params, np.random.default_rng(0), [], []
    for _ in range(steps):
        s = rng.integers(0, len(ro), batch)
        key, kk = jax.random.split(key)
        us.append(t(jax.random.uniform(kk, (n_samples,))))
        p, opt_state, jl = jstep(p, opt_state, j(ro[s]), j(rd[s]),
                                 j(rgb[s]), kk)
        jlosses.append(float(jl))
    hist = tmain.train(model, images, poses, focal, n_ref=n_ref, epochs=1,
                       batch=batch, n_samples=n_samples, draws=iter(us))
    assert steps == 4 and len(hist["step_loss"]) == steps
    np.testing.assert_allclose(hist["step_loss"], jlosses, rtol=1e-4)
    got = jax_params_to_state_dict(jax.device_get(p))
    n_off, n_all = 0, 0
    for name, q in model.state_dict().items():
        d = np.abs(n(q) - n(got[name]))
        assert d.max() <= 2e-4 * steps, name
        n_off += int((d > 1e-6).sum())
        n_all += d.size
    assert n_off <= n_all // 1000, (n_off, n_all)


def test_main_functions_print_and_pickles_pass_both_ways(tmp_path, capsys):
    """The port script's functions at a tiny size (5 views of 16^2, a
    32-wide trunk, 2 epochs of 3 steps): its lines and pixelnerf.pkl,
    which the JAX encoder and network apply with the port's outputs (rtol
    1e-5, atol 1e-5); then a JAX-written pickle loaded by the port."""
    images, poses, focal = tmain.make_synthetic(5, 16, 16)
    model = tmain.build_model("cpu", net_width=32)
    hist = tmain.train(model, images, poses, focal, epochs=2, batch=160,
                       n_samples=8)
    path = tmain.save(model, str(tmp_path))
    out = capsys.readouterr().out.splitlines()
    assert [ln.split(":")[0] for ln in out[:2]] == ["epoch 0", "epoch 1"]
    assert out[2] == f"saved {path}"
    assert len(hist["step_loss"]) == 6
    assert np.isfinite(hist["epoch_loss"]).all()

    with open(path, "rb") as f:
        params = pickle.load(f)
    enc, net = jp.ImageEncoder(), jp.PixelNeRF(img_f_ch=512, net_width=32)
    rng = np.random.default_rng(4)
    feats = rng.normal(size=(3, 8, 4, 512)).astype(np.float32)
    x = rng.normal(size=(8, 4, 3)).astype(np.float32)
    d = rng.normal(size=(8, 3)).astype(np.float32)
    with torch.no_grad():
        np.testing.assert_allclose(n(model["enc"](t(images[:3]))),
                                   n(enc(params["enc"], j(images[:3]))),
                                   rtol=1e-5, atol=1e-5)
        for a, b in zip(model["net"](t(feats), t(x), t(d)),
                        net(params["net"], j(feats), j(x), j(d))):
            np.testing.assert_allclose(n(a), n(b), rtol=1e-5, atol=1e-6)

    _, _, jparams, _ = _jax_params(32)
    jpath = tmp_path / "jax_pixelnerf.pkl"
    with open(jpath, "wb") as f:
        pickle.dump(jparams, f)  # as the JAX script writes it
    with open(jpath, "rb") as f:
        back = _port_model(pickle.load(f))
    with torch.no_grad():
        for a, b in zip(back["net"](t(feats), t(x), t(d)),
                        net(jparams["net"], j(feats), j(x), j(d))):
            np.testing.assert_allclose(n(a), n(b), rtol=1e-5, atol=1e-6)
    # the tree round trip is exact
    again = state_dict_to_jax_params(back.state_dict())
    for a, b in zip(jax.tree.leaves(again), jax.tree.leaves(jparams)):
        np.testing.assert_array_equal(a, b)
    assert jax.tree.structure(again) == jax.tree.structure(jparams)


def test_main_refuses_without_a_card():
    """``main`` defaults to --device cuda, which needs a card."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmain.main(["--synthetic", "--epochs", "0"])

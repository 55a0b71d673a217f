"""The port's NeuS (`jnerf_tpu_torch`: NeuSDataset, the NeuS networks,
NeuSRenderer, NeuSRunner) against the JAX package's, on the CPU, at a small
size: a 4-image 24 x 32 DTU-format scene written by both packages' scene
writers, an SDF of 3 layers of 64 (skip at 2), a colour MLP of 2 x 32, a
3 x 32 background NeRF (skip at 1), 64 rays of 16 + 16 + 4 samples.  Both
runners are built from one config file; the port's parameters are the
JAX runner's, converted, and the JAX draws are passed in.  Every network
and the renderer run in f32 in both packages: tolerances start at rtol
1e-5 and each looser one says why."""

import os
import pickle
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_parity import NEUS_RAYS as N_RAYS
from torch_parity import grad_capture, j, n, read_ply, t, write_neus_cfg

H, W, N_IMAGES = 24, 32, 4


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    from jnerf_tpu_torch.dataset.synthetic import make_synthetic_neus_scene

    root = tmp_path_factory.mktemp("neus_scene")
    return make_synthetic_neus_scene(str(root / "scan"), n_images=N_IMAGES,
                                     H=H, W=W)


@pytest.fixture(scope="module")
def runners(tmp_path_factory, scene):
    """(JAX NeuSRunner, port NeuSRunner on the CPU) from one config, the
    port's parameters converted from the JAX runner's."""
    from jnerf_tpu.runner.neus_runner import NeuSRunner as JaxNeuSRunner
    from jnerf_tpu.utils.config import get_cfg as jax_get_cfg
    from jnerf_tpu.utils.config import init_cfg as jax_init_cfg
    from jnerf_tpu_torch.runner import NeuSRunner
    from jnerf_tpu_torch.utils.config import get_cfg, init_cfg
    from jnerf_tpu_torch.utils.convert import jax_params_to_state_dict

    path = write_neus_cfg(tmp_path_factory.mktemp("neus_run"), scene)
    jax_init_cfg(path)
    init_cfg(path)
    jr = JaxNeuSRunner()
    # One compiled render for every call (eager JAX dispatch is slow).
    jr.renderer.render = jax.jit(jr.renderer.render,
                                 static_argnames=("perturb_overwrite",))
    jr.base_exp_dir = str(Path(path).parent / "jax_exp")
    tr = NeuSRunner(device="cpu")
    tr.neus_network.load_state_dict(
        jax_params_to_state_dict(jax.tree.map(np.asarray, jr.params)))
    yield jr, tr
    jax_get_cfg().clear()
    get_cfg().clear()


def close(got, ref, rtol=1e-5, atol=1e-6, what=""):
    np.testing.assert_allclose(n(got), n(ref), rtol=rtol, atol=atol,
                               err_msg=what)


def ray_batch(jr, img_idx=1, seed=3):
    """A JAX ray batch [N_RAYS, 10] of image ``img_idx`` (its pixels drawn
    from default_rng(seed), as the JAX dataset draws them) and the pixels."""
    jr.dataset._rng = np.random.default_rng(seed)
    rng = np.random.default_rng(seed)
    px = rng.integers(0, W, N_RAYS)
    py = rng.integers(0, H, N_RAYS)
    return n(jr.dataset.gen_random_rays_at(img_idx, N_RAYS)), px, py


# ------------------------------------------------------------------ dataset
def test_synthetic_scene_matches_jax(tmp_path, scene):
    """The port's scene writer gives the JAX package's cameras exactly and
    its images and masks pixel for pixel (each written by its package's
    PNG encoder)."""
    from jnerf_tpu.dataset.synthetic import make_synthetic_neus_scene
    from jnerf_tpu_torch.dataset.dataset_util import read_image_u8

    ref = make_synthetic_neus_scene(str(tmp_path / "jax"), n_images=N_IMAGES,
                                    H=H, W=W)
    a = np.load(os.path.join(scene, "cameras_sphere.npz"))
    b = np.load(os.path.join(ref, "cameras_sphere.npz"))
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k])
    for sub in ("image", "mask"):
        names = sorted(os.listdir(os.path.join(scene, sub)))
        assert names == sorted(os.listdir(os.path.join(ref, sub)))
        assert len(names) == N_IMAGES
        for name in names:
            np.testing.assert_array_equal(
                read_image_u8(os.path.join(scene, sub, name)),
                read_image_u8(os.path.join(ref, sub, name)))


def test_decompose_projection_matches_jax():
    from jnerf_tpu.dataset.neus_dataset import decompose_projection as ref
    from jnerf_tpu_torch.dataset.neus_dataset import decompose_projection

    rng = np.random.default_rng(0)
    for _ in range(4):
        P = rng.normal(size=(3, 4))
        for got, want in zip(decompose_projection(P), ref(P)):
            np.testing.assert_array_equal(got, want)


def test_dataset_rays_match_jax(runners):
    """Cameras, images, the object box, full-image rays (two resolution
    levels), random rays at the same pixels, interpolated-pose rays and
    near/far: f32 ray arithmetic in both, rtol 1e-5 / atol 1e-6."""
    jr, tr = runners
    jd, td = jr.dataset, tr.dataset
    for name in ("intrinsics_all", "intrinsics_all_inv", "pose_all", "images",
                 "masks"):
        close(getattr(td, name), getattr(jd, name), what=name)
    np.testing.assert_array_equal(td.object_bbox_min, jd.object_bbox_min)
    np.testing.assert_array_equal(td.object_bbox_max, jd.object_bbox_max)
    for lvl in (1, 3):
        for got, want in zip(td.gen_rays_at(2, lvl), jd.gen_rays_at(2, lvl)):
            assert got.shape == want.shape
            close(got, want, what=f"gen_rays_at level {lvl}")
    data, px, py = ray_batch(jr)
    got = td.gen_random_rays_at(1, N_RAYS, px=t(px), py=t(py))
    close(got, data, what="gen_random_rays_at")
    for got, want in zip(td.gen_rays_between(0, 3, 0.3, 2),
                         jd.gen_rays_between(0, 3, 0.3, 2)):
        close(got, want, what="gen_rays_between")
    near, far = td.near_far_from_sphere(t(data[:, :3]), t(data[:, 3:6]))
    jnear, jfar = jd.near_far_from_sphere(j(data[:, :3]), j(data[:, 3:6]))
    close(near, jnear)
    close(far, jfar)


def test_resize_and_jet_match_cv2(runners):
    """image_at's resize equals cv2.resize (INTER_LINEAR) bit for bit on
    the dataset's images and on random uint8 images shrunk by 1-8; the JET
    table equals cv2.applyColorMap's, and validate_image's depth file is
    that table applied."""
    from jnerf_tpu_torch.dataset.neus_dataset import resize_linear_u8
    from jnerf_tpu_torch.runner.neus_runner import jet_lut

    jr, tr = runners
    for lvl in (1, 2, 3, 5):
        np.testing.assert_array_equal(tr.dataset.image_at(1, lvl),
                                      jr.dataset.image_at(1, lvl))
    rng = np.random.default_rng(0)
    for _ in range(40):
        h, w = rng.integers(8, 300, 2)
        lvl = int(rng.integers(1, 9))
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        np.testing.assert_array_equal(
            resize_linear_u8(img, max(1, w // lvl), max(1, h // lvl)),
            cv2.resize(img, (max(1, w // lvl), max(1, h // lvl))))
    u8 = np.arange(256, dtype=np.uint8)[:, None]
    np.testing.assert_array_equal(
        jet_lut(), cv2.applyColorMap(u8, cv2.COLORMAP_JET)[:, 0])


# ----------------------------------------------------------------- networks
def test_networks_match_jax(runners):
    """SDF forward and its spatial gradient, the colour MLP, the background
    NeRF and the variance on the same points.  The SDF's sin/cos encoding
    at frequencies up to 32 differ between the two libraries' f32 sin by
    an ulp of the argument's size, which the geometric-init first layer
    (std 0.18) carries into every unit: atol 1e-5 there."""
    jr, tr = runners
    jp, net = jr.params, tr.neus_network
    rng = np.random.default_rng(1)
    pts = rng.uniform(-1, 1, (200, 3)).astype(np.float32)
    dirs = rng.normal(size=(200, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    jnet = jr.neus_network
    ref_sdf = jnet.sdf_network(jp["sdf"], j(pts))
    close(net.sdf_network(t(pts)), ref_sdf, atol=1e-5, what="sdf forward")
    close(net.sdf_network.gradient(t(pts)),
          jnet.sdf_network.gradient(jp["sdf"], j(pts)), atol=1e-5,
          what="sdf gradient")
    feat = rng.normal(size=(200, 64)).astype(np.float32)
    close(net.color_network(t(pts), t(dirs), t(dirs), t(feat)),
          jnet.color_network(jp["color"], j(pts), j(dirs), j(dirs), j(feat)),
          atol=1e-5, what="colour network")
    pts4 = rng.uniform(-1, 1, (200, 4)).astype(np.float32)
    for got, want in zip(net.nerf_outside(t(pts4), t(dirs)),
                         jnet.nerf_outside(jp["nerf"], j(pts4), j(dirs))):
        close(got, want, atol=1e-5, what="background NeRF")
    close(net.deviation_network.inv_s(),
          jnet.deviation_network.inv_s(jp["variance"]))


def test_geometric_init_is_a_sphere(runners):
    """The port's own geometric init (from its generator) at full width:
    the layout of the JAX package's (layer 0 reads only the raw xyz, the
    skip layer's encoded tail starts at 0, the last bias is -0.5 and its
    weights ~N(sqrt(pi/256), 1e-4), the others ~N(0, sqrt(2/out))), and a
    field ~ |x| - 0.5: over 4 seeds the correlation with it averages above
    0.85 (the JAX package's init gives 0.86-0.92 a seed on the same
    points) and the gradient norms average within 0.15 of 1."""
    from jnerf_tpu_torch.models.networks.neus_network import SDFNetwork

    del runners  # the config it installed builds the encoder
    net = SDFNetwork(d_out=257, d_hidden=256, n_layers=8, bias=0.5)
    pts = t(np.random.default_rng(0).uniform(-1, 1, (64, 3)).astype(np.float32))
    r = np.linalg.norm(n(pts), axis=-1)
    corrs, norms = [], []
    for seed in range(4):
        net.reset_parameters(torch.Generator().manual_seed(seed))
        corrs.append(np.corrcoef(n(net.sdf(pts)[:, 0]), r - 0.5)[0, 1])
        norms.append(np.linalg.norm(n(net.gradient(pts)), axis=-1))
    assert np.mean(corrs) > 0.85, corrs
    assert abs(np.mean(norms) - 1.0) < 0.15, np.mean(norms)
    w = [n(layer.w) for layer in net.layers]
    b = [n(layer.b) for layer in net.layers]
    assert (w[0][3:] == 0).all() and (w[4][-36:] == 0).all()
    assert all((x == 0).all() for x in b[:-1]) and (b[-1] == -0.5).all()
    np.testing.assert_allclose(w[-1].mean(), np.sqrt(np.pi / 256), rtol=1e-3)
    assert w[-1].std() < 2e-4
    for x in w[1:4] + w[5:-1]:
        np.testing.assert_allclose(x.std(), np.sqrt(2 / x.shape[1]), rtol=0.05)


def test_softplus_matches_jax_and_stays_finite():
    """softplus and its first and second derivatives equal JAX's formula
    (jnp.logaddexp(z, 0)) at rtol 1e-6, and stay finite where the
    textbook 1 / (1 + exp(-z)) form overflows (z = -100: beta 100 on h = -1)."""
    from jnerf_tpu_torch.models.networks.neus_network import softplus

    z = np.array([-200.0, -100.0, -30.0, -1.0, 0.0, 0.5, 20.0, 100.0],
                 np.float32)
    zt = t(z).requires_grad_(True)
    out = softplus(zt)
    g1, = torch.autograd.grad(out.sum(), zt, create_graph=True)
    g2, = torch.autograd.grad(g1.sum(), zt)
    f = jax.nn.softplus
    d1 = jax.vmap(jax.grad(f))
    d2 = jax.vmap(jax.grad(lambda x: jax.grad(f)(x)))
    for got, want in ((out, f(j(z))), (g1, d1(j(z))), (g2, d2(j(z)))):
        assert np.isfinite(n(got)).all()
        close(got, want, rtol=1e-6, atol=1e-30)


# ----------------------------------------------------------------- renderer
def test_sample_pdf_matches_jax():
    """Inverse-CDF sampling, deterministic and with given u, and the
    right-side search on rows where u lands exactly on a CDF step."""
    from jnerf_tpu.models.samplers.neus_renderer import sample_pdf as ref
    from jnerf_tpu_torch.models.samplers.neus_renderer import (
        sample_pdf, searchsorted_right,
    )

    rng = np.random.default_rng(2)
    bins = np.sort(rng.uniform(0, 4, (32, 17)), axis=-1).astype(np.float32)
    weights = rng.uniform(0, 1, (32, 16)).astype(np.float32)
    weights[:4, 3:9] = 0.0  # flat CDF stretches
    close(sample_pdf(t(bins), t(weights), 24, det=True),
          ref(None, j(bins), j(weights), 24, det=True), what="det")
    key = jax.random.PRNGKey(4)
    u = n(jax.random.uniform(key, (32, 24)))
    close(sample_pdf(t(bins), t(weights), 24, u=t(u)),
          ref(key, j(bins), j(weights), 24), what="random")
    cdf = np.array([[0.0, 0.25, 0.25, 0.5, 1.0]] * 2, np.float32)
    u = np.array([[0.0, 0.25, 0.5, 0.75], [1.0, 0.25, 0.1, 0.5]], np.float32)
    want = jax.vmap(lambda c, x: jnp.searchsorted(c, x, side="right"))(
        j(cdf), j(u))
    np.testing.assert_array_equal(n(searchsorted_right(t(cdf), t(u))),
                                  n(want))


def _jax_render_draws(key, batch, n_outside):
    k1, k2 = jax.random.split(key)
    return (t(jax.random.uniform(k1, (batch, 1))),
            t(jax.random.uniform(k2, (batch, n_outside))))


def test_render_matches_jax(runners):
    """One perturbed render of 64 rays (the JAX draws passed in) at cos
    anneal 0.3: color_fine, weight_sum, gradient_error, s_val, z_vals.
    The up-sampled depths come from a chain of sorts, searches and
    cumulative products over the SDF; an ulp in the SDF moves a depth by
    an ulp of its size: rtol 1e-4 on z_vals, 1e-4 / atol 1e-5 on the
    composited outputs.  A sample's own weight is alpha = (cdf_prev -
    cdf_next) / cdf_prev times the transmittance: the difference of two
    sigmoids of sdf * inv_s cancels, and an ulp of the SDF moves a small
    alpha by ~1e-3 of itself: per-sample weights at rtol 1e-3 / atol
    1e-4."""
    jr, tr = runners
    data, _, _ = ray_batch(jr)
    key = jax.random.PRNGKey(5)
    ro, rd = data[:, :3], data[:, 3:6]
    near, far = jr.dataset.near_far_from_sphere(j(ro), j(rd))
    ref = jr.renderer.render(jr.params, j(ro), j(rd), near, far, key=key,
                             cos_anneal_ratio=0.3)
    t_rand, t_r = _jax_render_draws(key, N_RAYS, jr.renderer.n_outside)
    got = tr.renderer.render(t(ro), t(rd), t(near), t(far),
                             cos_anneal_ratio=0.3, t_rand=t_rand, t_r=t_r)
    close(got["z_vals"], ref["z_vals"], rtol=1e-4, atol=1e-5, what="z_vals")
    for k in ("color_fine", "weight_sum", "gradient_error", "s_val"):
        close(got[k].detach(), ref[k], rtol=1e-4, atol=1e-5, what=k)
    close(got["weights"].detach(), ref["weights"], rtol=1e-3, atol=1e-4,
          what="weights")


def test_one_training_step_matches_jax(runners):
    """One NeuS step on the same batch and draws (the JAX step's key): the
    loss and its colour and eikonal terms at rtol 1e-4, and each
    parameter's gradient within 1e-3 of that tensor's largest entry (a
    double backward through f32 softplus chains, whose sums run in
    another order)."""
    from jnerf_tpu_torch.utils.convert import (
        jax_params_to_state_dict, state_dict_to_jax_params,
    )

    jr, tr = runners
    data, _, _ = ray_batch(jr, img_idx=2, seed=7)
    jr.iter_step = tr.iter_step = 3
    key = jax.random.PRNGKey(9)
    jr.tx = grad_capture()
    step = jax.jit(jr._step_body())
    near, far = jr.dataset.near_far_from_sphere(j(data[:, :3]),
                                                j(data[:, 3:6]))
    _, opt_state, jloss, (jcolor, jeik, _) = step(
        jr.params, jr.tx.init(jr.params), j(data[:, :3]), j(data[:, 3:6]),
        j(data[:, 6:9]), j(data[:, 9:10]), near, far,
        jnp.float32(jr.current_lr()), jnp.float32(jr.get_cos_anneal_ratio()),
        key)
    t_rand, t_r = _jax_render_draws(key, N_RAYS, jr.renderer.n_outside)
    net = tr.neus_network
    net.zero_grad(set_to_none=True)
    total, (color, eik, _) = tr.forward_loss(t(data), t_rand=t_rand, t_r=t_r)
    total.backward()
    for got, want in ((total, jloss), (color, jcolor), (eik, jeik)):
        close(got.detach(), want, rtol=1e-4, atol=0)
    jgrads = state_dict_to_jax_params(
        jax_params_to_state_dict(jax.tree.map(np.asarray, opt_state["g"])))
    grads = state_dict_to_jax_params(
        {name: p.grad for name, p in net.named_parameters()})
    for (path, got), ref in zip(jax.tree_util.tree_leaves_with_path(grads),
                                jax.tree.leaves(jgrads)):
        scale = float(np.abs(ref).max())
        assert scale > 0, path
        err = float(np.abs(got - ref).max())
        assert err <= 1e-3 * scale, (jax.tree_util.keystr(path), err / scale)


def test_schedule_and_adam_match_jax(runners):
    """The learning rate (warm-up, cosine) and the cos anneal follow the
    JAX runner's at every step, and the port's Adam scaled by -lr takes
    the JAX runner's update (optax.scale_by_adam, scale -1, times lr) on
    the same gradients for three steps."""
    import optax

    from jnerf_tpu_torch.optims import AdamOptimizer

    jr, tr = runners
    for it in (0, 1, 2, 3, 4, 8):
        jr.iter_step = tr.iter_step = it
        assert tr.current_lr() == jr.current_lr()
        assert tr.get_cos_anneal_ratio() == jr.get_cos_anneal_ratio()
    rng = np.random.default_rng(3)
    p0 = rng.normal(size=(5, 4)).astype(np.float32)
    grads = [rng.normal(size=(5, 4)).astype(np.float32) for _ in range(3)]
    lrs = [1e-3, 5e-4, 2e-4]
    tx = optax.chain(optax.scale_by_adam(b1=0.9, b2=0.99, eps=1e-15),
                     optax.scale(-1.0))
    jp, st = j(p0), tx.init(j(p0))
    param = torch.nn.Parameter(t(p0))
    lr_now = [0.0]
    opt = AdamOptimizer([param], 1.0, (0.9, 0.99), 1e-15,
                        lr_schedule=lambda _: lr_now[0])
    for g, lr in zip(grads, lrs):
        upd, st = tx.update(j(g), st, jp)
        jp = jp + upd * jnp.float32(lr)
        lr_now[0] = lr
        param.grad = t(g)
        opt.step()
    close(param.detach(), jp, rtol=1e-6, atol=1e-7)


def test_checkpoints_pass_both_ways(runners, tmp_path):
    """A port checkpoint holds the JAX runner's pickle (numpy leaves) and
    the JAX runner loads it; a JAX checkpoint loads into the port; both
    give the same parameters bit for bit; is_continue resumes the latest."""
    from jnerf_tpu.runner.neus_runner import NeuSRunner as JaxNeuSRunner
    from jnerf_tpu_torch.runner import NeuSRunner

    jr, tr = runners
    tr.iter_step = 3
    path = tr.save_checkpoint()
    with open(path, "rb") as f:
        ckpt = pickle.load(f)
    assert set(ckpt) == {"neus", "iter_step"} and ckpt["iter_step"] == 3
    assert set(ckpt["neus"]) == {"nerf", "sdf", "variance", "color"}
    jax_dir, jr.base_exp_dir = jr.base_exp_dir, tr.base_exp_dir
    try:
        jr.load_checkpoint(os.path.basename(path))
        assert jr.iter_step == 3
        for got, want in zip(jax.tree.leaves(jr.params),
                             jax.tree.leaves(ckpt["neus"])):
            np.testing.assert_array_equal(n(got), want)
        jr.iter_step = 4
        jr.save_checkpoint()
    finally:
        jr.base_exp_dir = jax_dir
    again = NeuSRunner(is_continue=True, device="cpu")
    assert again.iter_step == 4
    for (name, p), q in zip(again.neus_network.named_parameters(),
                            tr.neus_network.parameters()):
        assert torch.equal(p, q), name


def test_validate_mesh_and_image_match_jax(runners, tmp_path):
    """validate_mesh at resolution 28 in world space: the port's PLY has
    the JAX runner's vertex and triangle counts and every vertex within
    1e-4 of one of the JAX mesh's (the fields differ by f32 rounding of the
    sin/cos encoding).  validate_image of camera 1: the render over its
    target, the normals and the JET depth within one 8-bit level (a
    rounding flip) of the JAX runner's cv2-written files, the depth's
    colour within one JET step (4 levels) after that flip."""
    from scipy.spatial import cKDTree

    from jnerf_tpu_torch.dataset.dataset_util import read_image_u8

    jr, tr = runners
    tr.iter_step = jr.iter_step = 5
    mine = read_ply(tr.validate_mesh(world_space=True, resolution=28))
    ref = read_ply(jr.validate_mesh(world_space=True, resolution=28))
    assert len(mine[0]) == len(ref[0]) > 100
    assert len(mine[1]) == len(ref[1])
    for a, b in ((mine[0]["xyz"], ref[0]["xyz"]), (ref[0]["xyz"],
                                                   mine[0]["xyz"])):
        assert cKDTree(b).query(a)[0].max() <= 1e-4

    img = tr.validate_image(idx=1)
    jimg = jr.validate_image(idx=1)
    assert img.shape == jimg.shape == (H // 4, W // 4, 3)
    name = "00000005_0_1.png"
    for sub, tol in (("validations_fine", 1), ("normals", 1), ("depths", 5)):
        got = read_image_u8(os.path.join(tr.base_exp_dir, sub, name))
        want = cv2.imread(os.path.join(jr.base_exp_dir, sub, name))
        assert got.shape == want.shape, sub
        diff = np.abs(got.astype(int) - want[..., ::-1].astype(int))
        assert diff.max() <= tol, (sub, diff.max())


def test_render_novel_image_matches_jax(runners):
    """A pose interpolated between cameras 0 and 2 (slerp), rendered
    without perturbation at resolution level 4: uint8 RGB within one level
    of the JAX runner's (a rounding flip of the f32 render)."""
    jr, tr = runners
    tr.iter_step = jr.iter_step = 5
    got = tr.render_novel_image(0, 2, 0.4, 4)
    want = jr.render_novel_image(0, 2, 0.4, 4)
    assert got.shape == want.shape == (H // 4, W // 4, 3)
    assert got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1

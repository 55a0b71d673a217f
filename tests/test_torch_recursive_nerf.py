"""Recursive-NeRF in the port (`models/networks/recursive_nerf.py`, the
script `jnerf_tpu_torch/projects/recursive_nerf/main.py` and the tree in
`utils/convert.py`) against the JAX package's on the CPU.

Tolerances: the network is f32 in the same order of operations up to
summation order.  Outputs are held at rtol 1e-5 and an atol of 1e-5 of
the largest |output| (an output near zero is a sum of terms of the
largest's size).  Gradients are held within 1e-5 of the largest entry
of all gradients and 1e-4 of each tensor's own: a node that few points
reach sums few terms, each through up to 14 layers of f32 rounding.
Routing is discontinuous: a point whose confidence lies within float
noise of the threshold, or whose two nearest anchors are within float
noise of each other, may take another branch in the port.  The routing
masks are compared exactly; a mismatch is allowed only at such a
near-tie, and the tests count those and leave them out of the output
comparison.  k-means and the anchor split are numpy in both
packages and equal bit for bit on equal inputs.
"""

import pickle
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_parity import j, n, t

from jnerf_tpu.models.networks import recursive_nerf as jr
from jnerf_tpu_torch.models.networks import recursive_nerf as tr
from jnerf_tpu_torch.projects.recursive_nerf import main as tmain
from jnerf_tpu_torch.utils.convert import (
    jax_params_to_state_dict, state_dict_to_jax_params,
)

TIE = 1e-5  # |conf - threshold| or a distance gap below this is a near-tie


def _close(got, want):
    """rtol 1e-5, atol 1e-5 of the largest |want|."""
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


def _close_grads(model, ref):
    """Each parameter's .grad against the JAX gradients ``ref`` (a state
    dict) at the tolerance above; parameters without gradient (the
    anchors, nodes no point reached) must have none or zero in JAX."""
    top = max(float(r.abs().max()) for r in ref.values())
    for name, p in model.named_parameters():
        want = n(ref[name])
        if p.grad is None:
            assert not np.abs(want).max(), name
            continue
        np.testing.assert_allclose(
            n(p.grad), want, rtol=0, err_msg=name,
            atol=min(1e-5 * top, 1e-4 * float(np.abs(want).max())))


def _pair(head_num, W=32, threshold=3e-2, seed=0, anchors_seed=None):
    """A JAX model and params and the port's model on the same weights;
    with ``anchors_seed`` the anchors are random points of the unit ball's
    size, so that routing sends points to every child."""
    jm = jr.RecursiveNeRF(head_num=head_num, W=W, threshold=threshold)
    params = jax.device_get(jm.init(jax.random.PRNGKey(seed)))
    if anchors_seed is not None:
        rng = np.random.default_rng(anchors_seed)
        params["anchors"] = [rng.uniform(-1, 1, a.shape).astype(np.float32)
                             for a in params["anchors"]]
    tm = tr.RecursiveNeRF(head_num=head_num, W=W, threshold=threshold)
    tm.load_state_dict(jax_params_to_state_dict(params))
    return jm, params, tm


def _jax_masks(monkeypatch, jm, params, pts, views, level):
    """The JAX forward's outputs and the routing mask of every node it
    visits, in node order: each visit calls ``jnp.where(m, conf, uncert)``
    with the node's mask, which a wrapper of the module's jnp records."""
    seen = []

    def where(c, *a):
        if c.ndim == 1:
            seen.append(np.asarray(c))
        return jnp.where(c, *a)

    proxy = types.SimpleNamespace(**{k: getattr(jnp, k) for k in dir(jnp)
                                     if not k.startswith("__")})
    proxy.where = where
    monkeypatch.setattr(jr, "jnp", proxy)
    out, unc = jm(params, j(pts), j(views), max_level=level)
    monkeypatch.setattr(jr, "jnp", jnp)
    return n(out), n(unc), seen


def _near_ties(tm, pts, level):
    """[N] bool: points within TIE of the threshold at some node's
    confidence or of a second-nearest anchor, over the port's own walk."""
    tie = np.zeros(len(pts), bool)
    conf_at = {}
    orig = tm._node_out

    def spy(t_, h, v):
        conf, out = orig(t_, h, v)
        conf_at[t_] = n(conf)
        return conf, out

    tm._node_out = spy
    try:
        with torch.no_grad():
            tm(t(pts), t(np.ones_like(pts)), max_level=level)
    finally:
        del tm._node_out
    for t_, conf in conf_at.items():
        tie |= np.abs(conf - tm.threshold) < TIE
        sons = tm.sons[t_]
        if len(sons) > 1:
            a = n(tm.anchors[t_])[: len(sons)]
            d = np.sort(np.linalg.norm(pts[:, None] - a[None], axis=-1), -1)
            tie |= d[:, 1] - d[:, 0] < TIE
    return tie


@pytest.mark.parametrize("head_num,nodes", [(1, 4), (4, 11), (8, 15)])
def test_topologies(head_num, nodes):
    """The static trees: children, linears a node, skips, depth."""
    jm, tm = jr.RecursiveNeRF(head_num=head_num, W=32), tr.RecursiveNeRF(
        head_num=head_num, W=32)
    assert tr._tree(head_num) == jr._tree(head_num)
    assert tm.node_num == jm.node_num == nodes
    assert sum(1 for s in tm.sons if not s) == head_num
    assert (tm.depth, tm.max_depth, tm.node_linears, tm.linear_num) == (
        jm.depth, jm.max_depth, jm.node_linears, jm.linear_num)
    params = jm.init(jax.random.PRNGKey(0))
    shapes = {k: tuple(v.shape) for k, v in
              jax_params_to_state_dict(params).items()}
    assert shapes == {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    with pytest.raises(ValueError):
        tr._tree(2)


def test_positional_encoding():
    """Frequency-major, all sines then all cosines: x bit for bit, sin/cos
    within one ulp of the JAX package's (2^-23 at 1)."""
    x = np.random.default_rng(0).uniform(-2, 2, (256, 3)).astype(np.float32)
    got, want = n(tr.positional_encoding(t(x), 10)), n(
        jr.positional_encoding(j(x), 10))
    assert got.shape == want.shape == (256, 63)
    np.testing.assert_array_equal(got[:, :3], want[:, :3])
    np.testing.assert_allclose(got, want, rtol=0, atol=2.0 ** -23)
    np.testing.assert_allclose(got[:, 3:6], np.sin(x), atol=1e-6)
    np.testing.assert_allclose(got[:, 6:9], np.sin(2 * x), atol=1e-6)


@pytest.mark.parametrize("head_num", [1, 4, 8])
def test_forward_and_routing_masks(monkeypatch, head_num):
    """Forward at max_level 0..3 (and None) at W=32 on 512 points with
    random anchors: every visited node's routing mask equal to the JAX
    one but at counted near-ties, and the outputs at rtol 1e-5, atol 1e-6
    on the points routed alike."""
    jm, params, tm = _pair(head_num, anchors_seed=head_num)
    rng = np.random.default_rng(head_num)
    pts = rng.uniform(-1.2, 1.2, (512, 3)).astype(np.float32)
    views = rng.normal(size=(512, 3)).astype(np.float32)
    n_ties = 0
    for level in (0, 1, 2, 3, None):
        out, unc, jmasks = _jax_masks(monkeypatch, jm, params, pts, views,
                                      level)
        masks = {}
        with torch.no_grad():
            got, gunc = tm(t(pts), t(views), max_level=level, masks=masks)
        visited = sorted(masks)
        assert len(visited) == len(jmasks)
        assert len(visited) == sum(1 for d in tm.depth
                                   if d <= (3 if level is None else level))
        tie = _near_ties(tm, pts, level)
        differ = np.zeros(len(pts), bool)
        for node, jmask in zip(visited, jmasks):
            differ |= n(masks[node]) != jmask
        assert not (differ & ~tie).any(), np.flatnonzero(differ & ~tie)
        n_ties += int(differ.sum())
        if level is None or level > 0:  # routing reaches children
            assert any(n(masks[s]).any() for s in visited if s > 0)
        _close(n(got)[~differ], out[~differ])
        _close(n(gunc)[~differ], unc[~differ])
    # near-ties are rare: at most 1 point in 500 over the five levels
    assert n_ties <= 5, n_ties


@pytest.mark.parametrize("head_num,threshold", [(1, -1.0), (8, 3e-2)])
def test_gradients_match_jax(head_num, threshold):
    """Gradients of sum(out^2) + sum(uncert^2) to every parameter (see
    above), the deepest head's included (threshold -1 sends every point
    down the chain), anchors without gradient."""
    jm, params, tm = _pair(head_num, threshold=threshold, anchors_seed=7)
    rng = np.random.default_rng(8)
    pts = rng.uniform(-1, 1, (128, 3)).astype(np.float32)
    views = rng.normal(size=(128, 3)).astype(np.float32)

    def loss(p):
        out, unc = jm(p, j(pts), j(views))
        return jnp.sum(out ** 2) + jnp.sum(unc ** 2)

    ref = jax_params_to_state_dict(jax.device_get(jax.grad(loss)(params)))
    out, unc = tm(t(pts), t(views))
    (torch.sum(out ** 2) + torch.sum(unc ** 2)).backward()
    if threshold < 0:
        deepest = f"rgb.{tm.node_num - 1}.view.w"
        assert float(ref[deepest].abs().sum()) > 0
    assert all(a.grad is None for a in tm.anchors)
    _close_grads(tm, ref)


def test_kmeans_and_split_anchors_exact():
    """kmeans (with and without padding to k points) and split_anchors on
    the same numpy points and uncertainties: bit for bit."""
    rng = np.random.default_rng(0)
    pts = np.concatenate([rng.normal(loc=-2, size=(100, 3)),
                          rng.normal(loc=2, size=(100, 3))]).astype(np.float32)
    for k in (1, 2):
        np.testing.assert_array_equal(tr.kmeans(pts, k, seed=3),
                                      jr.kmeans(pts, k, seed=3))
    np.testing.assert_array_equal(tr.kmeans(pts[:1], 2), jr.kmeans(pts[:1], 2))
    unc = rng.normal(scale=0.05, size=len(pts)).astype(np.float32)
    for head_num in (1, 4, 8):
        jm, params, tm = _pair(head_num)
        want = jr.split_anchors(jm, params, pts, unc)
        assert tr.split_anchors(tm, t(pts), t(unc)) is tm
        for a, b in zip(tm.anchors, want["anchors"]):
            np.testing.assert_array_equal(n(a), np.asarray(b))
    # no point over the threshold: every point is used
    jm, params, tm = _pair(4)
    want = jr.split_anchors(jm, params, pts, np.zeros_like(unc))
    tr.split_anchors(tm, t(pts), t(np.zeros_like(unc)))
    np.testing.assert_array_equal(n(tm.anchors[0]), np.asarray(
        want["anchors"][0]))


def _jax_script(jm, tx, S):
    """The JAX script's render, loss and jitted step
    (`projects/recursive_nerf/main.py:83-119`)."""
    near, far = 2.0, 6.0

    def render(p, ro, rd, kk, max_level):
        u = jax.random.uniform(kk, (S,)) / S
        z = near + (far - near) * (jnp.linspace(0, 1, S + 1)[:-1] + u)
        pts = ro[:, None, :] + rd[:, None, :] * z[None, :, None]
        views = jnp.repeat(rd, S, axis=0)
        raw, uncert = jm(p, pts.reshape(-1, 3), views, max_level=max_level)
        raw = raw.reshape(-1, S, 4)
        uncert = uncert.reshape(-1, S)
        delta = jnp.concatenate([jnp.diff(z), jnp.asarray([1e10])])
        delta = delta[None, :] * jnp.linalg.norm(rd, axis=-1, keepdims=True)
        alpha = 1 - jnp.exp(-jax.nn.relu(raw[..., 3]) * delta)
        trans = jnp.cumprod(jnp.concatenate(
            [jnp.ones_like(alpha[:, :1]), 1 - alpha + 1e-7], -1), -1)[:, :-1]
        w = alpha * trans
        rgb = jnp.sum(w[..., None] * jax.nn.sigmoid(raw[..., :3]), -2)
        return rgb, uncert, pts.reshape(-1, 3)

    def make_step(max_level):
        def loss_fn(p, ro, rd, target, kk):
            rgb, uncert, _ = render(p, ro, rd, kk, max_level)
            err = jnp.mean((rgb - target) ** 2, axis=-1)
            mse = err.mean()
            u_loss = jnp.mean(
                (uncert - jax.lax.stop_gradient(err)[:, None]) ** 2)
            return mse + 0.1 * u_loss, mse

        @jax.jit
        def step(p, o, ro, rd, target, kk):
            (loss, mse), grads = jax.value_and_grad(loss_fn, has_aux=True)(
                p, ro, rd, target, kk)
            updates, o = tx.update(grads, o, p)
            return optax.apply_updates(p, updates), o, mse

        return step, loss_fn

    return render, make_step


def test_script_loss_and_gradients_match_jax():
    """The scripts' loss (MSE + 0.1 x the uncertainty loss against the
    detached error) on one batch at level 3, head_num 8, W=32 and random
    anchors: loss and MSE at rtol 1e-5, the gradients as above."""
    S = 16
    jm, params, tm = _pair(8, anchors_seed=3)
    images, poses, focal = tmain.make_synthetic(2, 12, 12)
    ro, rd, rgb = tmain.camera_rays(images, poses, focal)
    sel = np.random.default_rng(1).integers(0, len(ro), 64)
    _, make_step = _jax_script(jm, optax.adam(5e-4), S)
    kk = jax.random.PRNGKey(4)
    (jl, jmse), jg = jax.value_and_grad(make_step(3)[1], has_aux=True)(
        params, j(ro[sel]), j(rd[sel]), j(rgb[sel]), kk)
    loss, mse = tmain.loss_fn(tm, t(ro[sel]), t(rd[sel]), t(rgb[sel]),
                              t(jax.random.uniform(kk, (S,))), 3, S)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(mse.detach()), float(jmse), rtol=1e-5)
    _close_grads(tm, jax_params_to_state_dict(jax.device_get(jg)))


def test_lockstep_training_across_a_stage_transition(capsys, monkeypatch):
    """Both scripts' loops (the JAX one rebuilt from main.py:121-152) from
    the same weights, batches (np.random.default_rng(0)) and jitter (the
    JAX keys' draws, passed in), head_num 4, W=32: one step at level 0, the
    k-means split, two steps at level 1.  Every step's MSE at rtol 1e-4;
    at the split, the points over the threshold the same set but at
    near-ties (counted: none here) and the anchors at atol 1e-5 (k-means
    of points equal to ~1e-6); the parameters after the three steps
    within 1e-6 on 95% of the entries, and within Adam's bound of 2 lr a
    step on the rest: Adam normalises each entry, so an entry whose
    gradient lies within the two packages' f32 noise of zero (1e-5 of the
    tensor's largest entry) moves by up to lr in either direction (2.1%
    of the entries here, most in the first layer, whose hidden units few
    points activate).

    Why one step before the split: such differences grow.  A ReLU network
    turns them into flipped activations and gradients that differ by 1e-3
    of their largest entry two steps later; by the third step at this
    width the confidence of points whose hidden units are all dead, which
    is the head's bias, differs by 2e-3 and moves whole rays across the
    threshold, which no tolerance on the k-means that follows absorbs."""
    S, n_rand, steps1, steps = 8, 64, 1, 3
    jm, params, tm = _pair(4, seed=0)
    images, poses, focal = tmain.make_synthetic(2, 12, 12)
    ro, rd, rgb = tmain.camera_rays(images, poses, focal)
    tx = optax.adam(5e-4)
    render, make_step = _jax_script(jm, tx, S)
    opt_state = tx.init(params)
    key = jax.random.split(jax.random.PRNGKey(0))[0]  # after the init's
    rng = np.random.default_rng(0)
    p, us, jmses, split = params, [], [], None
    for lvl, n_steps in ((0, steps1), (1, steps - steps1)):
        step = make_step(lvl)[0]
        for _ in range(n_steps):
            s = rng.integers(0, len(ro), n_rand)
            key, kk = jax.random.split(key)
            us.append(t(jax.random.uniform(kk, (S,))))
            p, opt_state, jmse = step(p, opt_state, j(ro[s]), j(rd[s]),
                                      j(rgb[s]), kk)
            jmses.append(float(jmse))
        if lvl == 0:
            s = rng.integers(0, len(ro), tmain.SPLIT_RAYS)
            key, kk = jax.random.split(key)
            us.append(t(jax.random.uniform(kk, (S,))))
            _, unc, pts = render(p, j(ro[s]), j(rd[s]), kk, 0)
            split = (np.asarray(pts), np.asarray(unc).reshape(-1))
            p = jr.split_anchors(jm, p, *split)
    seen = []

    def spy(model, pts, uncert, threshold=None):
        seen.append((n(pts), n(uncert)))
        return tr.split_anchors(model, pts, uncert, threshold)

    monkeypatch.setattr(tmain, "split_anchors", spy)
    hist = tmain.train(tm, images, poses, focal, n_iters=steps,
                       step1=steps1, step2=steps, step3=steps, n_rand=n_rand,
                       n_samples=S, draws=iter(us))
    out = capsys.readouterr().out.splitlines()
    assert out == [f"iter 0 (level 0): mse={hist['mse'][0]:.5f}",
                   "stage -> level 1: anchors updated"]
    assert hist["transitions"] == [1]
    assert [s[:2] for s in hist["stages"]] == [(0, 1), (1, 2), (2, 0), (3, 0)]
    np.testing.assert_allclose(hist["mse"], jmses, rtol=1e-4)
    (pts, unc), = seen
    np.testing.assert_array_equal(pts, split[0])
    hard, jhard = unc > 3e-2, split[1] > 3e-2
    assert 0 < hard.sum() < len(hard)
    differ = hard != jhard
    assert (np.abs(split[1][differ] - 3e-2) < TIE).all()
    assert differ.sum() == 0  # near-ties at the split (moves the k-means)
    for a, b in zip(tm.anchors, p["anchors"]):
        np.testing.assert_allclose(n(a), np.asarray(b), rtol=0, atol=1e-5)
    assert float(np.abs(n(tm.anchors[0])).sum()) > 0
    got = jax_params_to_state_dict(jax.device_get(p))
    n_off, n_all = 0, 0
    for name, q in tm.state_dict().items():
        d = np.abs(n(q) - n(got[name]))
        assert d.max() <= 2 * 5e-4 * steps, name
        n_off += int((d > 1e-6).sum())
        n_all += d.size
    assert n_off <= n_all // 20, (n_off, n_all)


def test_main_functions_print_and_pickles_pass_both_ways(tmp_path, capsys):
    """The port script's functions at a tiny size (head_num 8, W=32, 2
    views of 12^2, 5 iterations over every stage): its lines and
    recursive_nerf.pkl, which the JAX network applies with the port's
    outputs (see above); a JAX-written pickle loaded by the
    port; the round trip of the tree exact."""
    images, poses, focal = tmain.make_synthetic(2, 12, 12)
    model = tmain.build_model("cpu", head_num=8, width=32)
    hist = tmain.train(model, images, poses, focal, n_iters=5, step1=1,
                       step2=2, step3=3, n_rand=32, n_samples=8)
    path = tmain.save(model, str(tmp_path))
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("iter 0 (level 0): mse=")
    assert [ln for ln in out if ln.startswith("stage")] == [
        f"stage -> level {k}: anchors updated" for k in (1, 2, 3)]
    assert out[-1] == f"saved {path}" and len(hist["mse"]) == 5

    with open(path, "rb") as f:
        params = pickle.load(f)
    jm = jr.RecursiveNeRF(head_num=8, W=32)
    rng = np.random.default_rng(5)
    pts = rng.uniform(-1, 1, (256, 3)).astype(np.float32)
    views = rng.normal(size=(256, 3)).astype(np.float32)
    with torch.no_grad():
        got = model(t(pts), t(views))
    for a, b in zip(got, jm(params, j(pts), j(views))):
        _close(n(a), n(b))

    _, jparams, _ = _pair(8, anchors_seed=2)
    jpath = tmp_path / "jax_recursive_nerf.pkl"
    with open(jpath, "wb") as f:
        pickle.dump(jparams, f)  # as the JAX script writes it
    back = tr.RecursiveNeRF(head_num=8, W=32)
    with open(jpath, "rb") as f:
        back.load_state_dict(jax_params_to_state_dict(pickle.load(f)))
    with torch.no_grad():
        got = back(t(pts), t(views))
    for a, b in zip(got, jm(jparams, j(pts), j(views))):
        _close(n(a), n(b))
    again = state_dict_to_jax_params(back.state_dict())
    assert jax.tree.structure(again) == jax.tree.structure(jparams)
    for a, b in zip(jax.tree.leaves(again), jax.tree.leaves(jparams)):
        np.testing.assert_array_equal(a, b)


def test_main_refuses_without_a_card():
    """``main`` defaults to --device cuda, which needs a card."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmain.main(["--synthetic", "--n-iters", "0"])


def test_mini_profile_runs_on_cpu(monkeypatch, capsys):
    """`tools/mini_profile.py` on the CPU for both projects, their models
    and scenes shrunk: one step profiled, its host time printed and the
    device time reported as not measured."""
    from jnerf_tpu_torch.projects.pixelnerf import main as pix
    from jnerf_tpu_torch.tools import mini_profile

    synth, pix_model, rec_model = (pix.make_synthetic, pix.build_model,
                                   tmain.build_model)
    small = lambda *a, **k: synth(4, 16, 16)  # noqa: E731
    monkeypatch.setattr(pix, "make_synthetic", small)
    monkeypatch.setattr(pix, "build_model",
                        lambda device: pix_model(device, net_width=16))
    monkeypatch.setattr(tmain, "build_model",
                        lambda device: rec_model(device, width=16))
    for project in ("pixelnerf", "recursive_nerf"):
        mini_profile.main(["--project", project, "--device", "cpu",
                           "--warmup", "1", "--steps", "1", "--rows", "3"])
        line = capsys.readouterr().out.splitlines()[0]
        assert line.startswith(f"{project}: ") and line.endswith(
            "device time not measured on the CPU; on cpu")


def test_main_on_a_blender_scene_keeps_the_identity_poses(tmp_path,
                                                          monkeypatch):
    """--datadir reads the images of a blender scene and, as the JAX script
    does, gives each an identity pose (ROADMAP section 3): every ray the
    loop trains on starts at the origin."""
    from jnerf_tpu_torch.dataset.synthetic import make_synthetic_scene

    scene = make_synthetic_scene(str(tmp_path / "scene"), n_train=2,
                                 n_val=1, n_test=1, H=8, W=8)
    seen = []
    rays = tmain.camera_rays

    def spy(images, poses, focal):
        seen.append((images.shape, poses.copy()))
        return rays(images, poses, focal)

    monkeypatch.setattr(tmain, "camera_rays", spy)
    model, hist = tmain.main([
        "--datadir", scene, "--n-iters", "2", "--step1", "1", "--step2",
        "1", "--step3", "1", "--n-rand", "16", "--n-samples", "4",
        "--width", "16", "--device", "cpu", "--out", str(tmp_path / "out")])
    (shape, poses), = seen
    assert shape == (3, 8, 8, 3)  # train + val frames, rgb
    np.testing.assert_array_equal(poses, np.stack([np.eye(4)] * 3))
    assert len(hist["mse"]) == 2
    assert (tmp_path / "out" / "recursive_nerf.pkl").is_file()

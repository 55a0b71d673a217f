"""The port's checkpoints (`Runner.save_ckpt` / `load_ckpt` /
``cfg.load_ckpt``), at the tiny NGP scale of tests/test_torch_step.py:
a port checkpoint reloads bit for bit, and checkpoints pass both ways
between the port and the JAX runner."""

import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_parity import both_cfgs, n, t  # noqa: F401

CHUNK = 256  # render chunk rays, as in tests/test_torch_render.py


def _jax_render_u():
    """The jitter the JAX render draws for every chunk (PRNGKey(0))."""
    return t(jax.random.uniform(jax.random.PRNGKey(0), (CHUNK,)))


def _port_runner(**cfg):
    from jnerf_tpu_torch.runner import Runner
    from jnerf_tpu_torch.utils.config import get_cfg

    get_cfg().update(cfg)
    r = Runner(device="cpu")
    r.render_chunk_rays = CHUNK
    return r


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def test_port_ckpt_reloads_bitwise(both_cfgs, tmp_path):
    """16 steps, save, then a fresh Runner built with cfg.load_ckpt: the
    checkpoint holds only numpy arrays and Python scalars under the JAX
    keys; the reloaded runner resumes at step 16, renders val view 0 bit
    for bit as the saved one does, and takes the same next step (same
    draws) to the same loss and parameters, bit for bit."""
    tr = _port_runner()
    tr.train_range(0, 16)
    path = tmp_path / "ckpt" / "params.pkl"
    tr.save_ckpt(str(path))
    with open(path, "rb") as f:
        ckpt = pickle.load(f)
    assert set(ckpt) == {"global_step", "model", "sampler", "optimizer",
                         "nested_optimizer", "ema_optimizer"}
    assert set(ckpt["nested_optimizer"]) == {"count", "mu", "nu"}
    assert all(isinstance(x, (np.ndarray, int, float, type(None)))
               for x in _leaves(ckpt))

    r2 = _port_runner(load_ckpt=True, ckpt_path=str(path))
    assert r2.start == ckpt["global_step"] == 16
    assert r2.optimizer.count == 16 and r2.ema_state["steps"] == 16
    u = _jax_render_u()
    np.testing.assert_array_equal(r2.render_img("val", img_id=0, u=u)[0],
                                  tr.render_img("val", img_id=0, u=u)[0])

    ds = tr.dataset["train"]
    n_rays = tr.sampler.n_rays_per_batch
    assert r2.sampler.n_rays_per_batch == n_rays
    rng = np.random.default_rng(3)
    idx = t(rng.integers(0, ds.n_images * ds.H * ds.W, n_rays), torch.int64)
    bg = t(rng.uniform(size=(n_rays, 3)).astype(np.float32))
    u = t(rng.uniform(size=n_rays).astype(np.float32))
    losses = [float(r.train_step(idx=idx, bg=bg, u=u)) for r in (tr, r2)]
    assert losses[0] == losses[1]
    for a, b in zip(tr.params, r2.params):
        assert torch.equal(a, b)


def test_jax_runner_loads_port_ckpt(both_cfgs, tmp_path):
    """The JAX runner loads a port checkpoint after 16 port steps (model,
    sampler, EMA and Adam state) and renders both test images as the port
    does, within tests/test_torch_render.py's atol 1e-3."""
    from jnerf_tpu.runner import Runner as JaxRunner

    tr = _port_runner()
    tr.train_range(0, 16)
    path = str(tmp_path / "params.pkl")
    tr.save_ckpt(path)
    jr = JaxRunner()
    jr.load_ckpt(path)
    jr.render_chunk_rays = CHUNK
    assert jr.start == 16
    from jnerf_tpu.utils.registry import DATASETS, build_from_cfg

    jr.dataset["test"] = build_from_cfg(both_cfgs[0].dataset.test, DATASETS)
    tr.render_test(save_img=False)  # builds the port's test split
    for i in range(2):
        jimg = jr.render_img(dataset_mode="test", img_id=i)[0]
        img = tr.render_img("test", img_id=i, u=_jax_render_u())[0]
        assert float(img.max()) > 0.05
        np.testing.assert_allclose(img, np.asarray(jimg), rtol=0, atol=1e-3)


def test_port_loads_jax_ckpt(both_cfgs, tmp_path):
    """A checkpoint the JAX runner wrote (after its step-0 grid refresh,
    with Adam moments and counts set to known values in its optax state)
    loads into the port: the weights, the Adam state read by field name
    from ScaleByAdamState, the EMA shadow and the grid equal the JAX
    runner's, and both test images render as the JAX runner renders them,
    within atol 1e-3."""
    from jnerf_tpu.runner import Runner as JaxRunner
    from jnerf_tpu.utils.registry import DATASETS, build_from_cfg

    jr = JaxRunner()
    jr._update_grid(0, jax.random.PRNGKey(1))
    rng = np.random.default_rng(5)

    def rand_tree():
        return jax.tree.map(lambda p: jnp.asarray(
            rng.normal(size=p.shape).astype(np.float32)), jr.params)

    adam, rest = jr.opt_state[0], jr.opt_state[1:]
    mu, nu = rand_tree(), jax.tree.map(jnp.abs, rand_tree())
    jr.opt_state = (adam._replace(count=jnp.int32(5), mu=mu, nu=nu),) + rest
    jr.ema_state = {"shadow": rand_tree(), "steps": jnp.int32(3)}
    path = str(tmp_path / "jax_params.pkl")
    jr.save_ckpt(path)

    tr = _port_runner()
    tr.load_ckpt(path)
    assert tr.optimizer.count == 5 and tr.ema_state["steps"] == 3
    want = {"model": jr.params, "mu": mu, "nu": nu,
            "shadow": jr.ema_state["shadow"]}
    got = {"model": tr._jax_tree(tr.params),
           "mu": tr._jax_tree([tr.optimizer.state[p]["mu"] for p in tr.params]),
           "nu": tr._jax_tree([tr.optimizer.state[p]["nu"] for p in tr.params]),
           "shadow": tr._jax_tree(tr.ema_state["shadow"])}
    for k in want:
        for a, b in zip(jax.tree.leaves(got[k]), jax.tree.leaves(want[k])):
            np.testing.assert_array_equal(a, np.asarray(b))
    np.testing.assert_array_equal(n(tr.sampler.state["bitfield"]),
                                  n(jr.sampler.state["bitfield"]))

    jr.render_chunk_rays = CHUNK
    jr.dataset["test"] = build_from_cfg(both_cfgs[0].dataset.test, DATASETS)
    tr.render_test(save_img=False)
    for i in range(2):
        jimg = jr.render_img(dataset_mode="test", img_id=i)[0]
        img = tr.render_img("test", img_id=i, u=_jax_render_u())[0]
        np.testing.assert_allclose(img, np.asarray(jimg), rtol=0, atol=1e-3)


def test_load_ckpt_refuses_a_ckpt_without_adam(both_cfgs, tmp_path):
    tr = _port_runner()
    path = str(tmp_path / "params.pkl")
    tr.save_ckpt(path)
    with open(path, "rb") as f:
        ckpt = pickle.load(f)
    ckpt["nested_optimizer"] = {"count": 0}
    with open(path, "wb") as f:
        pickle.dump(ckpt, f)
    with pytest.raises(ValueError, match="no Adam state"):
        tr.load_ckpt(path)

"""Shared helpers for the PyTorch port's parity tests (tests/test_torch_*.py).

Each parity test makes its inputs with numpy from a seed, runs them
through the JAX package (on the CPU) and through the port (on the CPU,
where every kernel wrapper takes its plain PyTorch twin), and compares the
results at a tolerance it states.
"""

from __future__ import annotations

import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

NGP_BASE = str(Path(__file__).resolve().parents[1]
               / "projects" / "ngp" / "configs" / "ngp_base.py")

# A tiny NGP slice: 4 levels of 8 features over 2^13-entry tables, a 32^3
# occupancy grid, 256 rays; compaction on, as in the bench headline.
TINY_NGP = dict(n_images=4, H=32, W=32, n_rays_per_batch=256,
                target_batch_size=1 << 12, grid_size=32, nerf_steps=128,
                hash_levels=4, hash_features=8, log2_hashmap_size=13)
TINY_EXTRA = dict(compacted_batch=1024, march_budget_factor=2,
                  hash_indexing="linear_nbr")


def t(x, dtype=None) -> torch.Tensor:
    """numpy (or JAX) array -> CPU tensor."""
    out = torch.from_numpy(np.array(x))
    return out if dtype is None else out.to(dtype)


def j(x) -> jnp.ndarray:
    """numpy array or tensor -> JAX array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return jnp.asarray(np.asarray(x))


def n(x) -> np.ndarray:
    """tensor or JAX array -> numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@pytest.fixture()
def both_cfgs(tmp_path):
    """Install the same tiny NGP config in both packages' global config
    singletons; both are cleared again after the test."""
    from jnerf_tpu.utils.bench_cfg import ngp_synthetic_cfg as jax_cfg
    from jnerf_tpu_torch.utils.bench_cfg import ngp_synthetic_cfg as port_cfg

    cfgs = []
    for make in (jax_cfg, port_cfg):
        cfg = make(**TINY_NGP)
        cfg.update(TINY_EXTRA)
        cfg.log_dir = str(tmp_path / "logs")
        cfgs.append(cfg)
    yield tuple(cfgs)
    for cfg in cfgs:
        cfg.clear()


def jax_key_draws(key, n_rays: int, n_pixels: int):
    """The draws one JAX train step makes from its key
    (`jnerf_tpu/runner/runner.py:157-166` and the march start jitter of
    `ops/ray_march.py:215`), as numpy: (idx, u, bg)."""
    k_pix, k_march, k_bg = jax.random.split(key, 3)
    idx = jax.random.randint(k_pix, (n_rays,), 0, n_pixels)
    u = jax.random.uniform(k_march, (n_rays,))
    bg = jax.random.uniform(k_bg, (n_rays, 3))
    return n(idx), n(u), n(bg)


def jax_sweep_jitter(key, n_casc: int, n_sweep: int) -> np.ndarray:
    """The jitter the JAX sweep refresh draws from its key
    (`density_grid_sampler.py:338-346`), as [n_casc, 3, n_sweep]."""
    keys = jax.random.split(key, 3 * n_casc)
    return np.stack([
        np.stack([n(jax.random.uniform(keys[3 * c + d], (n_sweep,)))
                  for d in range(3)])
        for c in range(n_casc)])


def port_grid_state(jax_state) -> dict:
    """A JAX sampler state -> the port's (numpy in between)."""
    return {
        "density_grid": n(jax_state["density_grid"]),
        "bitfield": n(jax_state["bitfield"]),
        "mean": n(jax_state["mean"]),
        "ema_step": int(n(jax_state["ema_step"])),
    }


def grad_capture():
    """An optax transform that applies no update and keeps the gradients
    it was given in its state, so the JAX step's gradients can be read."""
    return optax.GradientTransformation(
        init=lambda p: {"g": jax.tree.map(jnp.zeros_like, p)},
        update=lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), {"g": g}),
    )


def write_blender_cfg(tmp_path, scene, indexing="linear_rows", steps=40):
    """A user's config file over a blender-format scene: ngp_base.py with
    the data, logs, steps and hash indexing overridden, shrunk to a tiny
    NGP (4 levels of 8 features, 2^11-entry tables, 256 rays, a 32^3
    grid, compaction to 1024 samples; with F = 8 the JAX package's linear
    mode takes its Pallas backward, in interpret mode on the CPU, whose
    table gradient the port's kernel B computes)."""
    path = Path(tmp_path) / f"cfg_{indexing}.py"
    path.write_text(textwrap.dedent(f"""\
        _base_ = {NGP_BASE!r}
        dataset_dir = {str(scene)!r}
        dataset = dict(train=dict(root_dir=dataset_dir, batch_size=256),
                       val=dict(root_dir=dataset_dir, batch_size=256),
                       test=dict(root_dir=dataset_dir, batch_size=256))
        log_dir = {str(Path(tmp_path) / "logs")!r}
        tot_train_steps = {steps}
        hash_indexing = {indexing!r}
        encoder = dict(pos_encoder=dict(type="HashEncoder", n_levels=4,
                                        n_features_per_level=8,
                                        log2_hashmap_size=11))
        n_rays_per_batch = 256
        target_batch_size = 1 << 12
        compacted_batch = 1024
        march_budget_factor = 2
        grid_size = 32
        nerf_steps = 128
        seed = 0
    """))
    return str(path)


@pytest.fixture()
def clear_cfgs():
    """Clear both packages' global config singletons after the test."""
    from jnerf_tpu.utils.config import get_cfg as jax_cfg
    from jnerf_tpu_torch.utils.config import get_cfg as port_cfg

    yield
    jax_cfg().clear()
    port_cfg().clear()


def assert_one_step_matches(jr, tr, key=None, min_valid=1):
    """One training step of the JAX runner ``jr`` and of the port's ``tr``
    (the port's params and grid state already converted from ``jr``'s) on
    the same draws from the JAX step's key: the loss at rtol 1e-3 and, per
    gradient tensor, max |diff| <= 2e-2 and mean |diff| <= 1e-3 of its
    largest entry (bf16 MLP chains whose f32 sums run in another order; see
    tests/test_torch_step.py).  The march must keep at least ``min_valid``
    samples.  Returns (n_rays, n_samples)."""
    from jnerf_tpu_torch.utils.convert import (
        jax_params_to_state_dict, state_dict_to_jax_params,
    )

    jr.tx, jr.ema = grad_capture(), None
    n_rays, n_samples = jr.sampler.n_rays_per_batch, jr.sampler.n_samples_per_ray
    assert (n_rays, n_samples) == (tr.sampler.n_rays_per_batch,
                                   tr.sampler.n_samples_per_ray)
    step = jax.jit(jr._step_fn_body(n_rays, n_samples))
    key = jax.random.PRNGKey(7) if key is None else key
    _, opt_state, _, _, jloss = step(jr.params, jr.tx.init(jr.params), None,
                                     jr.sampler.state, jr._train_data(), key)

    ds = tr.dataset["train"]
    idx, u, bg = jax_key_draws(key, n_rays, ds.n_images * ds.H * ds.W)
    total, main, samples = tr.forward_loss(n_rays, n_samples,
                                           idx=t(idx, torch.int64), bg=t(bg),
                                           u=t(u))
    assert int(samples.valid.sum()) >= min_valid
    np.testing.assert_allclose(float(main.detach()), float(jloss), rtol=1e-3)
    total.backward()
    jgrads = state_dict_to_jax_params(
        jax_params_to_state_dict(jax.tree.map(np.asarray, opt_state["g"])))
    grads = state_dict_to_jax_params(
        {name: p.grad for name, p in tr.model.named_parameters()})
    for (path, got), ref in zip(jax.tree_util.tree_leaves_with_path(grads),
                                jax.tree.leaves(jgrads)):
        scale = float(np.abs(ref).max())
        assert scale > 0, path
        diff = np.abs(got - ref)
        name = jax.tree_util.keystr(path)
        assert diff.max() <= 2e-2 * scale, (name, diff.max() / scale)
        assert diff.mean() <= 1e-3 * scale, (name, diff.mean() / scale)
    return n_rays, n_samples

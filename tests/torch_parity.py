"""Shared helpers for the PyTorch port's parity tests (tests/test_torch_*.py).

Each parity test makes its inputs with numpy from a seed, runs them
through the JAX package (on the CPU) and through the port (on the CPU,
where every kernel wrapper takes its plain PyTorch twin), and compares the
results at a tolerance it states.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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

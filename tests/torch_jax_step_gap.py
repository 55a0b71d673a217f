"""How far a JAX train step is from itself and from the port's, on the CPU.

    JAX_PLATFORMS=cpu python tests/torch_jax_step_gap.py

The config is tests/test_torch_parallel.py's (f32, Adam eps 1e-8, the
neighbour-table encoder in both packages), one step after the step-0
refresh, from the same params, keys and draws.  Prints, for each gradient,
max |diff| over its largest entry between the jitted JAX step and (a) the
same step run eagerly under ``jax.disable_jit``, (b) the port's one-process
step; then the largest parameter difference after Adam and EMA between the
jitted JAX step and the port's, and the relative gap of each package's
float32 grid mean to the float64 mean of the JAX grid.  The numbers that
`tests/test_torch_parallel.py::test_two_rank_step_matches_jax_mesh_step`
cites come from this script.
"""

import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

import test_torch_parallel as T  # noqa: E402
from torch_parity import jax_key_draws, jax_sweep_jitter  # noqa: E402


def main():
    from jnerf_tpu.runner import Runner
    from jnerf_tpu.utils.bench_cfg import ngp_synthetic_cfg
    from jnerf_tpu.utils.config import get_cfg
    from jnerf_tpu_torch.parallel import dryrun
    from jnerf_tpu_torch.utils.config import get_cfg as port_cfg
    from jnerf_tpu_torch.utils.convert import jax_params_to_state_dict

    cfg = ngp_synthetic_cfg(**T.JAX_TINY)
    cfg.optim.eps = T.TIGHT["optim.eps"]
    cfg.hash_indexing = T.TIGHT["hash_indexing"]
    jr = Runner()
    params = jax.device_get(jr.params)
    jr._update_grid(0, jax.random.PRNGKey(T.GRID_KEY))
    jr.tx = optax.chain(T._keep_grads(), jr.tx)
    n_rays, n_samples = jr.sampler.n_rays_per_batch, jr.sampler.n_samples_per_ray
    body = jr._step_fn_body(n_rays, n_samples)
    key = jax.random.PRNGKey(T.KEY)
    out = {}
    for name, disable in (("jit", False), ("eager", True)):
        p0 = jax.tree.map(jnp.asarray, params)
        with jax.disable_jit(disable):
            fn = body if disable else jax.jit(body)
            res = fn(p0, jr.tx.init(p0), jr.ema.init(p0), jr.sampler.state,
                     jr._train_data(), key)
        out[name] = {
            "grads": jax_params_to_state_dict(jax.device_get(res[1][0]["g"])),
            "params": jax_params_to_state_dict(jax.device_get(res[0]))}
    jgrid = np.asarray(jr.sampler.state["density_grid"], np.float64)
    jmean = float(jr.sampler.state["mean"])
    n_casc = jr.sampler.grid_config.max_cascade + 1
    get_cfg().clear()

    n_pixels = T.JAX_TINY["n_images"] * T.JAX_TINY["H"] * T.JAX_TINY["W"]
    idx, u, bg = jax_key_draws(key, n_rays, n_pixels)
    jitter = jax_sweep_jitter(jax.random.PRNGKey(T.GRID_KEY), n_casc,
                              T.JAX_TINY["grid_size"] ** 3)
    spec = {"cfg": T.JAX_TINY, "set": T.TIGHT, "refresh_step": 0,
            "jitter": jitter, "draws": (idx, bg, u),
            "params": jax.tree.map(np.asarray, params)}
    try:
        port = dryrun.step_case(None, torch.device("cpu"), spec)
    finally:
        port_cfg().clear()

    ref = out["jit"]["grads"]
    print("gradient max |diff| / largest entry, against the jitted JAX step")
    for name, g in ref.items():
        scale = float(g.abs().max())
        eager = float((out["eager"]["grads"][name] - g).abs().max()) / scale
        ported = float((port["grads"][name] - g).abs().max()) / scale
        print(f"  {name}: JAX eager {eager:.3g}, port {ported:.3g}")
    gap = max(float((port["params"][k] - p).abs().max())
              for k, p in out["jit"]["params"].items())
    print(f"largest param difference after Adam + EMA, port vs JAX: {gap:.3g}")
    exact = np.maximum(jgrid[0], 0).mean()
    print(f"grid mean relative gap to the f64 mean: JAX "
          f"{abs(jmean - exact) / exact:.3g}, port "
          f"{abs(float(port['grid']['mean']) - exact) / exact:.3g}")


if __name__ == "__main__":
    main()

"""NGP model pieces of the PyTorch port against the JAX package: config
and registry, the SH encoder, the network (weights converted both ways),
the losses, and Adam + ExpDecay + EMA against optax on identical grads."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_parity import both_cfgs, j, n, t  # noqa: F401

CONFIG_DIR = os.path.join(os.path.dirname(__file__), "..", "projects", "ngp",
                          "configs")
CONFIGS = ["ngp_base.py", "ngp_comp.py", "ngp_fox.py", "ngp_llff.py"]


@pytest.mark.parametrize("path", CONFIGS)
def test_config_loads_like_jax(path):
    """Same ``_base_`` merge and ``_cover_`` replacement as the JAX package:
    the reference's config files load to the same tree."""
    from jnerf_tpu.utils.config import Config as JaxConfig
    from jnerf_tpu_torch.utils.config import Config

    path = os.path.join(CONFIG_DIR, path)
    assert Config(path).dump() == JaxConfig(path).dump()


def test_registry_names_match_jax():
    """The seven registries, with every name the slice builds."""
    import jnerf_tpu.utils.registry as jreg
    import jnerf_tpu_torch  # noqa: F401  (registers the components)
    import jnerf_tpu_torch.utils.registry as treg

    names = ["DATASETS", "ENCODERS", "NETWORKS", "SAMPLERS", "LOSSES",
             "OPTIMS", "SCHEDULERS"]
    for name in names:
        assert getattr(treg, name).name == getattr(jreg, name).name
    built = {"DATASETS": ["SyntheticSpheresDataset"],
             "ENCODERS": ["HashEncoder", "SHEncoder"],
             "NETWORKS": ["NGPNetworks"], "SAMPLERS": ["DensityGridSampler"],
             "LOSSES": ["HuberLoss", "MSELoss"],
             "OPTIMS": ["Adam", "ExpDecay", "EMA"]}
    for reg, keys in built.items():
        for key in keys:
            assert key in getattr(treg, reg) and key in getattr(jreg, reg)
    with pytest.raises(KeyError, match="not registered"):
        treg.build_from_cfg(dict(type="NoSuchThing"), treg.LOSSES)


def test_sh_encoder_matches_jax():
    """Elementwise polynomials in f32: atol 1e-6."""
    from jnerf_tpu.ops.sh import sh_encode as jax_sh
    from jnerf_tpu_torch.ops.sh import sh_encode

    dirs = np.random.default_rng(0).uniform(size=(512, 3)).astype(np.float32)
    for degree in (1, 2, 3, 4):
        np.testing.assert_allclose(n(sh_encode(t(dirs), degree)),
                                   n(jax_sh(jnp.asarray(dirs), degree)),
                                   rtol=0, atol=1e-6)


def _jax_and_port_networks(both_cfgs, fp16=True):
    from jnerf_tpu.models.networks.ngp_network import NGPNetworks as JaxNGP
    from jnerf_tpu_torch.models.networks import NGPNetworks
    from jnerf_tpu_torch.utils.convert import jax_params_to_state_dict

    for cfg in both_cfgs:
        cfg.fp16 = fp16
    jnet = JaxNGP()
    params = jax.tree.map(np.asarray, jnet.init(jax.random.PRNGKey(0)))
    net = NGPNetworks()
    net.load_state_dict(jax_params_to_state_dict(params))
    return jnet, params, net


@pytest.mark.parametrize("fp16", [True, False])
def test_network_matches_jax(both_cfgs, fp16):
    """Forward, density head and parameter gradients of the NGP network
    (f8l4 hash grid, bf16 or f32 compute) against the JAX ``apply_mlp``
    chain with the same weights.  Both round the same operands to bf16 and
    accumulate in f32 in another order, so a hidden activation can land one
    bf16 ulp (2^-8 relative) apart: rtol 1e-2 / atol 1e-3 for the outputs
    and for the gradients relative to their largest entry.  In f32 only
    the summation order differs: 1e-4, except for the table gradient, which
    on the CPU the JAX package takes from its XLA adjoint; that rounds the
    upstream gradient to bf16 even in f32 compute, so the JAX tests' own
    5e-2 / 5e-3 apply there."""
    jnet, params, net = _jax_and_port_networks(both_cfgs, fp16)
    rng = np.random.default_rng(1)
    pos = rng.uniform(size=(1024, 3)).astype(np.float32)
    dirs = rng.uniform(size=(1024, 3)).astype(np.float32)
    r = rng.normal(size=(1024, 4)).astype(np.float32)
    tol = 1e-2 if fp16 else 1e-4

    ref = n(jnet(params, jnp.asarray(pos), jnp.asarray(dirs)))
    out = net(t(pos), t(dirs))
    assert out.dtype == torch.float32 and out.shape == (1024, 4)
    np.testing.assert_allclose(n(out), ref, rtol=tol, atol=tol / 10)
    np.testing.assert_allclose(n(net.density(t(pos))),
                               n(jnet.density(params, jnp.asarray(pos))),
                               rtol=tol, atol=tol / 10)

    jgrads = jax.grad(lambda p: jnp.sum(
        jnet(p, jnp.asarray(pos), jnp.asarray(dirs)) * r))(
            jax.tree.map(jnp.asarray, params))
    (out * t(r)).sum().backward()
    from jnerf_tpu_torch.utils.convert import jax_params_to_state_dict

    jsd = jax_params_to_state_dict(jax.tree.map(np.asarray, jgrads))
    for name, p in net.named_parameters():
        ref_g = n(jsd[name])
        scale = float(np.abs(ref_g).max())
        gtol = 5e-2 if name == "pos_encoder.grid" and not fp16 else tol
        np.testing.assert_allclose(n(p.grad), ref_g, rtol=gtol,
                                   atol=gtol * scale / 10, err_msg=name)


def test_convert_round_trip(both_cfgs):
    """JAX tree -> state_dict -> JAX tree is the identity, and a port
    network's state_dict converts to a tree the JAX network runs."""
    from jnerf_tpu_torch.utils.convert import state_dict_to_jax_params

    jnet, params, net = _jax_and_port_networks(both_cfgs)
    back = state_dict_to_jax_params(net.state_dict())
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)


def test_network_init_and_pallas_mlp_option(both_cfgs):
    """A generator draws every parameter (table within +-1e-4, He-uniform
    weights); cfg.use_pallas_mlp opens the fused-MLP gate exactly where
    the JAX package's does (use_fully, bf16, the fused geometry), and
    nowhere without it."""
    from jnerf_tpu.models.networks.ngp_network import NGPNetworks as JaxNGP
    from jnerf_tpu_torch.models.networks import NGPNetworks

    net = NGPNetworks(generator=torch.Generator().manual_seed(3))
    grid = net.pos_encoder.grid
    assert 0 < float(grid.detach().abs().max()) <= 1e-4
    w0 = net.density_mlp.weights[0]
    assert w0.shape == (32, 64)
    assert float(w0.detach().abs().max()) <= np.sqrt(6.0 / 32)
    assert not net._fused_ok and not JaxNGP()._fused_ok
    for cfg in both_cfgs:
        cfg.use_pallas_mlp = True
    cases = [dict(fp16=True, kw={}), dict(fp16=False, kw={}),
             dict(fp16=True, kw=dict(use_fully=False)),
             dict(fp16=True, kw=dict(rgb_n_neurons=32))]
    gates = []
    for case in cases:
        for cfg in both_cfgs:
            cfg.fp16 = case["fp16"]
        gates.append((NGPNetworks(**case["kw"])._fused_ok,
                      JaxNGP(**case["kw"])._fused_ok))
    assert gates == [(True, True), (False, False), (False, False),
                     (False, False)]


def test_losses_match_jax():
    from jnerf_tpu.models import losses as jl
    from jnerf_tpu_torch.models import losses as tl

    rng = np.random.default_rng(2)
    x = rng.uniform(size=(256, 3)).astype(np.float32)
    y = rng.uniform(size=(256, 3)).astype(np.float32)
    np.testing.assert_allclose(n(tl.HuberLoss(0.1)(t(x), t(y))),
                               n(jl.HuberLoss(0.1)(j(x), j(y))), rtol=1e-6)
    np.testing.assert_allclose(n(tl.MSELoss()(t(x), t(y))),
                               n(jl.MSELoss()(j(x), j(y))), rtol=1e-6)
    mse = tl.img2mse(t(x), t(y))
    np.testing.assert_allclose(float(mse), float(jl.img2mse(j(x), j(y))),
                               rtol=1e-6)
    np.testing.assert_allclose(float(tl.mse2psnr(mse)),
                               float(jl.mse2psnr(j(n(mse)))), rtol=1e-6)


def test_adam_expdecay_ema_match_optax():
    """Eight steps of ExpDecay(Adam) + EMA on the same gradients as the JAX
    package's optax chain, the decay starting at step 2 so that the
    schedule's pre-increment read shows.  The same f32 formulas in another
    association order: rtol 1e-5, atol 1e-7 (params of order 1)."""
    from jnerf_tpu import optims as jo
    from jnerf_tpu_torch import optims as to

    rng = np.random.default_rng(4)
    shapes = [(64, 8), (32, 64), (16,)]
    init = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(size=s).astype(np.float32) * 10.0 ** -k
              for s in shapes] for k in range(8)]
    kw = dict(decay_start=2, decay_interval=3, decay_base=0.33)

    jdecay = jo.ExpDecay(jo.Adam(lr=1e-1, eps=1e-15, betas=(0.9, 0.99)), **kw)
    tx = jdecay.make()
    jema = jo.EMA(0.95)
    jparams = [jnp.asarray(p) for p in init]
    opt_state, ema_state = tx.init(jparams), jema.init(jparams)

    params = [torch.nn.Parameter(t(p)) for p in init]
    tdecay = to.ExpDecay(to.Adam(lr=1e-1, eps=1e-15, betas=(0.9, 0.99)), **kw)
    opt = tdecay.make(params)
    tema = to.EMA(0.95)
    ema_state_t = tema.init(params)

    for step, gs in enumerate(grads):
        assert tdecay.schedule(step) == pytest.approx(
            float(jdecay.schedule(step)), rel=1e-6)
        upd, opt_state = tx.update([jnp.asarray(g) for g in gs], opt_state,
                                   jparams)
        jparams = [p + u for p, u in zip(jparams, upd)]
        jparams, ema_state = jema.step(jparams, ema_state)

        for p, g in zip(params, gs):
            p.grad = t(g)
        opt.step()
        tema.step(params, ema_state_t)
        for p, q in zip(params, jparams):
            np.testing.assert_allclose(n(p), n(q), rtol=1e-5, atol=1e-7,
                                       err_msg=f"step {step}")

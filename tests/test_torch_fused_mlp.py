"""The port's fused NGP MLP (`jnerf_tpu_torch/ops/fused_mlp.py`) against
the JAX package's (`jnerf_tpu/ops/fused_mlp.py`, Pallas in interpret mode
on the CPU, as its own tests run it).  On the CPU the port runs the
kernels' plain twins; `tests/test_torch_cuda.py` holds the kernels against
the twins on the card."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from jnerf_tpu.ops import fused_mlp as jfm
from jnerf_tpu_torch.ops import fused_mlp as fm
from torch_parity import both_cfgs, n, t  # noqa: F401


@pytest.fixture(scope="module")
def data():
    """The inputs of tests/test_fused_mlp.py (same key and draws), as
    numpy: weights ~N(0, 1/fan_in), x and d ~U(-1, 1), g ~N(0, 1), at
    n = 2 blocks of 8192 rows."""
    key = jax.random.PRNGKey(0)
    kw, kx, kd, kg = jax.random.split(key, 4)
    ks = jax.random.split(kw, 5)
    weights = tuple(
        n(jax.random.normal(k, s, jnp.float32) * (1.0 / np.sqrt(s[0])))
        for k, s in zip(ks, fm.WEIGHT_SHAPES))
    rows = 2 * jfm._BLK
    x = n(jax.random.uniform(kx, (rows, jfm.D_IN), jnp.float32, -1, 1))
    d = n(jax.random.uniform(kd, (rows, jfm.SH_DIM), jnp.float32, -1, 1))
    g = n(jax.random.normal(kg, (rows, 4), jnp.float32))
    return weights, x, d, g


def test_constants_match_jax():
    assert (fm.D_IN, fm.D_HID, fm.D_GEO, fm.SH_DIM, fm.RGB_IN, fm._BLK) == (
        jfm.D_IN, jfm.D_HID, jfm.D_GEO, jfm.SH_DIM, jfm.RGB_IN, jfm._BLK)


def test_forward_matches_jax(data):
    """The same bf16 operands and f32 sums in another order: the JAX
    test's own bounds, rtol 1e-5 / atol 2e-3 (a pre-activation on a bf16
    rounding boundary can move one hidden value by an ulp)."""
    weights, x, d, _ = data
    ref = n(jfm.fused_ngp_mlp(tuple(map(jnp.asarray, weights)),
                              jnp.asarray(x), jnp.asarray(d)))
    out = fm.fused_ngp_mlp(tuple(map(t, weights)), t(x), t(d))
    assert out.dtype == torch.float32 and out.shape == (x.shape[0], 4)
    np.testing.assert_allclose(n(out), ref, rtol=1e-5, atol=2e-3)


def test_backward_matches_jax_grad(data):
    """dpos_feat and the five weight gradients from torch.autograd through
    FusedNGPMLP against jax.grad of the JAX fused_ngp_mlp: atol 2e-3 on
    dx, and 1e-3 of each weight gradient's largest entry (the JAX test's
    bounds for its kernel against its mirror)."""
    weights, x, d, g = data

    def loss(w, xx):
        return jnp.vdot(jfm.fused_ngp_mlp(w, xx, jnp.asarray(d)),
                        jnp.asarray(g))

    jdws, jdx = jax.grad(loss, argnums=(0, 1))(
        tuple(map(jnp.asarray, weights)), jnp.asarray(x))
    ws = [t(w).requires_grad_(True) for w in weights]
    xt = t(x).requires_grad_(True)
    dt = t(d).requires_grad_(True)
    (fm.fused_ngp_mlp(ws, xt, dt) * t(g)).sum().backward()
    np.testing.assert_allclose(n(xt.grad), n(jdx), rtol=1e-5, atol=2e-3)
    for i, (w, ref) in enumerate(zip(ws, jdws)):
        ref = n(ref)
        assert w.grad.shape == ref.shape
        scale = float(np.abs(ref).max())
        np.testing.assert_allclose(n(w.grad) / scale, ref / scale, rtol=0,
                                   atol=1e-3, err_msg=f"weight {i}")
    # View directions are data: dir_feat gets no gradient.
    assert dt.grad is None


def test_density_matches_jax(data):
    """D-MLP's twin against the JAX fused_density_mlp: rtol 1e-5 / atol
    2e-3, as above."""
    weights, x, _, _ = data
    ref = n(jfm.fused_density_mlp(jnp.asarray(weights[0]),
                                  jnp.asarray(weights[1]), jnp.asarray(x)))
    out = fm.fused_density_mlp(t(weights[0]), t(weights[1]), t(x))
    assert out.shape == (x.shape[0], 1)
    np.testing.assert_allclose(n(out), ref, rtol=1e-5, atol=2e-3)


@pytest.mark.parametrize("rows", [fm._BLK, fm._BLK + 64])
def test_network_gate_matches_jax(both_cfgs, monkeypatch, rows):
    """With cfg.use_pallas_mlp, a JAX NGPNetworks and the port's on the
    same (converted) params agree in output and parameter gradients at N =
    8192, where both take the fused function, and at N = 8192 + 64, where
    both run the plain chain.  The CPU runs the twins, which count no
    launches, so a spy on the port's fused_ngp_mlp shows which path ran.
    Bounds: those of tests/test_torch_ngp.py::test_network_matches_jax
    (rtol 1e-2, atol 1e-3; gradients relative to their largest entry)."""
    from jnerf_tpu.models.networks.ngp_network import NGPNetworks as JaxNGP
    from jnerf_tpu_torch.models.networks import NGPNetworks
    from jnerf_tpu_torch.models.networks import ngp_network
    from jnerf_tpu_torch.utils.convert import jax_params_to_state_dict

    for cfg in both_cfgs:
        cfg.use_pallas_mlp = True
    jnet = JaxNGP()
    params = jax.tree.map(np.asarray, jnet.init(jax.random.PRNGKey(0)))
    net = NGPNetworks()
    net.load_state_dict(jax_params_to_state_dict(params))
    assert jnet._fused_ok and net._fused_ok

    calls = []
    real = fm.fused_ngp_mlp
    monkeypatch.setattr(ngp_network._fm, "fused_ngp_mlp",
                        lambda *a: calls.append(1) or real(*a))
    rng = np.random.default_rng(5)
    pos = rng.uniform(size=(rows, 3)).astype(np.float32)
    dirs = rng.uniform(size=(rows, 3)).astype(np.float32)
    r = rng.normal(size=(rows, 4)).astype(np.float32)

    ref = n(jnet(params, jnp.asarray(pos), jnp.asarray(dirs)))
    out = net(t(pos), t(dirs))
    assert len(calls) == (1 if rows % fm._BLK == 0 else 0)
    np.testing.assert_allclose(n(out), ref, rtol=1e-2, atol=1e-3)

    jgrads = jax.grad(lambda p: jnp.sum(
        jnet(p, jnp.asarray(pos), jnp.asarray(dirs)) * r))(
            jax.tree.map(jnp.asarray, params))
    (out * t(r)).sum().backward()
    jsd = jax_params_to_state_dict(jax.tree.map(np.asarray, jgrads))
    for name, p in net.named_parameters():
        ref_g = n(jsd[name])
        scale = float(np.abs(ref_g).max())
        np.testing.assert_allclose(n(p.grad), ref_g, rtol=1e-2,
                                   atol=1e-3 * scale, err_msg=name)

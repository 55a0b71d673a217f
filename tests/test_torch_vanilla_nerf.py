"""Vanilla NeRF in the port (`FrequencyEncoder`, `OriginNeRFNetworks`, the
vanilla-NeRF parameter tree) against the JAX package's on the CPU, and one
training step of the NGP Runner on projects/nerf/configs/nerf_base.py,
shrunk, over the blender-format fixture scene."""

import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (  # noqa: F401
    assert_one_step_matches, clear_cfgs, n, port_grid_state, t,
)

NERF_BASE = str(Path(__file__).resolve().parents[1]
                / "projects" / "nerf" / "configs" / "nerf_base.py")


@pytest.mark.parametrize("multires,include_input,input_dims,log_sampling", [
    (10, True, 3, True), (4, True, 3, True), (6, False, 4, True),
    (5, True, 3, False), (3, False, 2, False)])
def test_frequency_encoder_matches_jax(multires, include_input, input_dims,
                                       log_sampling):
    """Every variant, on coordinates in [-1.5, 1.5]: the frequencies equal
    JAX's bit for bit; the two libraries' f32 sin and cos of the same
    argument differ by at most an ulp or two of the argument (|x f| up to
    768): atol 1e-6 of the argument's size, 1e-4 absolute."""
    from jnerf_tpu.models.position_encoders.freq_encoder import (
        FrequencyEncoder as JaxEncoder,
    )
    from jnerf_tpu_torch.models.position_encoders import FrequencyEncoder

    args = (multires, include_input, input_dims, log_sampling)
    enc, ref = FrequencyEncoder(*args), JaxEncoder(*args)
    assert enc.out_dim == ref.out_dim
    np.testing.assert_array_equal(n(enc.freq_bands), n(ref.freq_bands))
    x = np.random.default_rng(0).uniform(-1.5, 1.5, (512, input_dims))
    x = x.astype(np.float32)
    out = enc(t(x))
    assert out.shape == (512, ref.out_dim) and out.dtype == torch.float32
    np.testing.assert_allclose(n(out), n(ref({}, jnp.asarray(x))), rtol=0,
                               atol=1e-4)


def _nerf_cfg(tmp_path, scene, fp16=True):
    """nerf_base.py over ``scene``, shrunk: 3 layers of 32 (skip after
    layer 1), 256 rays, a 32^3 grid, 16 samples a ray."""
    path = Path(tmp_path) / "nerf_cfg.py"
    path.write_text(textwrap.dedent(f"""\
        _base_ = {NERF_BASE!r}
        dataset_dir = {str(scene)!r}
        dataset = dict(train=dict(root_dir=dataset_dir, batch_size=256),
                       val=dict(root_dir=dataset_dir, batch_size=256),
                       test=dict(root_dir=dataset_dir, batch_size=256))
        log_dir = {str(Path(tmp_path) / "logs")!r}
        model = dict(type="OriginNeRFNetworks", D=3, W=32, skips=[1])
        n_rays_per_batch = 256
        target_batch_size = 1 << 12
        grid_size = 32
        nerf_steps = 128
        fp16 = {fp16!r}
        seed = 0
    """))
    return str(path)


@pytest.mark.parametrize("fp16", [False, True])
def test_origin_nerf_network_matches_jax(tmp_path, synthetic_scene,
                                         clear_cfgs, fp16):
    """Forward, density and parameter gradients of OriginNeRFNetworks (D=3,
    W=32, the skip after layer 1) on the JAX network's weights, converted
    both ways.  f32: only summation order differs, rtol 1e-4 / atol 1e-5
    (gradients: of the tensor's largest entry).  bf16 operands (nerf_base's
    fp16): a hidden activation can land one bf16 ulp (2^-8) apart, so the
    NGP network's 1e-2 / 1e-3 (tests/test_torch_ngp.py)."""
    from jnerf_tpu.models.networks.ori_nerf_network import (
        OriginNeRFNetworks as JaxNet,
    )
    from jnerf_tpu.utils.config import init_cfg as jax_init
    from jnerf_tpu_torch.models.networks import OriginNeRFNetworks
    from jnerf_tpu_torch.utils.config import init_cfg
    from jnerf_tpu_torch.utils.convert import (
        jax_params_to_state_dict, state_dict_to_jax_params,
    )

    path = _nerf_cfg(tmp_path, synthetic_scene, fp16)
    jax_init(path)
    init_cfg(path)
    jnet = JaxNet(D=3, W=32, skips=[1])
    params = jax.tree.map(np.asarray, jnet.init(jax.random.PRNGKey(0)))
    net = OriginNeRFNetworks(D=3, W=32, skips=[1])
    net.load_state_dict(jax_params_to_state_dict(params))
    back = state_dict_to_jax_params(net.state_dict())
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)

    rng = np.random.default_rng(1)
    pos = rng.uniform(size=(1024, 3)).astype(np.float32)
    dirs = rng.uniform(-1, 1, size=(1024, 3)).astype(np.float32)
    r = rng.normal(size=(1024, 4)).astype(np.float32)
    tol = 1e-2 if fp16 else 1e-4
    out = net(t(pos), t(dirs))
    assert out.dtype == torch.float32 and out.shape == (1024, 4)
    np.testing.assert_allclose(n(out), n(jnet(params, pos, dirs)), rtol=tol,
                               atol=tol / 10)
    np.testing.assert_allclose(n(net.density(t(pos))),
                               n(jnet.density(params, pos)), rtol=tol,
                               atol=tol / 10)
    jgrads = jax.grad(lambda p: jnp.sum(jnet(p, pos, dirs) * r))(
        jax.tree.map(jnp.asarray, params))
    (out * t(r)).sum().backward()
    jsd = jax_params_to_state_dict(jax.tree.map(np.asarray, jgrads))
    for name, p in net.named_parameters():
        ref = n(jsd[name])
        scale = float(np.abs(ref).max())
        np.testing.assert_allclose(n(p.grad), ref, rtol=tol,
                                   atol=tol * scale / 10, err_msg=name)


def test_one_vanilla_nerf_step_matches_jax(tmp_path, synthetic_scene,
                                           clear_cfgs):
    """Both runners built from one nerf_base.py file (bf16 operands, no
    compaction): the JAX step-0 sweep's grid, the same params and draws;
    the loss and gradients at tests/test_torch_step.py's tolerances."""
    from jnerf_tpu.runner import Runner as JaxRunner
    from jnerf_tpu.utils.config import init_cfg as jax_init
    from jnerf_tpu_torch.runner import Runner
    from jnerf_tpu_torch.utils.config import init_cfg
    from jnerf_tpu_torch.utils.convert import jax_params_to_state_dict

    path = _nerf_cfg(tmp_path, synthetic_scene)
    jax_init(path)
    init_cfg(path)
    jr = JaxRunner()
    jr._update_grid(0, jax.random.PRNGKey(1))
    tr = Runner(device="cpu")
    assert type(tr.model).__name__ == "OriginNeRFNetworks"
    assert tr.model.compute_dtype == torch.bfloat16
    assert tr.sampler.compacted_batch is None
    tr.model.load_state_dict(
        jax_params_to_state_dict(jax.tree.map(np.asarray, jr.params)))
    tr.sampler.load_state_dict(port_grid_state(jr.sampler.state))
    assert assert_one_step_matches(jr, tr, min_valid=256) == (256, 16)

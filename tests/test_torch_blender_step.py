"""The slice as a whole on a blender-format scene: the port's Runner and
the JAX package's, built from one config file (ngp_base.py over the
NerfDataset of tests/conftest.py's synthetic_scene), take one training
step on the same params, grid state and draws, with the linear hash and
with the reference's xor hash."""

import jax
import numpy as np
import pytest

from torch_parity import (  # noqa: F401
    assert_one_step_matches, clear_cfgs, port_grid_state, write_blender_cfg,
)


@pytest.mark.parametrize("indexing", ["linear_rows", "xor"])
def test_one_blender_step_matches_jax(tmp_path, synthetic_scene, clear_cfgs,
                                      indexing):
    """Loss and gradients at tests/test_torch_step.py's tolerances; the
    table gradient too, although in xor mode the JAX package sums it in
    bf16 and the port in f32: a training step's entries take few
    contributions, so the bf16 sums stay inside those bounds."""
    from jnerf_tpu.runner import Runner as JaxRunner
    from jnerf_tpu.utils.config import init_cfg as jax_init
    from jnerf_tpu_torch.runner import Runner
    from jnerf_tpu_torch.utils.config import init_cfg
    from jnerf_tpu_torch.utils.convert import jax_params_to_state_dict

    path = write_blender_cfg(tmp_path, synthetic_scene, indexing)
    jax_init(path)
    init_cfg(path)
    jr = JaxRunner()
    jr._update_grid(0, jax.random.PRNGKey(1))
    tr = Runner(device="cpu")
    assert type(tr.dataset["train"]).__name__ == "NerfDataset"
    assert tr.dataset["train"].n_images == jr.dataset["train"].n_images == 14
    assert tr.model.pos_encoder.indexing == jr.model.pos_encoder.indexing
    assert tr.model.pos_encoder.spec.n_entries == \
        jr.model.pos_encoder.spec.n_entries
    tr.model.load_state_dict(
        jax_params_to_state_dict(jax.tree.map(np.asarray, jr.params)))
    tr.sampler.load_state_dict(port_grid_state(jr.sampler.state))
    assert assert_one_step_matches(jr, tr) == (256, 32)

"""The PyTorch port's whole NGP training step against the JAX package's,
plus the port's own runner contract (imports, devices, a short run)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from torch_parity import (  # noqa: F401
    assert_one_step_matches, both_cfgs, port_grid_state,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("pallas_mlp", [False, True])
def test_one_step_loss_and_grads_match_jax(both_cfgs, pallas_mlp):
    """One f8l4 training step with compaction (256 rays, 32 samples/ray, a
    1024-sample cap; with the fused MLP on, 128 samples/ray and an
    8192-sample cap, so that both packages take the fused MLP on the M
    kept rows) on the same params, the same grid state (the JAX
    step-0 refresh, converted) and the same draws (pixels, march jitter,
    background from the JAX step's key).  Compared: the loss and the
    gradients, not the updated params (Adam moves every param with a
    nonzero gradient by ~lr, so rounding noise in tiny gradients would show
    as 0.2 steps).  The bf16 MLP chain rounds the same operands in both, but
    f32 sums in another order can move an activation or a cotangent by one
    bf16 ulp (2^-8); a weight gradient sums many such terms with
    cancellation, so single entries can move by ~1% of the tensor's largest
    gradient while the bulk agrees: loss rtol 1e-3; per gradient tensor,
    max |diff| <= 2e-2 and mean |diff| <= 1e-3 of its largest entry."""
    from jnerf_tpu.runner import Runner as JaxRunner
    from jnerf_tpu_torch.runner import Runner
    from jnerf_tpu_torch.utils.convert import jax_params_to_state_dict

    shape = (256, 32)
    if pallas_mlp:
        shape = (256, 128)
        for cfg in both_cfgs:
            cfg.update(use_pallas_mlp=True, compacted_batch=8192,
                       target_batch_size=1 << 14)
    jr = JaxRunner()
    jr._update_grid(0, jax.random.PRNGKey(1))
    tr = Runner(device="cpu")
    tr.model.load_state_dict(
        jax_params_to_state_dict(jax.tree.map(np.asarray, jr.params)))
    tr.sampler.load_state_dict(port_grid_state(jr.sampler.state))
    assert jr.model._fused_ok == tr.model._fused_ok == pallas_mlp
    assert shape[0] * shape[1] > tr.sampler.compacted_batch  # compaction on
    assert assert_one_step_matches(
        jr, tr, min_valid=tr.sampler.compacted_batch + 1) == shape


def test_train_range_runs_and_adapts(both_cfgs):
    """48 steps on the CPU: the step-0 full sweep, two half sweeps, two
    lagged batch adaptations; the losses stay finite and fall, and the
    optimizer counts every step."""
    from jnerf_tpu_torch.runner import Runner

    tr = Runner(device="cpu")
    losses = [float(tr.train_range(w * 16, (w + 1) * 16)) for w in range(3)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    assert tr.optimizer.count == 48 and tr.ema_state["steps"] == 48
    assert tr.sampler.state["ema_step"] == 3
    assert tr.sampler._demand_ema is not None  # adapted at step 32
    assert tr._pending_adapt is not None


def test_train_prints_plain_lines(both_cfgs, capsys, tmp_path):
    """Runner.train runs to tot_train_steps and reports in plain lines,
    with the JAX cadence: a validation render (PSNR on the line, image and
    target written) every val_freq steps, and at the end the checkpoint
    params.pkl written and the test set rendered, written and scored."""
    from jnerf_tpu_torch.runner import Runner

    both_cfgs[1].tot_train_steps = 20
    r = Runner(device="cpu")
    r.val_freq, r.render_chunk_rays = 16, 256
    r.train()
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 3, lines
    assert lines[0].startswith("STEP=16 | LOSS=") and "VAL PSNR=" in lines[0]
    assert lines[1].startswith("STEP=20 | LOSS=") and "VAL" not in lines[1]
    assert lines[2].startswith("TOTAL TEST PSNR====")
    assert np.isfinite(float(lines[2].split("=")[-1]))
    out = tmp_path / "logs" / "bench"
    assert {p.name for p in out.iterdir()} == {"img16.png", "target16.png",
                                               "params.pkl", "test"}
    assert len(list((out / "test").iterdir())) == 4


def test_runner_refuses_missing_cuda(both_cfgs):
    """Runner(device='cuda') raises where CUDA is absent; it never falls
    back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is present here")
    from jnerf_tpu_torch.runner import Runner

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Runner(device="cuda")


def test_port_imports_no_jax():
    """Importing the port, its quality tool, its bench, its measuring
    tools, the envelope kernels and the ported archive probes, training two steps (fused MLP option on), rendering a pose of
    the demo path and building a tiny hard-scene dataset pull in none of
    JAX, the JAX package, optax, yaml, PIL, cv2 or imageio (checked in a
    fresh interpreter, beyond what torch itself imports)."""
    code = """
import sys
import numpy, torch
before = set(sys.modules)
import jnerf_tpu_torch
from jnerf_tpu_torch.runner import Runner
from jnerf_tpu_torch.utils.bench_cfg import ngp_synthetic_cfg
cfg = ngp_synthetic_cfg(n_images=2, H=16, W=16, n_rays_per_batch=128,
                        target_batch_size=1 << 10, grid_size=16, nerf_steps=64,
                        hash_levels=2, hash_features=2, log2_hashmap_size=10)
from jnerf_tpu_torch.dataset import camera_path
import jnerf_tpu_torch.ops.fused_mlp
cfg.use_pallas_mlp = True
r = Runner(device="cpu")
r.train_range(0, 2)
r.render_chunk_rays = 128
assert r.render_img_with_pose(camera_path.path_spherical(2)[0]).shape == (16, 16, 3)
import jnerf_tpu_torch.tools.bf16_rays_probe, jnerf_tpu_torch.tools.ceiling_run
import jnerf_tpu_torch.bench
from jnerf_tpu_torch.tools import (
    ab_hash_quality, bench_psnr, probe_cap19, probe_compact, probe_demand,
    probe_tiers, time_step, tiny_ceiling_svox2, tool_util)
import jnerf_tpu_torch.ops.envelope
from jnerf_tpu_torch.tools.archive import (
    common, probe_bwd_var, probe_final, probe_loop, probe_rmw, probe_round2,
    probe_scatter, probe_scatter2, probe_tpu, probe_tpu2)
from jnerf_tpu_torch.dataset import SyntheticSpheresDataset
ds = SyntheticSpheresDataset(n_images=2, H=8, W=8, scene="hard", ssaa=2)
assert ds.image_data.shape == (2 * 8 * 8, 4)
new = {m.split(".")[0] for m in set(sys.modules) - before}
print(sorted(new & {"jax", "jaxlib", "jnerf_tpu", "optax", "yaml", "PIL",
                    "cv2", "imageio", "tqdm"}))
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"

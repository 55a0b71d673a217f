"""The port's data parallelism (`jnerf_tpu_torch/parallel`) on the CPU: two
gloo ranks spawned by `parallel/dryrun.py::run_ranks`, held to the port's
one-process step and refresh and to the JAX package's step on its 8-device
virtual mesh, as `tests/test_parallel.py` holds the JAX package's mesh to
one device.

The JAX runs use `tests/test_parallel.py`'s tiny config (f32 end to end,
Adam eps 1e-8) and its keys, with ``hash_indexing='linear_nbr'`` in both
packages (as every parity test sets it: the JAX package's default on the
CPU is its packed-rows encoder, TPU layout machinery the port leaves
behind); the port takes the JAX params (converted by `utils/convert.py`)
and the draws that the JAX keys make.  One spawn of two ranks runs every
case once for the module (the ``cases`` fixture); the ranks import nothing
from `tests/`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_parity import jax_key_draws, jax_sweep_jitter

from jnerf_tpu_torch.parallel import Mesh, dryrun, shard_rays

# tests/test_parallel.py:19-37: f32 end to end and Adam eps 1e-8, so that
# the comparison is tight; the neighbour-table encoder in both packages.
JAX_TINY = dict(n_images=2, H=32, W=32, n_rays_per_batch=256,
                target_batch_size=1 << 12, grid_size=32, nerf_steps=128,
                hash_levels=4, log2_hashmap_size=12, fp16=False)
TIGHT = {"optim.eps": 1e-8, "hash_indexing": "linear_nbr"}
KEY, GRID_KEY = 7, 11  # tests/test_parallel.py:70-71
CPU = torch.device("cpu")


def _keep_grads():
    """An optax transform that passes the gradients on unchanged and keeps
    them in its state, so that the JAX step's gradients can be read."""
    return optax.GradientTransformation(
        init=lambda p: {"g": jax.tree.map(jnp.zeros_like, p)},
        update=lambda g, s, p=None: (g, {"g": g}))


def _jax_mesh_step():
    """The JAX step on the 8-device mesh as tests/test_parallel.py:65-95
    runs it (the step-0 refresh, then one step with Adam and EMA), with
    the gradients kept on their way into Adam; returns (params before the
    step, loss, gradients, params after the step, grid state, active
    cascades), as numpy."""
    from jnerf_tpu.parallel import make_mesh, replicate_tree
    from jnerf_tpu.runner import Runner
    from jnerf_tpu.utils.bench_cfg import ngp_synthetic_cfg
    from jnerf_tpu.utils.config import get_cfg

    cfg = ngp_synthetic_cfg(**JAX_TINY)
    cfg.optim.eps = TIGHT["optim.eps"]
    cfg.hash_indexing = TIGHT["hash_indexing"]
    try:
        runner = Runner()
        params = jax.device_get(runner.params)
        runner.tx = optax.chain(_keep_grads(), runner.tx)
        mesh = make_mesh(8)
        runner.mesh = mesh
        runner.params = replicate_tree(runner.params, mesh)
        runner.opt_state = replicate_tree(runner.tx.init(runner.params), mesh)
        runner.ema_state = replicate_tree(runner.ema_state, mesh)
        runner.sampler.state = replicate_tree(runner.sampler.state, mesh)
        runner._update_grid(0, jax.random.PRNGKey(GRID_KEY))
        loss = float(runner._train_step(jax.random.PRNGKey(KEY)))
        n_casc = runner.sampler.grid_config.max_cascade + 1
        return (params, loss, jax.device_get(runner.opt_state[0]["g"]),
                jax.device_get(runner.params),
                jax.device_get(runner.sampler.state), n_casc)
    finally:
        get_cfg().clear()


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    """The JAX mesh step, then each case on two ranks and in one process:
    {"jax": ..., "ranks": [per rank {case: result}], "one": {case:
    result}}."""
    from jnerf_tpu_torch.utils.config import get_cfg
    from jnerf_tpu_torch.utils.convert import (
        jax_params_to_state_dict, state_dict_to_jax_params,
    )

    params, loss, grads, stepped, grid, n_casc = _jax_mesh_step()
    n_pixels = JAX_TINY["n_images"] * JAX_TINY["H"] * JAX_TINY["W"]
    idx, u, bg = jax_key_draws(jax.random.PRNGKey(KEY),
                               JAX_TINY["n_rays_per_batch"], n_pixels)
    n_cells = JAX_TINY["grid_size"] ** 3
    jitter = jax_sweep_jitter(jax.random.PRNGKey(GRID_KEY), n_casc, n_cells)
    # Round trips through the port's names: the JAX trees as the port
    # writes them, leaf for leaf.
    params = state_dict_to_jax_params(jax_params_to_state_dict(
        jax.tree.map(np.asarray, params)))
    specs = {
        "jax_draws": {"cfg": JAX_TINY, "set": TIGHT, "refresh_step": 0,
                      "jitter": jitter, "draws": (idx, bg, u),
                      "params": params},
        "compacted": {"cfg": JAX_TINY, "set": {**dryrun.COMPACTED, **TIGHT},
                      "refresh_step": 0},
        "probe": {"cfg": JAX_TINY, "set": {**dryrun.COMPACTED, **TIGHT,
                                           "grid_update_mode": "probe"},
                  "refresh_step": 300},
    }
    # train() across a validation render (val_freq 4 of 8 steps, refreshes
    # every 4): every rank's generator must stay in step with rank 0's.
    train_spec = {"cfg": dict(JAX_TINY, tot_train_steps=8),
                  "set": {**dryrun.COMPACTED, **TIGHT,
                          "sampler.update_den_freq": 4,
                          "log_dir": str(tmp_path_factory.mktemp("logs"))},
                  "val_freq": 4}
    rank_cases = [(dryrun.check_collectives, None)]
    rank_cases += [(dryrun.step_case, s) for s in specs.values()]
    rank_cases += [(dryrun.windows_case, dryrun.windows_spec()),
                   (dryrun.train_case, train_spec)]
    names = ["collectives", *specs, "windows", "train"]
    try:
        ranks = dryrun.run_ranks(2, rank_cases, device="cpu", timeout_s=120)
        one = {k: dryrun.step_case(None, CPU, s) for k, s in specs.items()}
        one["train"] = dryrun.train_case(None, CPU, train_spec)
    finally:
        get_cfg().clear()
    jax_step = {"loss": loss, "grid": grid,
                "grads": jax_params_to_state_dict(grads),
                "params": jax_params_to_state_dict(stepped)}
    return {"jax": jax_step, "ranks": [dict(zip(names, r)) for r in ranks],
            "one": one}


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("r", [12, 7])
def test_shard_rays_layout(n, r):
    """shard_rays gives each rank a contiguous slice, balanced to one row
    also where R % n != 0; the slices cover the batch in rank order.
    Meshes built without processes."""
    x = torch.arange(r * 3).reshape(r, 3)
    parts = [shard_rays(x, Mesh(None, k, n, CPU)) for k in range(n)]
    assert torch.equal(torch.cat(parts), x)
    sizes = [p.shape[0] for p in parts]
    assert max(sizes) - min(sizes) <= 1 and sum(sizes) == r
    assert shard_rays(x, None) is x


def test_sync_without_mesh():
    """sync without a mesh: Python numbers pass through and arrays come
    back as tensors of the same values, as the JAX function returns them
    without an axis name; an unknown reduce mode raises."""
    from jnerf_tpu.utils import general as jg
    from jnerf_tpu_torch.utils import general as tg

    assert tg.sync(3) == jg.sync(3) == 3
    assert tg.sync(2.5, "sum") == 2.5
    v = np.array([1.0, -2.0], np.float32)
    np.testing.assert_array_equal(tg.sync(v).numpy(), np.asarray(jg.sync(v)))
    with pytest.raises(ValueError, match="reduce_mode"):
        tg.sync(torch.ones(2), "max")


def test_collectives_on_two_ranks(cases):
    """On both ranks: the gather of 7 rows (4 + 3) equals the whole, with
    and without the row count, for floats and bools; the broadcast from
    rank 0 reaches rank 1, bools too; sync sums and means 1 and 2, and
    passes a number through."""
    for r, res in enumerate(cases["ranks"]):
        c = res["collectives"]
        x = torch.arange(14, dtype=torch.float32).reshape(7, 2)
        assert torch.equal(c["gathered"], x)
        assert torch.equal(c["gathered_count_found"], x)
        assert torch.equal(c["gathered_mask"], x[:, 0] > 5)
        assert torch.equal(c["broadcast"], torch.zeros(3))
        assert c["broadcast_flags"].tolist() == [True, False]
        assert (c["sum"], c["mean"], c["number"]) == (3.0, 1.5, 3), r


def test_gather_backward_is_this_ranks_slice(cases):
    """The gather's backward hands each rank its own rows' gradient as
    the one-process gradient would have it, not the sum over the ranks
    (2x): d/dx of sum(gather(x) * w) is w's rows [0, 3) on rank 0 and
    [3, 7) on rank 1."""
    w = torch.linspace(-1.0, 1.0, 14).reshape(7, 2)
    got = [res["collectives"]["grad"] for res in cases["ranks"]]
    assert torch.equal(got[0], w[:3]) and torch.equal(got[1], w[3:])


def _assert_step_matches(got, ref):
    """A rank's step against the one-process step: the loss at rtol 1e-5 /
    atol 1e-6 and the updated params at rtol 1e-4 / atol 1e-5
    (tests/test_parallel.py:86-94), each gradient within 1e-5 of its
    largest entry, the refreshed grid at rtol 1e-5 / atol 1e-6 with the
    bitfield equal (:110-114)."""
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5, atol=1e-6)
    assert np.isfinite(ref["loss"])
    for name, g in ref["grads"].items():
        scale = float(g.abs().max())
        assert scale > 0, name
        assert float((got["grads"][name] - g).abs().max()) <= 1e-5 * scale, name
        np.testing.assert_allclose(got["params"][name].numpy(),
                                   ref["params"][name].numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=name)
    _assert_grid_matches(got["grid"], ref["grid"])


def _assert_grid_matches(got, ref):
    np.testing.assert_allclose(np.asarray(got["density_grid"]),
                               np.asarray(ref["density_grid"]), rtol=1e-5,
                               atol=1e-6)
    assert np.array_equal(np.asarray(got["bitfield"]),
                          np.asarray(ref["bitfield"]))
    np.testing.assert_allclose(np.asarray(got["mean"]), np.asarray(ref["mean"]),
                               rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("case", ["jax_draws", "compacted", "probe"])
def test_two_rank_step_matches_one_process(cases, case):
    """The 2-rank refresh and step equal the one-process ones from the
    same seed, on both ranks: uncompacted on the JAX params and draws,
    compacted (M = 4096 kept samples) on the port's own init and draws,
    and after a probe-mode refresh at step 300 (8192 + 8192 cells probed,
    their draws made at the global shape on every rank)."""
    for res in cases["ranks"]:
        _assert_step_matches(res[case], cases["one"][case])


def test_two_rank_step_matches_jax_mesh_step(cases):
    """The 2-rank step against the JAX step on its 8-device mesh, from the
    same params, keys and draws.  At tests/test_parallel.py's tolerances:
    the loss (rtol 1e-5 / atol 1e-6) and the refreshed grid (rtol 1e-5 /
    atol 1e-6, the bitfield equal).  The grid's mean is held at rtol 1e-5
    / atol 1e-7 to the float64 mean of the JAX grid's ReLU'd cascade 0,
    which it estimates: the JAX package's own float32 mean lies 3.4e-5
    (relative) from it in this config, an error of its summation.

    The gradients are held twice: to the port's gradient-parity tolerance
    against a JAX step (torch_parity.assert_one_step_matches: max |diff|
    within 2e-2 and mean |diff| within 1e-3 of the largest entry), and to
    be no farther from the JAX ones than the one-process port's, plus
    1e-5 of the largest entry.  They cannot be held to 1e-5 of the
    largest entry, nor the params after Adam to rtol 1e-4 / atol 1e-5:
    the port's march places samples up to one float32 ulp from the jitted
    JAX march, and two steps of the JAX step are discontinuous in them.
    The neighbour-table encoder rounds each corner product to bf16, and a
    density-MLP hidden unit near zero flips its ReLU.  So the JAX step's
    own table and first-layer density gradients move by 1.24e-2 of their
    largest entry between its jitted and its eager run, and the port's
    lie 7.2e-3 and 8.2e-3 from the jitted ones (the rest within 6.5e-5);
    Adam at eps 1e-8 turns the near-eps table gradients into parameter
    differences of up to 0.18 (these numbers: tests/torch_jax_step_gap.py).
    The params are held to the one-process port's in
    test_two_rank_step_matches_one_process."""
    jx = cases["jax"]
    one = cases["one"]["jax_draws"]
    exact_mean = np.maximum(np.asarray(jx["grid"]["density_grid"],
                                       np.float64)[0], 0).mean()
    for res in cases["ranks"]:
        got = res["jax_draws"]
        np.testing.assert_allclose(got["loss"], jx["loss"], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(got["grid"]["density_grid"].numpy(),
                                   np.asarray(jx["grid"]["density_grid"]),
                                   rtol=1e-5, atol=1e-6)
        assert np.array_equal(got["grid"]["bitfield"].numpy(),
                              np.asarray(jx["grid"]["bitfield"]))
        np.testing.assert_allclose(float(got["grid"]["mean"]), exact_mean,
                                   rtol=1e-5, atol=1e-7)
        for name, j in jx["grads"].items():
            scale = float(j.abs().max())
            assert scale > 0, name
            diff = (got["grads"][name] - j).abs()
            assert float(diff.max()) <= 2e-2 * scale, name
            assert float(diff.mean()) <= 1e-3 * scale, name
            gap = float((one["grads"][name] - j).abs().max())
            assert float(diff.max()) <= gap + 1e-5 * scale, name


def test_model_rows_split_per_rank(cases):
    """Each rank runs the model on half of the rows: 2048 of the
    compacted step's M = 4096 lanes and of the uncompacted step's 256 x 16
    slots, and the refreshes' density queries, 16384 of the step-0
    sweep's 32768 and 8192 of the probe refresh's 16384, on each rank;
    one process runs all of them."""
    for case in ("jax_draws", "compacted"):
        assert cases["one"][case]["model_rows"] == [4096], case
        assert cases["one"][case]["density_rows"] == [32768], case
        for res in cases["ranks"]:
            assert res[case]["model_rows"] == [2048], case
            assert res[case]["density_rows"] == [16384], case
    assert cases["one"]["probe"]["density_rows"] == [16384]
    assert [r["probe"]["density_rows"] for r in cases["ranks"]] == [[8192]] * 2


def test_two_window_train_range_agrees(cases):
    """The dry run's two-window train_range (update_den_freq 4, across the
    lagged adaptation) on two ranks: both ranks run the same windows at
    the same shapes and the same loss, and arm the adaptation."""
    wins = [res["windows"] for res in cases["ranks"]]
    assert wins[0]["shapes"] == wins[1]["shapes"] == [(4, 256, 32)] * 2
    assert wins[0]["loss"] == wins[1]["loss"] and np.isfinite(wins[0]["loss"])
    assert all(w["adapt_armed"] for w in wins)


def test_two_rank_train_matches_one_process(cases):
    """train() on two ranks equals train() in one process from the same
    seed, across a validation render that draws its jitter from the
    runner's generator (8 steps, a render at step 4): the params after
    the last step at rtol 1e-4 / atol 1e-5 and the grid of the step-4
    refresh at rtol 1e-5 / atol 1e-6 with the bitfield equal, on both
    ranks; rank 0 alone returns the test PSNR, the one process's."""
    one = cases["one"]["train"]
    for res in cases["ranks"]:
        got = res["train"]
        for name, p in one["params"].items():
            np.testing.assert_allclose(got["params"][name].numpy(),
                                       p.numpy(), rtol=1e-4, atol=1e-5,
                                       err_msg=name)
        _assert_grid_matches(got["grid"], one["grid"])
    assert np.isfinite(one["psnr"])
    np.testing.assert_allclose(cases["ranks"][0]["train"]["psnr"], one["psnr"],
                               rtol=1e-5)
    assert cases["ranks"][1]["train"]["psnr"] is None


def test_train_range_raises_on_diverged_shapes(fresh_cfg):
    """Ranks that start a window at different batch shapes raise at the
    window's shape check, naming both shapes, where the next collective
    would otherwise wait forever."""
    spec = dict(dryrun.windows_spec(), n_rays={1: 512})
    with pytest.raises(Exception, match="disagree on the batch shape") as e:
        dryrun.run_ranks(2, [(dryrun.windows_case, spec)], device="cpu",
                         timeout_s=60)
    assert "'n_rays': 256" in str(e.value) and "'n_rays': 512" in str(e.value)


def test_backend_choice_never_falls_back():
    """gloo on the CPU; on 'cuda' without a card the dry run raises rather
    than moving its ranks to the CPU; other devices are refused."""
    assert dryrun.choose_backend(2, "cpu") == "gloo"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            dryrun.choose_backend(2, "cuda")
    with pytest.raises(ValueError):
        dryrun.choose_backend(2, "tpu")


def test_runner_mesh_sets_the_samplers(fresh_cfg):
    """Runner.mesh also sets the sampler's mesh, as the JAX runner's
    setter does."""
    from jnerf_tpu_torch.runner import Runner
    from jnerf_tpu_torch.utils.bench_cfg import ngp_synthetic_cfg
    from jnerf_tpu_torch.utils.config import get_cfg

    ngp_synthetic_cfg(**JAX_TINY)
    try:
        runner = Runner(device="cpu")
        mesh = Mesh(None, 0, 2, CPU)
        runner.mesh = mesh
        assert runner.sampler.mesh is mesh
        runner.mesh = None
        assert runner.sampler.mesh is None
    finally:
        get_cfg().clear()


def test_make_mesh_refuses_a_missing_card(tmp_path):
    """Over a one-rank gloo group in this process, make_mesh takes the CPU
    only when given device="cpu": with no device and no card it raises
    rather than putting the rank on the CPU."""
    import torch.distributed as dist

    from jnerf_tpu_torch.parallel import make_mesh

    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        mesh = make_mesh(1, device="cpu")
        assert (mesh.rank, mesh.size, mesh.device) == (0, 1, CPU)
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                make_mesh(1)
    finally:
        dist.destroy_process_group()

"""The NeuS, Mip-NeRF and Plenoxels runners' windows on the CPU
(`runner/windows.py`): each runner's window lengths against its JAX
runner's rule, each per-step table against the host formulas it replaced
(and the JAX package's schedules), and a table-driven eager window against
the per-step loop it replaced, bit for bit, at tiny widths.  The CUDA graph
windows themselves run on the card
(``tests/test_torch_cuda.py::test_family_graph_windows_equal_eager``).

Tolerances: the learning-rate columns hold the port's own schedules
exactly and the JAX package's within 3 f32 ulps (numpy's f32 sin and exp
against XLA's, as `test_torch_svox2.py` and `test_torch_mipnerf.py`
state); the windows and the loops are the same arithmetic, bit for bit.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (  # noqa: F401 (fixtures)
    clear_cfgs, write_mip_cfg, write_neus_cfg, write_svox2_cfg,
)

from jnerf_tpu_torch.runner.windows import WINDOW, graph_windows, window_length

ULP3 = 3 * 2.0 ** -23


# ------------------------------------------------------------------ scenes
@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    from jnerf_tpu_torch.dataset.synthetic import (
        make_synthetic_neus_scene, make_synthetic_scene,
    )

    root = tmp_path_factory.mktemp("family_scenes")
    blender = str(root / "blender")
    make_synthetic_scene(blender, n_train=4, n_val=2, n_test=2, H=24, W=24)
    neus = make_synthetic_neus_scene(str(root / "neus"), n_images=5, H=16,
                                     W=20)
    return SimpleNamespace(blender=blender, neus=neus)


def _neus(tmp_path, scenes, **extra):
    from jnerf_tpu_torch.runner import NeuSRunner
    from jnerf_tpu_torch.utils.config import init_cfg

    init_cfg(write_neus_cfg(tmp_path, scenes.neus, **extra))
    return NeuSRunner(device="cpu")


def _mip(tmp_path, scenes, **extra):
    from jnerf_tpu_torch.runner import MipRunner
    from jnerf_tpu_torch.utils.config import init_cfg

    init_cfg(write_mip_cfg(tmp_path, scenes.blender, **extra))
    return MipRunner(device="cpu")


def _svox2(tmp_path, scenes, **extra):
    from jnerf_tpu_torch.runner import Svox2Runner
    from jnerf_tpu_torch.utils.config import init_cfg

    init_cfg(write_svox2_cfg(tmp_path, scenes.blender, **extra))
    return Svox2Runner(device="cpu")


# ----------------------------------------------------------- window lengths
def jax_neus_windows(start, end, freqs):
    """jnerf_tpu/runner/neus_runner.py:173-182, over [start, end)."""
    out, it = [], start
    while it < end:
        n = 16
        for freq in freqs:
            n = min(n, freq - (it % freq) or freq)
        n = max(1, min(n, end - it))
        out.append(n)
        it += n
    return out


def jax_mip_windows(start, tot, val_freq):
    """jnerf_tpu/runner/mip_runner.py:145-147."""
    out, i = [], start
    while i < tot:
        n = min(16, val_freq - (i % val_freq) or val_freq, tot - i)
        out.append(n)
        i += n
    return out


def jax_svox2_windows(gstep, n_iters, upsamp_every):
    """jnerf_tpu/runner/svox2_runner.py:157-159."""
    out, g, end = [], gstep, gstep + n_iters
    while g < end:
        n = min(16, end - g, upsamp_every - (g % upsamp_every) or upsamp_every)
        out.append(n)
        g += n
    return out


@pytest.mark.parametrize("step,end,freqs", [
    (0, 100, (7,)), (5, 40, (3, 16)), (33, 34, ()), (0, 1000, (100, 250)),
    (17, 200, (13, 29, 31, 16)), (0, 16, (16,))])
def test_window_length_is_the_jax_rule(step, end, freqs):
    got, i = [], step
    while i < end:
        n = window_length(i, end, freqs)
        got.append(n)
        i += n
    assert got == jax_neus_windows(step, end, freqs)
    assert WINDOW == 16


def _record_windows(runner, returns):
    """Replace the runner's train_window with a recorder of its n that
    returns ``returns(n)`` and runs nothing."""
    seen = []

    def train_window(n, graph=None):
        seen.append(n)
        runner.window_losses = returns(n)
        return runner.window_losses

    runner.train_window = train_window
    return seen


def test_neus_train_cuts_windows_as_the_jax_loop(tmp_path, scenes):
    """NeuSRunner.train's windows over 60 steps with every host event on
    its own period, and a new image order after each pass."""
    r = _neus(tmp_path, scenes, end_iter=60)
    r.report_freq, r.save_freq, r.val_freq, r.val_mesh_freq = 7, 11, 13, 17
    events = []
    r.save_checkpoint = lambda: events.append(("save", r.iter_step))
    r.validate_image = lambda: events.append(("val", r.iter_step))
    r.validate_mesh = lambda: events.append(("mesh", r.iter_step))
    seen = _record_windows(r, lambda n: torch.zeros((n, 4)))
    perms = []

    class Rng:  # the runner's generator, noting when it draws an order
        def permutation(self, k, _rng=r._rng):
            perms.append(r.iter_step)
            return _rng.permutation(k)

    r._rng = Rng()
    r.train()
    assert seen == jax_neus_windows(0, 60, (7, 11, 13, 17, 5))
    assert r.iter_step == 60
    assert events == [(k, s) for s in range(1, 61)
                      for k, f in (("save", 11), ("val", 13), ("mesh", 17))
                      if s % f == 0]
    assert perms == [5, 10, 15, 20, 25, 30, 35, 40, 45, 50, 55, 60]


def test_mip_train_cuts_windows_as_the_jax_loop(tmp_path, scenes):
    r = _mip(tmp_path, scenes, tot_train_steps=70)
    r._VAL_FREQ = 24
    vals = []
    r.val_img = lambda it: (vals.append(it), torch.tensor(0.01))[1]
    seen = _record_windows(r, lambda n: torch.zeros((n,)))
    r.train()
    assert seen == jax_mip_windows(0, 70, 24)
    assert vals == [24, 48] and r.start == 70


def test_svox2_train_cuts_windows_as_the_jax_loop(tmp_path, scenes):
    r = _svox2(tmp_path, scenes, upsamp_every=20)
    ups = []
    r.upsample = lambda reso: ups.append((r.gstep, tuple(reso)))
    seen = _record_windows(r, lambda n: torch.zeros((n,)))
    r.train(45)
    assert seen == jax_svox2_windows(0, 45, 20)
    assert ups == [(20, (48, 48, 48))] and r.gstep == 45


def test_graph_windows_only_on_a_card_without_a_mesh():
    assert graph_windows("cuda") and not graph_windows("cpu")
    assert not graph_windows("cuda", object())


# ------------------------------------------------------------------ tables
def test_neus_rows_are_the_host_formulas(tmp_path, scenes):
    """NeuS's table: Adam's learning rate is the JAX runner's current_lr at
    each step (as the JAX loop computes it, with iter_step set to the
    step), then the bias corrections at Adam's count; the cos anneal ratio
    and the image index of the current order."""
    from jnerf_tpu.runner.neus_runner import NeuSRunner as JaxNeuS

    r = _neus(tmp_path, scenes, end_iter=40)
    r.iter_step = 3
    r.optimizer.count = 3
    rows = r.step_rows(9)
    k = r.optimizer.row_width
    for j, row in enumerate(rows):
        step = 3 + j
        host = SimpleNamespace(
            iter_step=step, warm_up_end=r.warm_up_end, end_iter=r.end_iter,
            learning_rate=r.learning_rate, anneal_end=r.anneal_end,
            learning_rate_alpha=r.learning_rate_alpha)
        assert row[0] == np.float32(JaxNeuS.current_lr(host))
        assert row[0] == np.float32(r.current_lr(step))
        assert row[k] == np.float32(JaxNeuS.get_cos_anneal_ratio(host))
        assert row[k + 1] == r._image_perm[step % len(r._image_perm)]
        b1, b2 = r.optimizer.param_groups[0]["betas"]
        assert row[1] == np.float32(1) - np.float32(b1) ** np.float32(step + 1)
        assert row[2] == np.float32(1) - np.float32(b2) ** np.float32(step + 1)
    assert rows.dtype == np.float32 and rows.shape == (9, k + 2)


def test_mip_rows_are_the_schedule(tmp_path, scenes):
    """Mip-NeRF's table: the LinearLog rate at Adam's count (the port's
    exactly, the JAX package's within 3 ulps)."""
    from jnerf_tpu.optims.linearlog import LinearLog as JaxLinearLog

    r = _mip(tmp_path, scenes)
    r.optimizer.count = 5
    rows = r.optimizer.scalar_rows(12)
    sw = r.schedule_wrap
    ref = JaxLinearLog(SimpleNamespace(lr=sw.init_lr), sw.end_lr, sw.max_steps,
                       sw.lr_delay_steps, sw.lr_delay_mult)
    for j, row in enumerate(rows):
        assert row[0] == np.float32(sw.schedule(5 + j))
        np.testing.assert_allclose(row[0], np.float32(ref.schedule(
            jnp.float32(5 + j))), rtol=ULP3)


def test_svox2_rows_are_the_rates(tmp_path, scenes):
    """Plenoxels' table: (lr_sigma, lr_sh) of each step, the port's
    expon_lr exactly and the JAX package's within 3 ulps."""
    from jnerf_tpu.optims.svox2_optim import expon_lr as jax_lr

    r = _svox2(tmp_path, scenes)
    r.gstep = 14990
    rows = r.step_rows(16)
    for j, row in enumerate(rows):
        s = 14990 + j
        assert row[0] == np.float32(r.lr_sigma_fn(s))
        assert row[1] == np.float32(r.lr_sh_fn(s))
        np.testing.assert_allclose(row[0], np.float32(jax_lr(
            s, 30.0, 0.05, 15000, 1e-2, 250000)), rtol=ULP3)
        np.testing.assert_allclose(row[1], np.float32(jax_lr(
            s, 1e-2, 5e-6, 0, 1e-2, 250000)), rtol=ULP3)


# ---------------------------------------------- window against the loop
def _same(a, b):
    return a.shape == b.shape and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


def _assert_same_state(a, b, tables):
    for (k, x), y in zip(tables(a).items(), tables(b).values()):
        assert _same(x.detach(), y.detach()), k
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


def test_neus_window_equals_the_per_step_loop(tmp_path, scenes):
    """A table-driven eager window (train_window) against the per-step
    loop it replaced (a Python-float anneal, an int image index, Adam's
    row made at each step), from one seed: every loss, parameter, moment
    and the generator equal bit for bit, the image index wrapping twice."""
    runs = []
    for windowed in (True, False):
        r = _neus(tmp_path, scenes, end_iter=12)
        losses = []
        if windowed:
            for n in (5, 5, 2):
                losses += list(r.train_window(n, graph=False))
                r.iter_step += n
        else:
            for _ in range(12):
                data = r.dataset.gen_random_rays_at(
                    int(r._image_perm[r.iter_step % len(r._image_perm)]),
                    r.batch_size, generator=r.generator)
                total, aux = r.forward_loss(data)
                r.optimizer.zero_grad(set_to_none=True)
                total.backward()
                r.optimizer.step()
                losses.append(torch.stack([total.detach(),
                                           *(a.detach() for a in aux)]))
                r.iter_step += 1
        runs.append((r, torch.stack(losses)))
    (a, la), (b, lb) = runs
    assert _same(la, lb)

    def tables(r):
        out = dict(r.neus_network.named_parameters())
        for i, p in enumerate(r.params):
            out.update({f"{k} {i}": v for k, v in r.optimizer.state[p].items()})
        return out

    _assert_same_state(a, b, tables)
    assert a.optimizer.count == b.optimizer.count == 12


def test_mip_window_equals_the_per_step_loop(tmp_path, scenes):
    """Mip-NeRF: a window over its staged [n, batch, C] input against the
    loop of next(dataset) + train_step (Adam's row made at each step)."""
    runs = []
    for windowed in (True, False):
        r = _mip(tmp_path, scenes)
        if windowed:
            losses = torch.cat([r.train_window(n, graph=False)
                                for n in (4, 3)])
        else:
            losses = torch.stack([r.train_step(*next(r.dataset["train"]))[0]
                                  for _ in range(7)])
        runs.append((r, losses))
    (a, la), (b, lb) = runs
    assert _same(la, lb)

    def tables(r):
        out = dict(r.model.named_parameters())
        for i, p in enumerate(r.params):
            out.update({f"{k} {i}": v for k, v in r.optimizer.state[p].items()})
        return out

    _assert_same_state(a, b, tables)
    assert a.optimizer.count == b.optimizer.count == 7


def test_svox2_window_equals_the_per_step_loop(tmp_path, scenes):
    """Plenoxels, dense then sparse after an upsample past a lowered cell
    threshold: windows over the staged batches and the table's rates
    against next_batch + train_step at the host's Python-float rates; the
    sparse TV draws come from the generator in both."""
    runs = []
    for windowed in (True, False):
        r = _svox2(tmp_path, scenes, sparse_cell_threshold=30000,
                   density_thresh=0.05, sparse_dilate=1, lambda_tv=1e-3,
                   lambda_tv_sh=1e-3)
        losses = []
        for phase in ("dense", "sparse"):
            if phase == "sparse":
                r.upsample((48, 48, 48))
            if windowed:
                for n in (3, 2):
                    losses += list(r.train_window(n, graph=False))
                    r.gstep += n
            else:
                for _ in range(5):
                    losses.append(r.train_step(
                        *r.dataset["train"].next_batch(r.batch_size),
                        r.lr_sigma_fn(r.gstep), r.lr_sh_fn(r.gstep)))
                    r.gstep += 1
        runs.append((r, torch.stack(losses)))
    (a, la), (b, lb) = runs
    assert a.grid.sparse and _same(la, lb)

    def tables(r):
        out = dict(r.grid.tables())
        out.update(dict(r.grid.named_buffers()))
        out["sh_rms"] = r.opt_state["sh_rms"]
        return out

    _assert_same_state(a, b, tables)

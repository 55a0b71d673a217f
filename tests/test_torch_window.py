"""The runner's refresh windows on the CPU: the per-window table of Adam's
and the EMA's scalars against the host formulas it replaced, the
table-driven updates against the per-step ones, the in-place demand
counter through ``train_range``, the eager loop on CPU and mesh runners,
the capture-safe transmittance and ``tools/window_time.py``.  The CUDA
graph windows themselves run on the card
(``tests/test_torch_cuda.py::test_graph_windows_equal_eager_windows``)."""

import copy
import json

import numpy as np
import pytest
import torch

from torch_parity import (  # noqa: F401 (fixtures)
    TINY_EXTRA, TINY_NGP, tiny_cfg, two_threads,
)


def _f32(x):
    return float(np.float32(x))


def host_adam_scalars(opt, count):
    """(lr, c1, c2) as AdamOptimizer.step computed them on the host, as
    Python floats, before the table."""
    b1, b2 = opt.param_groups[0]["betas"]
    lr = opt.lr_schedule(count)
    c1 = _f32(1.0 - _f32(np.float32(b1) ** np.float32(count + 1)))
    c2 = _f32(1.0 - _f32(np.float32(b2) ** np.float32(count + 1)))
    return lr, c1, c2


def host_ema_scalars(decay, steps):
    """(keep, mix, debias) of EMA.step's step ``steps`` (1-based) as it
    computed them on the host."""
    d = np.float32(decay)
    debias_old = np.float32(1.0) - d ** np.float32(steps - 1)
    debias_new = np.float32(1.0) / (np.float32(1.0) - d ** np.float32(steps))
    return _f32(np.float32(1.0) - d), _f32(d * debias_old), _f32(debias_new)


def host_step(params, grads, moments, shadow, count, lr_fn, decay):
    """One Adam + EMA step with the host's Python-float scalars: the
    per-step path the table replaced."""
    b1, b2, eps = 0.9, 0.99, 1e-15
    lr = lr_fn(count)
    c1 = _f32(1.0 - _f32(np.float32(b1) ** np.float32(count + 1)))
    c2 = _f32(1.0 - _f32(np.float32(b2) ** np.float32(count + 1)))
    for p, g, (mu, nu) in zip(params, grads, moments):
        mu.mul_(b1).add_(g * (1.0 - b1))
        nu.mul_(b2).add_(g * g * (1.0 - b2))
        upd = (mu / c1) / (torch.sqrt(nu / c2) + eps)
        p.sub_(upd * _f32(lr))
    keep, mix, debias = host_ema_scalars(decay, count + 1)
    for p, v in zip(params, shadow):
        p.mul_(keep).add_(v * mix)
        p.mul_(debias)
        v.copy_(p)


def _optimizer(params):
    from jnerf_tpu_torch.optims import EMA, Adam, ExpDecay

    # Decays at steps 12, 22, 32: 40 steps cross three boundaries.
    sched = ExpDecay(Adam(lr=1e-2, eps=1e-15, betas=(0.9, 0.99)),
                     decay_start=12, decay_interval=10, decay_base=0.33)
    return sched.make(params), EMA(0.95)


def _bits(a):
    return np.asarray(a, dtype=np.float32).view(np.uint32)


@pytest.mark.parametrize("start", [0, 7, 30])
def test_scalar_rows_are_the_host_formulas(start):
    """The table's rows equal, bit for bit, the scalars the host computed
    step by step, across ExpDecay's boundaries and the EMA's first steps
    (where the debias factors move most); the reciprocals are f32's."""
    opt, ema = _optimizer([torch.nn.Parameter(torch.zeros(3))])
    opt.count = start
    rows = opt.scalar_rows(40)
    want = np.array([host_adam_scalars(opt, start + j) for j in range(40)],
                    dtype=np.float32)
    assert np.array_equal(_bits(rows[:, :3]), _bits(want))
    assert np.array_equal(_bits(rows[:, 3:5]),
                          _bits(np.float32(1.0) / want[:, 1:3]))
    assert len(set(rows[:, 0].tolist())) > 2  # two decays or more
    ema_rows = ema.scalar_rows(start, 40)
    ema_want = np.array([host_ema_scalars(0.95, start + j + 1)
                         for j in range(40)], dtype=np.float32)
    assert np.array_equal(_bits(ema_rows), _bits(ema_want))


def test_table_driven_updates_equal_the_per_step_path():
    """40 steps of Adam (with ExpDecay) and the EMA: driven by one 40-row
    table, by a row made at each step, and by the host's Python floats,
    the parameters, moments and shadow end in equal bits."""
    rng = np.random.default_rng(0)
    shapes = [(64, 8), (32, 16), (5,)]
    init = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[torch.from_numpy(rng.normal(size=s).astype(np.float32) * 0.1)
              for s in shapes] for _ in range(40)]
    runs = []
    for mode in ("table", "rows", "host"):
        params = [torch.nn.Parameter(torch.from_numpy(x.copy()))
                  for x in init]
        opt, ema = _optimizer(params)
        st = ema.init(params)
        if mode == "host":
            moments = [(torch.zeros_like(p), torch.zeros_like(p))
                       for p in params]
            with torch.no_grad():
                for j in range(40):
                    host_step(params, grads[j], moments, st["shadow"], j,
                              opt.lr_schedule, 0.95)
            runs.append(([p.detach() for p in params],
                         [m for pair in moments for m in pair], st["shadow"]))
            continue
        table = torch.from_numpy(np.concatenate(
            [opt.scalar_rows(40), ema.scalar_rows(0, 40)], axis=1))
        k = opt.row_width
        for j in range(40):
            for p, g in zip(params, grads[j]):
                p.grad = g.clone()
            if mode == "table":
                opt.step(row=table[j, :k])
                ema.step(params, st, row=table[j, k:])
            else:
                opt.step()
                ema.step(params, st)
        assert opt.count == 40 and st["steps"] == 40
        runs.append(([p.detach() for p in params],
                     [opt.state[p][m] for p in params for m in ("mu", "nu")],
                     st["shadow"]))
    for other in runs[1:]:
        for a_list, b_list in zip(runs[0], other):
            for a, b in zip(a_list, b_list):
                assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.fixture()
def port_cfg(tmp_path):
    from jnerf_tpu_torch.utils.bench_cfg import ngp_synthetic_cfg

    cfg = ngp_synthetic_cfg(**TINY_NGP)
    cfg.update(TINY_EXTRA)
    cfg.log_dir = str(tmp_path / "logs")
    yield cfg
    cfg.clear()


def test_in_place_counter_gives_the_same_demand_and_shapes(port_cfg):
    """Through train_range on a CPU runner, the one demand counter, zeroed
    and added to in place, hands each adaptation the sum of the samples
    counted in the window before the last, and the shapes follow the
    deadband controller fed those sums (a copy of the sampler from before
    the run), as with a fresh counter a window."""
    from jnerf_tpu_torch.runner import Runner

    runner = Runner(device="cpu")
    sampler = runner.sampler
    ref = copy.copy(sampler)
    counter = sampler.state["measured_batch_size"]
    per_step, calls, shapes = [], [], []
    forward_loss = runner.forward_loss

    def counted(*a, **k):
        total, main, samples = forward_loss(*a, **k)
        per_step.append(int(samples.count.sum()))
        return total, main, samples

    update = sampler.update_batch_rays

    def recorded(**k):
        calls.append(dict(k))
        return update(**k)

    runner.forward_loss = counted
    sampler.update_batch_rays = recorded
    for w in range(6):
        runner.train_range(16 * w, 16 * (w + 1))
        shapes.append((sampler.n_rays_per_batch, sampler.n_samples_per_ray))
        assert sampler.state["measured_batch_size"] is counter
        assert int(counter) == sum(per_step[16 * w:16 * (w + 1)])
    assert len(calls) == 5
    for w, call in enumerate(calls, start=1):
        # Called at the end of window w with window w - 1's count.
        assert call["measured"] == sum(per_step[16 * (w - 1):16 * w])
        assert call["n_steps"] == 16
        ref.update_batch_rays(**call)
        assert (ref.n_rays_per_batch, ref.n_samples_per_ray) == shapes[w]
    assert shapes[-1] != (TINY_NGP["n_rays_per_batch"], shapes[0][1])


def test_cpu_and_mesh_runners_take_the_eager_loop(port_cfg, tmp_path):
    """Graph windows need a CUDA device and no mesh; a CPU runner, alone
    or under a (one-rank gloo) mesh, runs every window as a loop of
    train_step and captures nothing."""
    import torch.distributed as dist

    from jnerf_tpu_torch.parallel import make_mesh
    from jnerf_tpu_torch.runner import Runner
    from jnerf_tpu_torch.runner.runner import graph_windows

    assert graph_windows("cuda", None)
    assert not graph_windows("cuda", object())
    assert not graph_windows("cpu", None)
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        for mesh in (None, make_mesh(1, device="cpu")):
            runner = Runner(device="cpu")
            runner.mesh = mesh
            calls = []
            step = runner.train_step
            runner.train_step = lambda **k: calls.append(1) or step(**k)
            loss = runner.train_range(0, 20)
            assert len(calls) == 20 and torch.isfinite(loss)
            assert runner.window_losses.shape == (4,)
            assert not runner.windows.cache
            assert not runner.windows.warm
            assert runner.optimizer.count == 20
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("shape", [(64, 128), (3, 5, 17)])
def test_transmittance_backward_is_torch_cumprods(shape):
    """The capture-safe cumprod gives torch.cumprod's values and gradient
    bit for bit where no factor is zero (1 - alpha + 1e-10 never is)."""
    from jnerf_tpu_torch.ops.composite import transmittance

    gen = torch.Generator().manual_seed(0)
    alpha = torch.rand(shape, generator=gen)
    alpha[..., ::7] = 1.0
    g = torch.randn(shape, generator=gen)
    got = []
    for fn in (transmittance,
               lambda a: torch.cumprod(1.0 - a + 1e-10, dim=-1)):
        a = alpha.clone().requires_grad_(True)
        out = fn(a)
        out.backward(g)
        got.append((out.detach(), a.grad))
    for x, y in zip(*got):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))


def test_window_time_tool_on_the_cpu(tiny_cfg, capsys):  # noqa: F811
    """tools/window_time.py at a tiny size on the CPU: the eager path
    alone (graphs need the card), no device time, a finite loss."""
    from jnerf_tpu_torch.tools import window_time

    out = window_time.main(["--cpu", "--steps", "32", "--windows", "1",
                            "--compact-m", "10"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["backend"] == "cpu" and line["card"] == "cpu"
    assert set(out) == {"eager", "backend", "card"}
    eager = out["eager"]
    assert eager["kernel_ms"] is None and eager["peak_mib"] is None
    assert eager["host_ms"] > 0 and np.isfinite(eager["loss"])
    assert eager["graphs"] == 0 and eager["steps"] == 64

"""The ports of the archived step probes
(`jnerf_tpu_torch/tools/archive/{probe_ab,probe_step3,probe_step_parts,
profile_step,probe_nan_hard,probe_compile}.py`) on the CPU.

Each builds its runner from the port's bench config, cut by
``tiny_cfg`` (4 images of 16^2, 256 rays, a 32^3 grid, 2^13-entry
tables), with its own batch and sizes patched small and one rep a
timing; each prints the archive's lines under its names.  The training
runs on the CPU take the eager path that the card replays as graphs.
"""

import importlib

import pytest

from jnerf_tpu_torch.tools.archive import common
from torch_parity import tiny_cfg, two_threads  # noqa: F401

TINY = {
    "probe_ab": dict(R=64, S=16),
    "probe_step3": dict(R=64, S=16, RANGE=(304, 320)),
    "probe_step_parts": dict(N=1024),
    "profile_step": dict(STEP_REPS=2),
    "probe_nan_hard": dict(WINDOW=4),
    "probe_compile": dict(CFG=dict(
        n_images=2, H=16, W=16, n_rays_per_batch=256,
        target_batch_size=1 << 12, grid_size=32, log2_hashmap_size=12)),
}


def _module(name):
    return importlib.import_module(f"jnerf_tpu_torch.tools.archive.{name}")


@pytest.fixture()
def tiny(monkeypatch, tiny_cfg):  # noqa: F811
    monkeypatch.setattr(common, "REPS", 1)

    def shrink(name):
        mod = _module(name)
        for k, v in TINY[name].items():
            monkeypatch.setattr(mod, k, v)
        return mod

    return shrink


def _timed(lines):
    return all(ln["ms"] > 0 for ln in lines if "no_counterpart" not in ln)


@pytest.mark.parametrize("variant,names", [
    ("base", ["AB f8l4 base"]),
    ("pallasmlp", ["AB f8l4 pallasmlp"]),
    ("proberef", ["AB f8l4 proberef refresh"]),
    ("sweepparts", ["AB f8l4 sweepparts chunked_density(0.02M)",
                    "AB f8l4 sweepparts sweep refresh",
                    "AB f8l4 sweepparts mean+bitfield"]),
])
def test_probe_ab_variants(tiny, variant, names, capsys):
    """Each variant's lines; pallasmlp's window runs F-MLP and B-MLP (here
    their twins) once a step."""
    lines = tiny("probe_ab").main(["f8l4", variant, "--cpu"])
    assert [ln["name"] for ln in lines] == names and _timed(lines)
    out = capsys.readouterr().out
    assert out.startswith("card: cpu\n")
    if variant in ("base", "pallasmlp"):
        assert f"AB f8l4 {variant}: per-step " in out
        assert lines[0]["window_ms"] == pytest.approx(4 * lines[0]["ms"])


def test_probe_ab_nocombine_alone_exits_2(tiny, capsys):
    with pytest.raises(SystemExit) as e:
        tiny("probe_ab").main(["f2l16", "nocombine", "--cpu"])
    assert e.value.code == common.NO_COUNTERPART
    assert "RUN_COMBINE" in capsys.readouterr().out


def test_probe_step3_parts(tiny, capsys):
    """Every part in the archive's order, with the per-step and amortized
    lines; the window part trains across a refresh."""
    lines = tiny("probe_step3").main(["f2l16", "--cpu"])
    assert [ln["name"] for ln in lines] == [
        "full step (scan4, device-true)", "train_range", "march (sample_fixed)",
        "SH encode", "composite+mse fwd", "composite+mse fwd+bwd", "adam+ema",
        "grid refresh", "model fwd", "model fwd+bwd"]
    assert _timed(lines)
    out = capsys.readouterr().out
    assert "encoder=f2l16 R=64 S=16" in out
    assert "  -> per-step " in out and "  -> amortized " in out


def test_probe_step_parts_sections(tiny, capsys):
    lines = tiny("probe_step_parts").main(["--cpu"])
    assert [ln["name"] for ln in lines] == [
        "hash encode fwd", "hash grad kernel (direct)",
        "hash fwd+bwd (jax.grad)", "model fwd", "model fwd+bwd"]
    assert _timed(lines)
    assert "spec entries=" in capsys.readouterr().out


def test_profile_step_lines(tiny, capsys):
    lines = tiny("profile_step").main(["--rays", "64", "--samples", "16",
                                       "--cpu"])
    assert [ln["name"] for ln in lines] == [
        "dispatch noop", "march", "model fwd", "model fwd+bwd",
        "full train step", "grid update"]
    assert _timed(lines) and lines[0]["device_ms"] is None
    out = capsys.readouterr().out
    assert "march 64x16:" in out and out.strip().endswith("backend: cpu")


def test_probe_nan_hard_health_and_render(tiny, capsys):
    """Two windows of 4 steps on the hard scene: a health line each, then
    the render's line, every value finite; --no-matmul prints its line."""
    lines = tiny("probe_nan_hard").main(["--steps", "8", "--no-matmul",
                                         "--cpu"])
    assert [ln["name"] for ln in lines] == ["--no-matmul", "step 4", "step 8",
                                            "render"]
    for ln in lines[1:3]:
        assert ln["params_finite"] and not ln["grid_nan"]
        assert ln["R"] > 0 and ln["S"] > 0
    assert lines[-1]["ok"] and lines[-1]["non_finite_params"] == []
    out = capsys.readouterr().out
    assert "non-finite param leaves: none" in out and "psnr:" in out


def test_probe_nan_hard_fails_on_a_nan(tiny, monkeypatch):
    """A parameter turned NaN is listed and the probe exits 1."""
    from jnerf_tpu_torch.runner import Runner

    real = Runner.train_range

    def poisoned(self, *a, **k):
        out = real(self, *a, **k)
        self.params[-1].data[0] = float("nan")
        return out

    monkeypatch.setattr(Runner, "train_range", poisoned)
    with pytest.raises(SystemExit) as e:
        tiny("probe_nan_hard").main(["--steps", "4", "--cpu"])
    assert e.value.code == 1


def test_probe_compile_single_device(tiny, capsys):
    lines = tiny("probe_compile").main(["--single-device", "--levels", "4",
                                        "--nerf-steps", "128", "--cpu"])
    assert [ln["name"] for ln in lines] == [
        "setup", "[grid_update] lower/compile", "grid_update",
        "[train_step] lower/compile", "train_step"]
    assert _timed(lines)
    out = capsys.readouterr().out
    assert "[build] no nvcc build on the CPU" in out and "compact=" in out


def test_probe_compile_two_ranks(tiny):
    """Two gloo ranks on the CPU: the spawn line, and both ranks' first
    steps on the same batch (ranks share the batch, so one loss)."""
    lines = tiny("probe_compile").main(["--levels", "4", "--nerf-steps",
                                        "128", "--skip-grid", "--no-compact",
                                        "--cpu"])
    assert [ln["name"] for ln in lines] == [
        "setup", "spawn", "[train_step] lower/compile", "train_step"]
    assert _timed(lines)
    losses = lines[-1]["losses"]
    assert len(losses) == 2 and losses[0] == pytest.approx(losses[1],
                                                           rel=1e-5)

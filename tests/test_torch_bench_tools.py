"""The port's bench (`jnerf_tpu_torch/bench.py`), `tools/bench_psnr.py`
and `tools/probe_demand.py`'s stats on the CPU, held to the JAX tools:
the variant grammar and the config list, the keys of every line they
print or write, the demand stats against the JAX package's
``compact_indices``, the exit code of a bench with a failed config, the
quality anchor and its guards on fixture files, and where bench_psnr
writes.  The JAX tools' keys are read from their sources (the dict
literals that hold them), so that no JAX tool runs here; the bench's
widths are cut by ``shrink_bench_cfg``."""

import ast
import importlib
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_parity import (  # noqa: F401 (fixtures)
    files_under, jax_tool_dict_keys, tiny_cfg, two_threads,
)

REPO = Path(__file__).resolve().parents[1]


def _jax_tool(rel):
    """A JAX tool's module, imported by path (its main does not run)."""
    spec = importlib.util.spec_from_file_location(
        "jax_" + Path(rel).stem, REPO / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _list_with(rel, marker):
    """The first list literal of strings in ``rel`` that holds ``marker``."""
    for node in ast.walk(ast.parse((REPO / rel).read_text())):
        if isinstance(node, ast.List) and all(
                isinstance(e, ast.Constant) for e in node.elts):
            vals = [e.value for e in node.elts]
            if marker in vals:
                return vals
    raise AssertionError(f"no list with {marker!r} in {rel}")


# --------------------------------------------------------------- the bench
VARIANTS = ("m17f2k19", "m17f2", "m16f1", "c2", "c4", "m17", "f4", "k19",
            "m18f2k19", "m16f1k17", "")


@pytest.mark.parametrize("variant", VARIANTS)
def test_parse_variant_matches_jax(variant):
    """The variant grammar gives the JAX bench's overrides, token for
    token."""
    from jnerf_tpu_torch import bench

    assert bench.parse_variant(variant) == \
        _jax_tool("bench.py").parse_variant(variant)


def test_config_list_is_the_jax_benchs():
    """The same configs in the same order, the headline first, and the
    same baselines."""
    from jnerf_tpu_torch import bench

    jax_bench = _jax_tool("bench.py")
    assert list(bench.SHAPES) == _list_with("bench.py", "f8l4+m17f2k19")
    assert bench.SHAPES[0] == "f8l4+m17f2k19"
    assert bench.BASELINE_ITERS_PER_S == jax_bench.BASELINE_ITERS_PER_S
    assert bench.BASELINE_SAMPLES_PER_S == jax_bench.BASELINE_SAMPLES_PER_S


def test_measure_on_the_cpu_returns_the_jax_keys(tiny_cfg):
    """The headline config for 16 warm-up and 16 timed steps on 16^2
    images (widths cut by ``tiny_cfg``): the JAX bench's keys and the
    kernel launches (none on the CPU: the wrappers run their twins)."""
    import argparse

    from jnerf_tpu_torch import bench

    args = argparse.Namespace(warmup=16, steps=16, image_size=16,
                              device=torch.device("cpu"))
    res = bench.measure("f8l4+m17f2k19", args)
    assert set(res) == (jax_tool_dict_keys("bench.py", "iters_per_s")
                        | {"launches"})
    assert res["launches"] == {"F": 0, "B": 0}
    assert res["iters_per_s"] > 0 and res["samples_per_s"] > 0
    assert res["samples_per_step"] <= 1 << 17


def _fake_measure(fail):
    def measure(encoder, args):
        if encoder in fail:
            raise RuntimeError(f"{encoder} broke")
        return {"iters_per_s": 100.0, "rays_per_s": 409600,
                "samples_per_step": 100000, "samples_per_s": 10_000_000,
                "n_rays_per_batch": 4096, "samples_per_ray": 64,
                "elapsed_s": 2.56, "launches": {"F": 260, "B": 256}}
    return measure


@pytest.mark.parametrize("fail,code", [((), 0), (("f4l8+m16f1",), 1),
                                       (("f8l4+m17f2k19",), 1)])
def test_main_prints_one_line_and_exits_1_on_a_failed_config(
        monkeypatch, capsys, tmp_path, fail, code):
    """One JSON line with the JAX bench's keys.  A config that raises
    stays in the line as its error entry, and the exit code is 1 (the JAX
    bench exits 0 while one config survives); when the headline fails
    the next config heads the line."""
    from jnerf_tpu_torch import bench
    from jnerf_tpu_torch.tools import tool_util

    monkeypatch.setattr(bench, "measure", _fake_measure(fail))
    monkeypatch.setattr(tool_util, "LOG_DIR", tmp_path)
    assert bench.main(["--cpu"]) == code
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    line = json.loads(out[0])
    assert set(line) == jax_tool_dict_keys("bench.py", "metric")
    extra = line["extra"]
    head = [s for s in bench.SHAPES if s not in fail][0]
    assert extra["encoder"] == head and line["value"] == 100.0
    assert line["vs_baseline"] == round(100.0 / 133.0, 3)
    assert extra["vs_baseline_samples"] == round(1e7 / (133.0 * 2 ** 18), 3)
    measured = (jax_tool_dict_keys("bench.py", "iters_per_s")
                - {"iters_per_s"})
    jax_extra = jax_tool_dict_keys("bench.py", "backend")
    assert (measured | jax_extra | {"vs_baseline_samples", "launches", "card"}
            | set(bench.SHAPES) - {head} | {"quality_error"}) == set(extra)
    assert extra["backend"] == "cpu" and extra["card"] == "cpu"
    for s in fail:
        assert extra[s] == {"error": f"RuntimeError: {s} broke"}
    assert "FileNotFoundError" in extra["quality_error"]


def test_main_with_every_config_failed(monkeypatch, capsys):
    """No config survives: the JAX bench's error line, exit code 1."""
    from jnerf_tpu_torch import bench

    monkeypatch.setattr(bench, "measure", _fake_measure(bench.SHAPES))
    assert bench.main(["--cpu"]) == 1
    line = json.loads(capsys.readouterr().out)
    assert line["value"] == 0 and set(line["extra"]["errors"]) == \
        set(bench.SHAPES)


def _anchor_files(root, value, ceiling, qrev, crev, nested=False):
    (root / "quality").mkdir(parents=True, exist_ok=True)
    (root / "ceiling_f8l4_m17f2k19_hard_plain_s42.json").write_text(
        json.dumps({"psnr_ceiling": ceiling, "git_rev": crev,
                    "scene": "synthetic-hard-512-ssaa2"}))
    at5 = {"value": value}
    at5.update({"extra": {"git_rev": qrev}} if nested else {"git_rev": qrev})
    (root / "quality" / "psnr300_f8l4_m17f2k19_hard.json").write_text(
        json.dumps(at5))


def test_quality_anchor_reads_the_ports_logs(tmp_path):
    """The anchor reads logs/torch/'s ceiling_run and bench_psnr files of
    the headline: a sane pair of one rev, a fraction past 1.02 (suspect),
    revs that git cannot diff (a mismatch, where the JAX bench saw no
    change), and a missing file (an OSError for main to report)."""
    from jnerf_tpu_torch import bench

    _anchor_files(tmp_path, 30.0, 40.0, "abc1234", "abc1234")
    assert bench.quality_anchor("f8l4+m17f2k19", tmp_path) == {
        "psnr_at_5min": 30.0, "psnr_ceiling": 40.0,
        "fraction_of_ceiling": 0.75, "scene": "synthetic-hard-512-ssaa2"}
    _anchor_files(tmp_path, 41.0, 40.0, "0badc0de", "0deadbee", nested=True)
    q = bench.quality_anchor("f8l4+m17f2k19", tmp_path)
    assert q["fraction_of_ceiling"] == 1.025 and q["fraction_suspect"] is True
    assert q["rev_mismatch"] == "0deadbee!=0badc0de"
    with pytest.raises(OSError):
        bench.quality_anchor("f8l4+m16f1", tmp_path)


def test_rev_guard_counts_a_failed_diff_as_a_mismatch(tmp_path):
    """`git diff` of unknown revs exits non-zero with no output: a
    mismatch; outside any checkout too."""
    from jnerf_tpu_torch.tools.tool_util import rev_mismatch

    assert rev_mismatch("0deadbee", "0badc0de")
    assert rev_mismatch("0deadbee", "0badc0de", root=tmp_path)


# ------------------------------------------------------------ demand stats
def _jax_demand_stats(valid, count, S, m):
    """`tools/probe_demand.py`'s stats of one batch, with the JAX
    package's compact_indices."""
    import jax.numpy as jnp

    from jnerf_tpu.ops.compact import compact_indices

    kept = valid.astype(np.int64).cumprod(axis=1).sum(axis=1)
    total_kept = int(kept.sum())
    stats = {
        "slot_occupancy": round(float(valid.mean()), 4),
        "kept_samples": total_kept,
        "demand_sum": int(count.sum()),
        "rays_S_truncated": round(float((count > S).mean()), 4),
        "mean_demand_per_ray": round(float(count.mean()), 2),
    }
    if m:
        info = compact_indices(jnp.asarray(valid), m)
        trunc = np.asarray(info.truncated)
        offs = np.asarray(info.offsets)
        dropped = max(0, int(offs[-1]) - m)
        stats.update({
            "rays_cap_truncated": round(float(trunc.mean()), 4),
            "samples_dropped_by_cap": dropped,
            "frac_samples_dropped": round(dropped / max(total_kept, 1), 4),
        })
    return stats


@pytest.mark.parametrize("m", [None, 1 << 8, 1 << 10, 1 << 14])
def test_demand_stats_match_jax(m):
    """On a seeded [R, S] mask (leading runs, a few stragglers past a
    hole, empty rays) and demand counts, the port's stats equal those the
    JAX tool builds from the JAX package's compact_indices, at caps that
    truncate and one that does not."""
    from jnerf_tpu_torch.tools.probe_demand import demand_stats

    rng = np.random.default_rng(13)
    R, S = 96, 24
    run = rng.integers(0, S + 1, R)
    valid = np.arange(S)[None, :] < run[:, None]
    stray = rng.random((R, S)) < 0.05
    valid |= stray & (np.arange(S)[None, :] > run[:, None] + 1)
    count = run + rng.integers(0, 12, R) * (run == S)
    got = demand_stats(torch.from_numpy(valid), torch.from_numpy(count), S, m)
    assert got == _jax_demand_stats(valid, count, S, m)


# ------------------------------------------------------- the other tools
def test_bench_psnr_tiny_cpu(tmp_path, monkeypatch, capsys):
    """`bench_psnr --tiny --iters 8 --cpu` (16 warm-up steps, not 256):
    the JAX script's keys in the line and in the file --out writes, a
    finite PSNR over its 2 val views, no ceiling (none for the tiny
    config under logs/torch/), and no other file written."""
    from jnerf_tpu_torch.tools import bench_psnr
    from jnerf_tpu_torch.utils.config import get_cfg

    monkeypatch.chdir(tmp_path)
    before = files_under(tmp_path, REPO / "logs")
    out = tmp_path / "q" / "psnr.json"
    try:
        res = bench_psnr.main(["--tiny", "--iters", "8", "--cpu",
                               "--warmup-steps", "16", "--out", str(out)])
    finally:
        get_cfg().clear()
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line) == res == json.loads(out.read_text())
    assert set(res) == jax_tool_dict_keys("bench_psnr.py", "metric")
    assert set(res["extra"]) == (
        jax_tool_dict_keys("bench_psnr.py", "psnr_ceiling") | {"card"})
    assert res["extra"]["iters"] == 8 and res["extra"]["budget_s"] is None
    assert len(res["extra"]["per_view_psnr"]) == 2
    assert np.isfinite(res["value"]) and res["vs_baseline"] is None
    assert res["extra"]["backend"] == "cpu" and res["extra"]["card"] == "cpu"
    assert files_under(tmp_path, REPO / "logs") - before == \
        {out.parent, out}


def test_bench_psnr_ceiling_names():
    """The ceiling looked up is ceiling_run's default file of the same
    config: the headline's is the one the bench's anchor reads."""
    from jnerf_tpu_torch.tools import bench_psnr

    args = bench_psnr.parse_args(
        ["--scene", "hard", "--encoder", "f8l4", "--compact",
         "--compact-m", "17", "--march-factor", "2", "--fast-cap", "524288"])
    assert bench_psnr.ceiling_name(args) == \
        "ceiling_f8l4_m17f2k19_hard_plain_s42.json"
    args = bench_psnr.parse_args(["--ceiling-file", "logs/x.json"])
    assert bench_psnr.ceiling_name(args) == "logs/x.json"

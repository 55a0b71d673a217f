"""The port's probes and smaller quality tools on the CPU
(`jnerf_tpu_torch/tools/{ab_hash_quality,tiny_ceiling_svox2,time_step,
probe_tiers,probe_compact,probe_cap19}.py`), held to the JAX tools: the
keys of the lines they print or write (read from the JAX tools' sources),
the geometry that `probe_cap19` checks against the JAX package's spec,
its exact adjoint against a float64 sum, where each tool writes, and
every entry point's refusal to run on a missing card.  Widths are cut by
``shrink_bench_cfg`` where a tool builds a bench config."""

import importlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_parity import (  # noqa: F401 (fixtures)
    files_under, jax_tool_dict_keys, tiny_cfg, two_threads,
)

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


def test_ab_hash_quality_cpu(tiny_cfg, tmp_path, monkeypatch, capsys):
    """`ab_hash_quality --steps=8 --size=16 --cpu` (its grid and tables
    cut by ``tiny_cfg``): one line an arm, linear_rows then xor, each with
    the JAX tool's keys and a finite PSNR over 2 val views; nothing
    written."""
    from jnerf_tpu_torch.tools import ab_hash_quality
    from jnerf_tpu_torch.utils.config import get_cfg

    monkeypatch.chdir(tmp_path)
    before = files_under(tmp_path, REPO / "logs")
    try:
        ab_hash_quality.main(["--steps=8", "--size=16", "--cpu"])
    finally:
        get_cfg().clear()
    lines = [json.loads(x) for x in capsys.readouterr().out.strip()
             .splitlines()]
    assert [x["hash_indexing"] for x in lines] == ["linear_rows", "xor"]
    jax_keys = jax_tool_dict_keys("tools/ab_hash_quality.py",
                                  "hash_indexing")
    for x in lines:
        assert set(x) == jax_keys | {"backend", "card"}
        assert (x["steps"], x["size"], x["log2"], x["levels"]) == \
            (8, 16, 15, 8)
        assert len(x["per_view"]) == 2 and np.isfinite(x["psnr"])
    assert files_under(tmp_path, REPO / "logs") == before


def test_tiny_ceiling_svox2_cpu(tmp_path, monkeypatch, capsys):
    """`tiny_ceiling_svox2 --iters 8 --eval-every 4 --cpu`: the JAX tool's
    keys, a trajectory of two evals whose best is the ceiling, written
    only to --out."""
    from jnerf_tpu_torch.tools import tiny_ceiling_svox2
    from jnerf_tpu_torch.utils.config import get_cfg

    monkeypatch.chdir(tmp_path)
    before = files_under(tmp_path, REPO / "logs")
    out = tmp_path / "svox2.json"
    try:
        res = tiny_ceiling_svox2.main(["--iters", "8", "--eval-every", "4",
                                       "--cpu", "--out", str(out)])
    finally:
        get_cfg().clear()
    assert json.loads(out.read_text()) == res
    assert set(res) == jax_tool_dict_keys("tools/tiny_ceiling_svox2.py",
                                          "psnr_ceiling") | {"card"}
    assert [t["iters"] for t in res["trajectory"]] == [4, 8]
    assert res["psnr_ceiling"] == max(t["psnr"] for t in res["trajectory"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == {k: v for k, v in res.items() if k != "trajectory"}
    assert files_under(tmp_path, REPO / "logs") - before == {out}


ENTRY_POINTS = ("jnerf_tpu_torch.bench", "jnerf_tpu_torch.tools.bench_psnr",
                "jnerf_tpu_torch.tools.time_step",
                "jnerf_tpu_torch.tools.probe_tiers",
                "jnerf_tpu_torch.tools.probe_demand",
                "jnerf_tpu_torch.tools.probe_compact",
                "jnerf_tpu_torch.tools.ab_hash_quality",
                "jnerf_tpu_torch.tools.tiny_ceiling_svox2",
                "jnerf_tpu_torch.tools.probe_cap19")


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_point_refuses_a_missing_card(name):
    """Without a card every entry point raises before it builds anything
    unless given --cpu; none falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is present here")
    mod = importlib.import_module(name)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main([])


def test_time_step_cpu(tiny_cfg, capsys):
    """`time_step --cpu`: every timing a positive host ms and no device
    ms (none exists on the CPU), the JAX tool's lines in its order."""
    from jnerf_tpu_torch.tools import time_step

    out = time_step.main(["--cpu", "--steps", "2"])
    assert list(out) == ["first_refresh", "first_step", "steady_0",
                         "steady_1", "steady_2", "refresh_1000",
                         "refresh_steady", "march", "model_fwd_bwd"]
    assert all(h > 0 and d is None for h, d in out.values())
    text = capsys.readouterr().out
    for label in ("backend=cpu", "first grid update", "first train step",
                  "steady train step", "grid update steady", "march:",
                  "model fwd+bwd", "device not measured"):
        assert label in text


def test_probe_tiers_cpu(tiny_cfg, capsys, monkeypatch):
    """`probe_tiers --cpu` with compaction on (M = 2^10 of the tiny
    config's 2^13 slots), 2 timings of 2 reps a tier: the JAX tool's
    tiers in ms, the shapes line, and the device columns empty on the
    CPU."""
    from jnerf_tpu_torch.tools import probe_tiers

    monkeypatch.setattr(probe_tiers, "REPS", 2)
    monkeypatch.setattr(probe_tiers, "TRIALS", 2)
    out = probe_tiers.main(["--cpu", "--steps", "16", "--compact-m", "10",
                            "--march-factor", "2"])
    tiers = ["full", "march", "model_f", "model_fb", "comp_fb", "optim"]
    assert list(out)[:7] == ["shapes"] + tiers
    assert out["shapes"].endswith("M=1024")
    assert all(out[t] > 0 for t in tiers)
    for col in ("event_ms", "kernel_ms", "busy", "kernels"):
        assert out[col] == {t: None for t in tiers}
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out


def test_probe_compact_cpu(tiny_cfg, capsys):
    """`probe_compact --only`: the JAX tool's six labels in its order,
    and one line a chosen config with its keys."""
    from jnerf_tpu_torch.tools import probe_compact

    assert [c[0] for c in probe_compact.CONFIGS] == [
        "padded", "compact_f2", "compact_f4", "compact_m17_f2",
        "compact_m17_f1", "compact_m16_f1"]
    out = probe_compact.main(["--cpu", "--steps", "16",
                              "--only", "compact_m16_f1"])
    assert [x["config"] for x in out] == ["compact_m16_f1"]
    jax_keys = jax_tool_dict_keys("tools/probe_compact.py", "ms_per_step")
    for x in out:
        assert set(x) == jax_keys | {"device_ms_per_step", "card"}
        assert x["ms_per_step"] > 0 and x["device_ms_per_step"] is None
    printed = [json.loads(x) for x in
               capsys.readouterr().out.strip().splitlines()]
    assert printed == out


@pytest.mark.parametrize("levels,feats", [(4, 8), (8, 4)])
def test_probe_cap19_geometry_is_the_jax_tools(levels, feats):
    """The checked tables are the JAX tool's: the same spec (2^19-entry
    hashed levels at f8l4 and f4l8) has the same level sizes in both
    packages."""
    from jnerf_tpu.ops.hash_grid import HashGridSpec as JaxSpec

    from jnerf_tpu_torch.ops.hash_grid import HashGridSpec
    from jnerf_tpu_torch.tools import probe_cap19

    assert (levels, feats, 1 << 19) in probe_cap19.GEOMETRIES
    kw = dict(n_levels=levels, n_features_per_level=feats,
              base_resolution=16, log2_hashmap_size=19,
              max_level_size=1 << 19)
    assert HashGridSpec(**kw).level_sizes == JaxSpec(**kw).level_sizes


@pytest.mark.parametrize("shape", ["f8l4+m17f2k19", "f8l4+m17f2", "f8l4+m16f1",
                                   "f4l8+m16f1", "f2l16+m16f1", "f2l16"])
def test_probe_cap19_covers_the_bench_tables(shape):
    """Each table the bench trains, built by the JAX package's and the
    port's hash encoders from the bench's config, has the same level sizes
    in both, and is one that `probe_cap19` checks, but f2l16 at 2^18,
    which `chip_smoke.py` phase 3 checks."""
    from jnerf_tpu.models.position_encoders.hash_encoder import (
        HashEncoder as JaxEncoder,
    )
    from jnerf_tpu.utils.config import get_cfg as jax_cfg

    from jnerf_tpu_torch import bench
    from jnerf_tpu_torch.models.position_encoders.hash_encoder import (
        HashEncoder,
    )
    from jnerf_tpu_torch.tools import probe_cap19
    from jnerf_tpu_torch.tools.tool_util import ENCODERS
    from jnerf_tpu_torch.utils.config import get_cfg

    assert shape in bench.SHAPES
    name, _, variant = shape.partition("+")
    enc = ENCODERS[name]
    kw = dict(n_levels=enc.get("hash_levels", 16),
              n_features_per_level=enc.get("hash_features", 2), aabb_scale=1)
    cap = bench.parse_variant(variant).get("hashmap_fast_cap")
    specs = []
    for cfg, encoder in ((get_cfg(), HashEncoder), (jax_cfg(), JaxEncoder)):
        cfg.hashmap_fast_cap = cap
        try:
            specs.append(encoder(**kw).spec)
        finally:
            cfg.clear()
    spec, jax_spec = specs
    assert spec.level_sizes == jax_spec.level_sizes
    geom = (spec.n_levels, spec.n_features_per_level, spec.max_level_size)
    assert geom in probe_cap19.GEOMETRIES or geom == (16, 2, 1 << 18)


def test_probe_cap19_cpu_small():
    """On the CPU (the twins) at 2^10 samples over 2^12-entry levels: the
    twin's forward equals itself, the f32 table gradient stands within
    1e-6 of the float64 sum, which itself equals a per-sample loop's."""
    from jnerf_tpu_torch.ops import hash_nbr
    from jnerf_tpu_torch.ops.hash_grid import HashGridSpec
    from jnerf_tpu_torch.tools import probe_cap19

    line = probe_cap19.run(4, 8, CPU, n=1 << 10, cap=1 << 12, reps=1)
    assert line["fwd_err"] == 0.0 and line["rel_err"] < 1e-6
    assert line["rel_err"] == line["twin_rel_err"]
    assert line["clock"] == "host" and line["n_entries"] == 16384
    assert all(line[k] > 0 for k in line if k.endswith("_ms"))

    spec = HashGridSpec(n_levels=2, n_features_per_level=2,
                        base_resolution=4, log2_hashmap_size=6,
                        max_level_size=1 << 6)
    gen = torch.Generator().manual_seed(3)
    pos = torch.rand((5, 3), generator=gen)
    g = torch.randn((5, 4), generator=gen)
    ref = probe_cap19.exact_grad_table(hash_nbr, spec, pos, g)
    loop = torch.zeros_like(ref)
    for i in range(5):
        loop += hash_nbr.grad_table_plain(spec, pos[i:i + 1],
                                          g[i:i + 1]).double()
    np.testing.assert_allclose(ref.numpy(), loop.numpy(), rtol=1e-6,
                               atol=1e-7)

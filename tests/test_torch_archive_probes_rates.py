"""The ports of the archived library-rate probes
(`jnerf_tpu_torch/tools/archive/probe_{gather,tpu3,scatter3,vmem}.py`) on
the CPU, and what all 17 ports of the archived probes that make no
``pallas_call`` share: each refuses to run without a card unless given
``--cpu``, and none imports JAX or the JAX package (torch only).

The rate probes run with ``--cpu`` at tiny sizes (module constants
patched, one rep a timing); each line carries a positive rate, its bytes
and its bound, and the byte counts are checked by hand.
"""

import ast
import importlib
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from jnerf_tpu_torch.tools.archive import common
from torch_parity import two_threads  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
PROBES = ("probe_ab", "probe_bwd_debug", "probe_compile", "probe_f4",
          "probe_fused_mlp", "probe_fwd2", "probe_gather", "probe_march",
          "probe_nan_hard", "probe_nbr", "probe_nbr2", "probe_scatter3",
          "probe_step3", "probe_step_parts", "probe_tpu3", "probe_vmem",
          "profile_step")
TINY = {
    "probe_gather": dict(N=1024, NS=256, KI=4, MI=64, LEVEL_SIZES=[64, 128]),
    "probe_tpu3": dict(T=256, N=1024, ROLL_ROWS=1000, CELLS=4096,
                       PROBES=1000, SS_ROWS=16, SS_COLS=32),
    "probe_scatter3": dict(N=256, SECTIONS={
        "f32": ("16x scatter [262K]->[262K,16] f32 (16MB)", 64,
                torch.float32),
        "bf16": ("16x scatter [262K]->[262K,16] bf16 (8MB)", 64,
                 torch.bfloat16),
        "f32half": ("16x scatter [262K]->[128K,16] f32 (8MB)", 32,
                    torch.float32)}),
    "probe_vmem": dict(N=1024, KI=4),
}
ARGS = {"probe_gather": ["a", "b", "c", "d", "e"]}
LINES = {
    "probe_gather": [
        "[512K,128] bf16 rand", "[512K, 16] bf16 rand", "[6M,   16] bf16 rand",
        "[6M,   16] f32  rand", "[6M,  128] bf16 rand", "[6M,   16] bf16 sort",
        "[64K,  16] bf16 rand", "[64K, 128] bf16 rand", "[512K,32] bf16 rand",
        "[512K,64] bf16 rand", "[128K,16] bf16 rand", "[256K,16] bf16 rand",
        "[512K,16] 64K-window", "per-level 16x gather [262K,16]"],
    "probe_tpu3": [
        "row-gather 4.2M x128 f32", "row-gather 4.2M x128 bf16",
        "row-gather+lane-reduce 4.2M", "row-scatter-add 4.2M x128",
        "row-scatter-add 4.2M x16", "8 rolls of 12Mx2 table",
        "bool gather 1.2M", "vmapped searchsorted 4096x64"],
    "probe_scatter3": [
        "16x scatter [262K]->[262K,16] f32 (16MB)",
        "16x scatter [262K]->[262K,16] bf16 (8MB)",
        "16x scatter [262K]->[128K,16] f32 (8MB)"],
    "probe_vmem": ["opt", "[512K,16] single gather",
                   "[512K,16] 2x256K select-split", "[512K,128] single gather",
                   "[512K,128] 2x256K select-split", "[320K=10MB,16] bf16",
                   "[384K=12MB,16] bf16", "[448K=14MB,16] bf16"],
}
# Arguments that keep each probe's refusal cheap (it refuses before any
# work).
REFUSE_ARGS = {"probe_nan_hard": ["--steps", "1"]}


def _module(name):
    return importlib.import_module(f"jnerf_tpu_torch.tools.archive.{name}")


@pytest.fixture()
def tiny(monkeypatch):
    monkeypatch.setattr(common, "REPS", 1)

    def shrink(name):
        mod = _module(name)
        for k, v in TINY[name].items():
            monkeypatch.setattr(mod, k, v)
        return mod

    return shrink


@pytest.mark.parametrize("name", sorted(TINY))
def test_rate_probe_runs_on_the_cpu(tiny, name, capsys):
    """--cpu at a tiny size: the archive's lines in its order, each with a
    positive rate, bytes and bound, named as a library call."""
    lines = tiny(name).main(ARGS.get(name, []) + ["--cpu"])
    assert [ln["name"] for ln in lines] == LINES[name]
    for ln in lines:
        if "no_counterpart" in ln:
            continue
        assert ln["ms"] > 0 and ln["bytes"] > 0 and ln["bound_ms"] > 0
        assert ln["ran"].startswith("library:") and ln["clock"] == "host"
    assert capsys.readouterr().out.startswith("card: cpu\n")


def test_probe_vmem_opt_alone_exits_2(tiny, capsys):
    with pytest.raises(SystemExit) as e:
        tiny("probe_vmem").main(["opt", "--cpu"])
    assert e.value.code == common.NO_COUNTERPART
    assert "xla_tpu_scoped_vmem_limit_kib" in capsys.readouterr().out


def test_rate_probe_bytes_by_hand(tiny):
    """A gather: 4 B an index, each distinct row once, the output; a
    per-level scatter: 16 levels of indices, values and the accumulator."""
    pg = tiny("probe_gather")
    line = pg.main(["c", "--cpu"])[0]
    idx = common.uniform_idx(pg.N, 64 * pg.KI)
    rows = len(set(idx.tolist()))
    assert line["bytes"] == 4 * pg.N + 32 * rows + 32 * pg.N
    ps = tiny("probe_scatter3")
    line = ps.main(["bf16", "--cpu"])[0]
    assert line["bytes"] == 16 * (4 * ps.N + 32 * ps.N + 32 * 64)
    assert line["items"] == 16 * ps.N


def test_select_split_gathers_the_whole_tables_rows(tiny):
    """probe_vmem's split reads the same rows as the single gather."""
    ta, tb = torch.randn(8, 4), torch.randn(8, 4)
    idx = torch.tensor([0, 7, 8, 15, 3, 12])
    sel = (idx < 8)[:, None]
    split = torch.where(sel, ta.index_select(0, idx.clamp(max=7)),
                        tb.index_select(0, (idx - 8).clamp(min=0)))
    assert torch.equal(split, torch.cat([ta, tb]).index_select(0, idx))


@pytest.mark.parametrize("name", PROBES)
def test_probe_refuses_to_run_without_a_card(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _module(name).main(REFUSE_ARGS.get(name, []))


def _imported_modules(path: Path):
    """Every module a file imports, at any depth (lazy imports too)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
            names.update(f"{node.module}.{a.name}" for a in node.names)
    return names


def test_ports_import_no_jax():
    """No port names JAX or the JAX package in any import, lazy ones
    included; importing the ports and every module of the port they import
    in a fresh interpreter pulls in none of JAX, jaxlib or jnerf_tpu."""
    mods = set()
    for name in PROBES + ("common",):
        path = REPO / "jnerf_tpu_torch/tools/archive" / f"{name}.py"
        found = _imported_modules(path)
        bad = {m for m in found if m.split(".")[0] in ("jax", "jaxlib",
                                                        "jnerf_tpu")}
        assert not bad, f"{name} imports {bad}"
        mods |= {m for m in found if m.startswith("jnerf_tpu_torch")}
    code = f"""
import importlib, sys
before = set(sys.modules)
for m in {sorted(mods)!r}:
    try:
        importlib.import_module(m)
    except ModuleNotFoundError:  # a name imported from a module
        importlib.import_module(m.rsplit(".", 1)[0])
new = {{m.split(".")[0] for m in set(sys.modules) - before}}
print(sorted(new & {{"jax", "jaxlib", "jnerf_tpu"}}))
"""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"

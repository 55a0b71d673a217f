"""The byte and operation counts behind chip_smoke.py's bounds, against
values derived by hand from the kernels' shapes, and the script's refusal
to run without a card.

chip_smoke.py imports torch only inside its functions, so importing it
here touches no card.
"""

import os
import shutil
import subprocess
import sys

import pytest

import chip_smoke

N = 1 << 17  # the headline's kept samples / MLP rows


def test_kernel_b_headline_bytes():
    """Kernel B at N = 2^17, f8l4@2^19 (1,576,960 entries): pos 1,572,864
    + g 16,777,216 + the whole gradient 50,462,720 = 68,812,800 B, which
    bound it (20.5 us at 3.35 TB/s) far above its f32 work."""
    w = chip_smoke.hash_bwd_work(N, 4, 8, 1_576_960)
    assert w["bytes"] == 1_572_864 + 16_777_216 + 50_462_720 == 68_812_800
    assert w["flops"] == N * 4 * (24 + 8 * 18)
    assert w["bound_by"] == "bytes"
    assert w["bound_ms"] == pytest.approx(68_812_800 / 3.35e12 * 1e3)


@pytest.mark.parametrize("L,F,rows", [(4, 8, 1_000_000), (16, 2, 2_500_000)])
def test_kernel_f_bytes(L, F, rows):
    """Kernel F: positions, each table row it reads once (4F bytes), and
    the [N, F*L] f32 output."""
    w = chip_smoke.hash_fwd_work(N, L, F, rows)
    assert w["bytes"] == 12 * N + 4 * F * rows + 4 * F * L * N
    assert w["bound_by"] == "bytes"


@pytest.mark.parametrize("L,F,rows", [(4, 8, 1_000_000), (16, 2, 2_500_000)])
def test_kernel_f_bf16_bytes(L, F, rows):
    """Kernel F as the path runs it, writing bf16: 12 + 2*F*L bytes a
    sample, plus 4F bytes for each table row it reads; the f32 output
    counts 2*F*L bytes a sample more."""
    w = chip_smoke.hash_fwd_work(N, L, F, rows, out_bytes=2)
    assert w["bytes"] == (12 + 2 * F * L) * N + 4 * F * rows
    f32 = chip_smoke.hash_fwd_work(N, L, F, rows)
    assert f32["bytes"] - w["bytes"] == 2 * F * L * N
    assert w["flops"] == f32["flops"]
    assert w["bound_by"] == "bytes"


def test_fmlp_render_chunk_bound():
    """F-MLP at a render chunk's 2^20 rows: 117,440,512 B of rows (112 a
    row) and 37,632 B of weights, 35.1 us at 3.35 TB/s, above its 19.7
    GFLOP at the bf16 peak (19.9 us): bound by bytes."""
    w = chip_smoke.mlp_fwd_work(1 << 20)
    assert w["bytes"] == 117_440_512 + 37_632
    assert w["flops"] == 2 * 9408 * (1 << 20)
    assert w["bound_by"] == "bytes"
    assert w["bound_ms"] == pytest.approx((117_440_512 + 37_632) / 3.35e12 * 1e3)


@pytest.mark.parametrize("fn,row_bytes,row_flops,fixed", [
    ("mlp_fwd_work", 112, 2 * 9408, 9408 * 4),         # x 64 + d 32 + out 16
    ("mlp_bwd_work", 240, 2 * 27200, 2 * 9408 * 4),    # + g 16, dx 128
    ("density_work", 68, 2 * 2112, 2112 * 4),           # x 64 + out 4
])
def test_mlp_bytes_and_flops_per_row(fn, row_bytes, row_flops, fixed):
    """Per row: F-MLP 112 B and 9408 multiply-adds; B-MLP 240 B and
    9408 + 8384 + 9408 = 27,200 multiply-adds (recomputed forward,
    cotangents, weight gradients); D-MLP 68 B and 2112.  The weights (or
    their gradients) count once a call."""
    work = getattr(chip_smoke, fn)
    one, two = work(N), work(2 * N)
    assert two["bytes"] - one["bytes"] == row_bytes * N
    assert one["bytes"] == row_bytes * N + fixed
    assert one["flops"] == row_flops * N


def test_bmlp_headline_bound():
    """B-MLP at 2^17 rows: 7.13 GFLOP (7.2 us at 989 TFLOP/s bf16) under
    31.5 MB (9.4 us at 3.35 TB/s): bound by bytes, 9.4 us."""
    w = chip_smoke.mlp_bwd_work(N)
    assert w["flops"] == 7_130_316_800
    assert w["bound_by"] == "bytes"
    assert w["bound_ms"] == pytest.approx((240 * N + 75_264) / 3.35e12 * 1e3)
    assert w["flops"] / 989e12 * 1e3 < w["bound_ms"]


def test_smoke_refuses_without_a_card():
    """Without a CUDA device main() exits before printing any result."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a card")
    with pytest.raises(SystemExit, match="needs an NVIDIA GPU"):
        chip_smoke.main()


def test_smoke_alone_fails(tmp_path):
    """chip_smoke.py in a directory that holds nothing else of the repo
    exits nonzero and prints no result line."""
    shutil.copy(chip_smoke.__file__, tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_quality_bar_is_the_jax_psnr_less_half_a_db():
    """The hard-scene phase trains the JAX package's quality config and
    holds its mean val PSNR after 8192 iterations to the JAX package's at
    8192 (logs/ceiling_f8l4_m17f2k19_hard.json, trajectory[0]: 34.894 dB)
    less 0.5 dB: 34.394.  The reading it prints at 3328 iterations is that
    of logs/quality/psnr300_f8l4_m17f2k19_hard.json (30.34 dB, the mean of
    its four views), whose 3072 iterations follow bench_psnr.py's 256
    warm-up steps."""
    import json
    import re

    import numpy as np

    from jnerf_tpu_torch.utils.bench_cfg import ngp_synthetic_cfg

    repo = os.path.dirname(os.path.abspath(chip_smoke.__file__))
    with open(os.path.join(repo, "logs", "ceiling_f8l4_m17f2k19_hard.json")) as f:
        ceiling = json.load(f)
    with open(os.path.join(repo, "logs", "quality",
                           "psnr300_f8l4_m17f2k19_hard.json")) as f:
        early = json.load(f)
    with open(os.path.join(repo, "bench_psnr.py")) as f:
        warmup = int(re.search(r'"--warmup-steps", type=int, default=(\d+)',
                               f.read()).group(1))
    point = ceiling["trajectory"][0]
    assert point["iters"] == chip_smoke.QUALITY_STEPS == 8192
    assert point["psnr"] == chip_smoke.JAX_QUALITY_PSNR == 34.894
    assert chip_smoke.QUALITY_PSNR_BAR == pytest.approx(34.394)
    extra = early["extra"]
    assert early["metric"] == "ngp_psnr_at_budget" and early["unit"] == "dB"
    assert chip_smoke.JAX_EARLY_PSNR == early["value"] == 30.34
    assert abs(np.mean(extra["per_view_psnr"]) - early["value"]) < 0.01
    assert chip_smoke.EARLY_STEPS == warmup + extra["iters"] == 256 + 3072
    for run in (ceiling, extra):
        assert (run["encoder"], run["fast_cap"], run["compact"]) == (
            "f8l4", 524288, "m=2^17,f=2")
    assert ceiling["scene"] == "synthetic-hard-512-ssaa2"
    cfg = chip_smoke.headline_cfg(ngp_synthetic_cfg, False, H=512, W=512,
                                  scene="hard", ssaa=2, n_val=4)
    try:
        pe = cfg.encoder.pos_encoder
        assert (pe.n_levels, pe.n_features_per_level) == (4, 8)
        assert (cfg.hashmap_fast_cap, cfg.compacted_batch,
                cfg.march_budget_factor) == (1 << 19, 1 << 17, 2)
        assert cfg.dataset.val.n_images == 4 and cfg.dataset.train.H == 512
        assert (cfg.dataset.train.scene, cfg.dataset.train.ssaa) == ("hard", 2)
    finally:
        cfg.clear()


def test_envelope_rows_name_every_archived_pallas_call():
    """Phase 20's kernel rows name every one of the 13 pallas_call sites of
    tools/archive/ (a call, not a comment: probe_tpu2.py:90 is one) and
    nothing else (probe_tpu.py:72 and probe_tpu2.py:93 run bodies of K1
    and of K2, so two rows name each), and the phase runs the port of
    every archived file that has one."""
    from pathlib import Path

    archive = Path(chip_smoke.__file__).resolve().parent / "tools" / "archive"
    sites = {f"tools/archive/{path.name}:{i}"
             for path in archive.glob("*.py")
             for i, line in enumerate(path.read_text().splitlines(), 1)
             if "pallas_call(" in line and not line.lstrip().startswith("#")}
    assert len(sites) == 13
    named = [s.split(" ")[0] for v in chip_smoke.ENVELOPE_SITES.values()
             for s in v]
    assert set(named) == sites
    assert len(named) == 15
    assert set(chip_smoke.ENVELOPE_PROBES) == {
        s.split("/")[-1].split(".")[0] for s in sites}


def test_envelope_bytes_of_the_timed_shapes():
    """The bounds phase 20 prints: K1 at probe_loop's 2^20 rows of 512 B
    from a 65,536-row table (every row read) is 4 MiB of indices + 32 MiB
    of rows + 512 MiB out, 171.5 us at 3.35 TB/s; K3 at probe_rmw's 2^21
    rows into 32,768 and K4 at probe_bwd_var's v2d count their inputs once
    and their output once, as kernel B's bound does: 0.3280 and 0.1011
    ms."""
    from jnerf_tpu_torch.tools.archive import common

    k1 = chip_smoke.work(common.gather_bytes(1 << 20, 512, 65536), 0,
                         chip_smoke.F32_FLOP_PER_S)
    assert k1["bytes"] == 574_619_648
    assert k1["bound_ms"] == pytest.approx(574_619_648 / 3.35e12 * 1e3)
    assert k1["bound_by"] == "bytes"
    k3 = common.scatter_bytes(1 << 21, 512, 32768)
    assert k3 == 4 * (1 << 21) + 512 * (1 << 21) + 512 * 32768 \
        == 1_098_907_648
    assert chip_smoke.work(k3, 0, chip_smoke.F32_FLOP_PER_S)["bound_ms"] \
        == pytest.approx(0.3280, abs=5e-5)
    from jnerf_tpu_torch.tools.archive import probe_bwd_var

    k4 = probe_bwd_var.k4_bytes(16, 1 << 18, 32768, 1, "v2d")
    assert chip_smoke.work(k4, 0, chip_smoke.F32_FLOP_PER_S)["bound_ms"] \
        == pytest.approx(0.1011, abs=5e-5)


def test_envelope_rows_carry_every_key_of_the_kernels_line():
    """Each of K1-K4's rows has every key the kernels line needs, its
    launches from the probes' run and its sites."""
    stats = dict(chip_smoke.work(1000, 0, chip_smoke.F32_FLOP_PER_S), ms=1.0,
                 plain_ms=2.0, library_ms=0.5, err=0.0, shape="s",
                 device_ms=0.9)
    env = {"checks": {k: stats for k in ("K1", "K2", "K3", "K4")},
           "totals": {"K1": 3, "K2": 4, "K3": 5, "K4": 6},
           "launches": {"probe_loop": {"K1": 3, "K2": 4, "K3": 5, "K4": 6}}}
    rows = chip_smoke.envelope_rows(env)
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}
    assert [r["launches"] for r in rows] == [3, 4, 5, 6]
    for r in rows:
        assert keys <= set(r) and r["route"] == "cuda"
        assert r["source"] == "jnerf_tpu_torch/csrc/envelope.cu"
        assert r["replaces"].startswith("tools/archive/probe_")

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

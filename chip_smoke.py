"""Drive the PyTorch port of jnerf-tpu once on an NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card, nvcc and the port's sources beside this file; exits
nonzero, printing no result, without them.  Phases, each of which raises
on failure:

1. the card: its name and power limit (nvidia-smi);
2. build the CUDA kernels from jnerf_tpu_torch/csrc (hash_encode.cu and
   fused_mlp.cu, in parallel), with ptxas' register and spill lines;
3. each kernel against its plain PyTorch twin on the card at the main
   path's shapes, with errors and times: the hash kernels F and B at 2^17
   uniform samples (f8l4 at a 2^19 level cap and f2l16 at 2^18; kernel F
   timed with the bf16 output the path uses, and checked to be its f32
   output rounded); the fused MLP kernels F-MLP and D-MLP at 2^17 rows (the
   training M) and 2^20 random rows (a render chunk's size), B-MLP at 2^17;
4. the slice: 48 training steps of the f8l4+m17f2k19 bench headline
   (Runner(device='cuda').train_range), with launch counts that show the
   main path went through both hash kernels, steps/s and peak memory;
   then one more step whose kept samples (positions and the f32 upstream
   gradient of the encoder) are captured, and kernels F and B checked and
   timed on them at both specs, kernel B also beside the scatter alone
   (index_put_ with accumulate=True);
5. the fused path: the same headline with cfg.use_pallas_mlp, 48 steps
   (B-MLP launched once a step), then its test split rendered
   (render_test), each image's PSNR, and the same images rendered with the
   plain MLP chain for comparison; kernel F must run in every render chunk
   and F-MLP in every fused one.  One chunk of test image 0 is captured
   (its 2^20 positions and the bf16 rows that reach F-MLP), and kernel F
   (both specs) and F-MLP are checked and timed on it;
6. one small training step on the card against the same step on the CPU
   (the plain twins, which the CPU tests hold against the JAX package),
   with the plain MLP chain and with the fused kernels;
7. hard-scene quality: the 512x512 ssaa-2 hard scene built on the card (16
   train images, 4 val views), the headline trained on it with the plain
   MLP for 8192 iterations (kernels F and B counted), its mean val PSNR
   read at 3328 iterations and held at 8192 to the JAX package's at the
   same iterations less 0.5 dB; then the field saved with save_ckpt, a
   fresh Runner built from the checkpoint, and val view 0 rendered again,
   which must equal the first render bit for bit;
8. the user's entry point: a blender-format scene written by the port's
   make_synthetic_scene (24 train, 2 val, 4 test images of 256x256) and a
   config whose _base_ is projects/ngp/configs/ngp_base.py (full width:
   16 levels x 2 features, 2^19-entry hash levels, compacted batch 2^16),
   run through `python -m jnerf_tpu_torch.tools.run_net` (its main, in this
   process, so the launch counters read what it ran): --task train for
   4352 steps (a validation render at 4096, then params.pkl and the test
   set) and --task test from the checkpoint, with the linear hash; then
   the same with hash_indexing="xor" for 1024 steps, whose training and
   renders must go through kernels F and B in xor mode.  Each TOTAL TEST
   PSNR must clear the PSNR of predicting the background everywhere by 10
   dB, and the test task must read within 0.5 dB of the train task's.
   Then kernels F and B in xor mode are checked against their twins at the
   flagship xor table (6,098,120 entries) on 2^17 uniform samples and on
   two steps' kept samples of the trained xor field, and timed.

The last lines are the kernel table as JSON (each kernel with its bound:
the larger of its bytes over the memory rate and its operations over the
peak rate of their type, counted by the *_work functions below), the card
line, and {"ok": true, "device": {...}}.
"""

import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import textwrap
import time
from pathlib import Path

N_SAMPLES = 1 << 17  # the kept-sample cap M of the headline config
N_RENDER = 1 << 20   # model rows of one render chunk: 4096 rays x 256 samples
HEADLINE_STEPS = 48
# Kernel F equals its twin but for a rare bf16 rounding flip of one corner
# product (~5e-4 at |table| ~ 0.1); kernel B sums in the atomics' order.
FWD_ATOL = 1e-3
BWD_RTOL_OF_MAX = 1e-5
# The fused MLP kernels and their twins round the same bf16 operands at the
# same points and differ only in f32 summation order: on an H100 the
# outputs and dx agreed within 4.8e-7 and the weight gradients (2^17-row
# sums, per-block partials against one matmul) within 6.9e-7 of their
# largest entry.  B-MLP sums on the tensor cores, whose last bits differ
# from the twin's k-by-k FMAs; it sums again, in the twin's order, the few
# sums that lie at a bf16 rounding midpoint or at zero, so it rounds and
# masks as the twin does (without that, dx was off by up to 0.11 on ~40
# of 2^17 rows: flipped ReLU masks).  Bounds a few times the sound error:
# a kernel that drops or changes one bf16 rounding (r1b in F-MLP; dr2,
# d_dout or dh in B-MLP) was off by 1.3e-2 or more on the outputs or dx,
# and fails them, as does B-MLP without its re-sum.
MLP_ATOL = 1e-5
MLP_WGRAD_RTOL_OF_MAX = 1e-5
# Fused vs plain chain render of the same field: the two forwards are the
# same function up to f32 summation order, so they differ only where a
# hidden activation flips by one bf16 ulp (2^-8 relative).  That moves a
# raw output by ~1e-3 and a pixel by a fraction of that after the sigmoid
# and the compositing; a few flips on one ray stay far below one 8-bit
# colour level (3.9e-3).  Bounds: max |diff| 1e-2, mean |diff| 1e-4.
RENDER_MAX_DIFF = 1e-2
RENDER_MEAN_DIFF = 1e-4
# Hard-scene quality: the bar is the JAX package's mean val PSNR of the
# headline after 8192 iterations on the same scene and views
# (logs/ceiling_f8l4_m17f2k19_hard.json, trajectory[0]: 34.894 dB) less 0.5
# dB, as the port draws other random numbers than jax.random.  The reading
# at 3328 iterations (logs/quality/psnr300_f8l4_m17f2k19_hard.json: 256
# warm-up steps and 3072 more, 30.34 dB) is printed, not held: there the
# field is in its steepest climb, and the port's PSNR spans 26.368-35.374
# dB over seeds 42-47 on an H100 (logs/torch/eval3328/), far wider than
# the 0.5 dB allowance (PERF.md §6).
QUALITY_STEPS = 8192
JAX_QUALITY_PSNR = 34.894
QUALITY_PSNR_BAR = JAX_QUALITY_PSNR - 0.5
EARLY_STEPS = 256 + 3072
JAX_EARLY_PSNR = 30.34
# Phase 8: the CLI on a blender-format scene at the flagship width.
CLI_STEPS = 4096 + 256   # one validation render at 4096
XOR_STEPS = 1024
CLI_HW = 256
CLI_PSNR_OVER_BG = 10.0  # dB over predicting the background everywhere
CLI_TEST_RETEST = 0.5    # dB between the train task's test and --task test
XOR_N_ENTRIES = 6_098_120

# Peak rates of one H100 SXM (NVIDIA's data sheet, dense, at 700 W).
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12  # tensor cores
F32_FLOP_PER_S = 67e12    # outside the tensor cores
MLP_WEIGHT_BYTES = 9408 * 4  # the five f32 weights (or their gradients)


def work(nbytes: int, flops: int, flop_rate: float) -> dict:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over their peak rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flop_rate
    return {"bytes": nbytes, "flops": flops,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _hash_flops(n: int, n_levels: int, n_features: int) -> int:
    # A (sample, level): 8 f32 ops an axis for the cell and its corner
    # factors; a corner: 2 multiplies for its weight, then a multiply and
    # an add a feature.
    return n * n_levels * (24 + 8 * (2 + 2 * n_features))


def hash_fwd_work(n, n_levels, n_features, rows_read, out_bytes=4) -> dict:
    """Kernel F: pos [n, 3] and the table rows it reads (rows_read of 4F
    bytes, each read once) in, [n, F*L] out at out_bytes a value (4 f32,
    2 bf16)."""
    nbytes = (12 * n + 4 * n_features * rows_read
              + out_bytes * n_features * n_levels * n)
    return work(nbytes, _hash_flops(n, n_levels, n_features), F32_FLOP_PER_S)


def hash_bwd_work(n, n_levels, n_features, n_entries) -> dict:
    """Kernel B: pos [n, 3] and g [n, F*L] f32 in, the whole gradient
    [n_entries, F] f32 out."""
    nbytes = (12 * n + 4 * n_features * n_levels * n
              + 4 * n_features * n_entries)
    return work(nbytes, _hash_flops(n, n_levels, n_features), F32_FLOP_PER_S)


def mlp_fwd_work(n) -> dict:
    """F-MLP: x [n, 32] and d [n, 16] bf16 and the weights in, [n, 4] f32
    out (112 B a row); 9408 multiply-adds a row, bf16 operands."""
    return work(112 * n + MLP_WEIGHT_BYTES, 2 * 9408 * n, BF16_FLOP_PER_S)


def mlp_bwd_work(n) -> dict:
    """B-MLP: x, d, g [n, 4] f32 and the weights in, dx [n, 32] f32 and
    the weight gradients out (240 B a row); a row's multiply-adds: 9408
    for the recomputed forward, 8384 for the cotangents, 9408 for the
    weight gradients."""
    return work(240 * n + 2 * MLP_WEIGHT_BYTES, 2 * 27200 * n,
                BF16_FLOP_PER_S)


def density_work(n) -> dict:
    """D-MLP: x [n, 32] bf16, W0 and W1[:, 0] in, [n] f32 out; 2048 + 64
    multiply-adds a row."""
    return work(68 * n + 4 * (2048 + 64), 2 * 2112 * n, BF16_FLOP_PER_S)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=50, warmup_s=0.05) -> float:
    """Mean device time of fn() over `iters` launches, by CUDA events,
    after `warmup_s` seconds (at least 3 calls) of warm-up, so that a
    short kernel is not timed while the card's clocks are still rising."""
    import torch

    t0, calls = time.perf_counter(), 0
    while calls < 3 or time.perf_counter() - t0 < warmup_s:
        fn()
        torch.cuda.synchronize()
        calls += 1
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def time_pair(k_fn, p_fn):
    """Plain, kernel, kernel, plain: (kernel ms, plain ms, the four)."""
    p1, k1, k2, p2 = (cuda_ms(f) for f in (p_fn, k_fn, k_fn, p_fn))
    return (k1 + k2) / 2, (p1 + p2) / 2, (k1, k2, p1, p2)


def hash_specs(HashGridSpec):
    specs = {
        "f8l4@2^19": HashGridSpec(n_levels=4, n_features_per_level=8,
                                  log2_hashmap_size=19, max_level_size=1 << 19),
        "f2l16@2^18": HashGridSpec(n_levels=16, n_features_per_level=2,
                                   log2_hashmap_size=19, max_level_size=1 << 18),
    }
    assert specs["f8l4@2^19"].level_sizes == (4096, 524288, 524288, 524288)
    assert specs["f8l4@2^19"].n_entries == 1_576_960
    assert specs["f2l16@2^18"].n_entries == 3_214_536
    return specs


def corner_entries(torch, hash_nbr, spec, pos):
    """The (sample, level, corner) entries [L * 8 * N] and the weights
    [L * 8 * N], from the twins' own index and weight arithmetic."""
    consts = hash_nbr.level_consts(spec)
    idx, wts = [], []
    for lvl in range(spec.n_levels):
        e0, X = hash_nbr._cell(consts, lvl, pos)
        for c in range(8):
            idx.append(hash_nbr._corner_entry(consts, lvl, e0, c))
            wts.append(hash_nbr._corner_weight(X, c))
    return torch.cat(idx), torch.cat(wts)


def check_hash_fwd(torch, hash_nbr, name, spec, pos):
    """Kernel F against its twin on one spec and one set of positions
    pos [N, 3], with a random table: e0 mismatches and the error of the f32
    output, then the bf16 output (the encoder's compute dtype on the path),
    which must be the f32 output rounded, bit for bit.  Times the bf16
    kernel against the twin followed by the cast, and the f32 kernel once.
    The bound counts each table row the samples read once (torch.unique)."""
    dev = pos.device
    L, F = spec.n_levels, spec.n_features_per_level
    n = pos.shape[0]
    bf16 = torch.bfloat16
    gen = torch.Generator(dev).manual_seed(1)
    table = torch.randn((spec.n_entries, F), generator=gen, device=dev) * 0.1
    e0k = torch.zeros((n, L), dtype=torch.int32, device=dev)
    e0p = torch.zeros_like(e0k)
    fk = hash_nbr.encode_fwd(spec, table, pos, e0_out=e0k)
    bk = hash_nbr.encode_fwd(spec, table, pos, out_dtype=bf16)
    fp = hash_nbr.hash_encode_plain(spec, table, pos, e0_out=e0p)
    torch.cuda.synchronize()
    e0_bad = int((e0k != e0p).sum())
    f_err = float((fk - fp).abs().max())
    rounded = torch.equal(bk, fk.to(bf16))
    print(f"kernel F [{name}]: e0 mismatches {e0_bad} of {n * L}, max abs err "
          f"{f_err:.3e} (tolerance abs {FWD_ATOL:g}, e0 0); bf16 output is the "
          f"f32 output rounded: {rounded}", flush=True)
    if e0_bad or not f_err <= FWD_ATOL or not rounded:
        raise SystemExit(f"kernel F disagrees with its plain twin at {name}")
    del e0k, e0p, fk, bk, fp
    ms, plain_ms, (k1, k2, p1, p2) = time_pair(
        lambda: hash_nbr.encode_fwd(spec, table, pos, out_dtype=bf16),
        lambda: hash_nbr.hash_encode_plain(spec, table, pos).to(bf16))
    f32_ms = cuda_ms(lambda: hash_nbr.encode_fwd(spec, table, pos))
    rows = int(torch.unique(corner_entries(torch, hash_nbr, spec, pos)[0])
               .numel())
    out = dict(hash_fwd_work(n, L, F, rows, out_bytes=2), err=f_err, ms=ms,
               plain_ms=plain_ms, f32_ms=f32_ms, library_ms=None)
    print(f"time fwd [{name}], N={n}: kernel (bf16 out) {ms:.4f} ms ({k1:.4f}, "
          f"{k2:.4f}), plain {plain_ms:.4f} ms ({p1:.4f}, {p2:.4f}); f32 out "
          f"{f32_ms:.4f} ms; bound {out['bound_ms']:.4f} ms ({rows} table rows "
          f"read)", flush=True)
    return out


def check_hash(torch, hash_nbr, name, spec, pos, g):
    """Kernels F and B against their twins on one spec and one set of
    samples (positions pos [N, 3], f32 upstream gradient g [N, F*L]):
    kernel F as check_hash_fwd; kernel B's error and time, and the time of
    the scatter alone (index_put_ with accumulate=True of the weighted
    contributions, computed outside the timed region)."""
    dev = pos.device
    L, F = spec.n_levels, spec.n_features_per_level
    n = pos.shape[0]
    out = {"fwd": check_hash_fwd(torch, hash_nbr, name, spec, pos)}
    bk = hash_nbr.grad_table(spec, pos, g)
    bp = hash_nbr.grad_table_plain(spec, pos, g)
    idx, wts = corner_entries(torch, hash_nbr, spec, pos)
    vals = (wts[:, None] * g.reshape(n, F, L).permute(2, 0, 1)
            .repeat_interleave(8, dim=0).reshape(-1, F))
    torch.cuda.synchronize()
    b_err = float((bk - bp).abs().max())
    b_max = float(bp.abs().max())
    print(f"kernel B [{name}]: max abs err {b_err:.3e}, rel to max "
          f"{b_err / b_max:.3e} (tolerance {BWD_RTOL_OF_MAX:g} of max |ref| = "
          f"{b_max:.4g})", flush=True)
    if not b_err <= BWD_RTOL_OF_MAX * b_max:
        raise SystemExit(f"kernel B disagrees with its plain twin at {name}")

    def scatter():
        acc = torch.zeros((spec.n_entries, F), dtype=torch.float32, device=dev)
        return acc.index_put_((idx,), vals, accumulate=True)

    lib_err = float((scatter() - bp).abs().max())
    ms, plain_ms, (k1, k2, p1, p2) = time_pair(
        lambda: hash_nbr.grad_table(spec, pos, g),
        lambda: hash_nbr.grad_table_plain(spec, pos, g))
    print(f"time bwd [{name}], N={n}: kernel {ms:.4f} ms ({k1:.4f}, "
          f"{k2:.4f}), plain {plain_ms:.4f} ms ({p1:.4f}, {p2:.4f})",
          flush=True)
    lib_ms = (cuda_ms(scatter) + cuda_ms(scatter)) / 2
    out["bwd"] = dict(hash_bwd_work(n, L, F, spec.n_entries), err=b_err, ms=ms,
                      plain_ms=plain_ms, library_ms=lib_ms)
    print(f"time bwd [{name}]: the scatter alone "
          f"(index_put_ accumulate) {lib_ms:.4f} ms, max abs err "
          f"{lib_err:.3e}; bound {out['bwd']['bound_ms']:.4f} ms "
          f"({out['bwd']['bytes']} B)", flush=True)
    del idx, wts, vals
    return out


def uniform_samples(torch, spec, seed=0):
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(seed)
    pos = torch.rand((N_SAMPLES, 3), generator=gen, device=dev)
    g = torch.randn((N_SAMPLES, spec.n_features_per_level * spec.n_levels),
                    generator=gen, device=dev)
    return pos, g


def mlp_weights(torch, gen):
    """Kaiming-uniform weights, as the port's init draws them."""
    from jnerf_tpu_torch.ops.fused_mlp import WEIGHT_SHAPES

    return [(torch.rand(shp, generator=gen, device="cuda") * 2 - 1)
            * math.sqrt(6.0 / shp[0]) for shp in WEIGHT_SHAPES]


def mlp_rows(torch, gen, n):
    """bf16 feature rows ~U(-1, 1), as the encoders feed them on the
    path, and an upstream gradient ~N(0, 1)."""
    x = (torch.rand((n, 32), generator=gen, device="cuda") * 2 - 1).bfloat16()
    d = (torch.rand((n, 16), generator=gen, device="cuda") * 2 - 1).bfloat16()
    return x, d, torch.randn((n, 4), generator=gen, device="cuda")


def check_fmlp_rows(torch, fused_mlp, name, ws, x, d):
    """F-MLP against its twin on rows x [N, 32], d [N, 16] (bf16): max abs
    error within MLP_ATOL and two runs equal bit for bit, then the times of
    both and the bound."""
    n = x.shape[0]
    k1 = fused_mlp.fused_mlp_fwd(ws, x, d)
    k2 = fused_mlp.fused_mlp_fwd(ws, x, d)
    ref = fused_mlp.fused_ngp_mlp_plain(ws, x, d)
    torch.cuda.synchronize()
    err, same = float((k1 - ref).abs().max()), torch.equal(k1, k2)
    print(f"kernel F-MLP [{name}], N={n}: max abs err {err:.3e} (tolerance "
          f"{MLP_ATOL:g}); two runs bitwise equal: {same}", flush=True)
    if not (err <= MLP_ATOL and same):
        raise SystemExit(f"kernel F-MLP disagrees with its plain twin at {name}")
    del k1, k2, ref
    ms, plain_ms, four = time_pair(
        lambda: fused_mlp.fused_mlp_fwd(ws, x, d),
        lambda: fused_mlp.fused_ngp_mlp_plain(ws, x, d))
    print(f"time mlp fwd [{name}], N={n}: kernel {ms:.4f} ms ({four[0]:.4f}, "
          f"{four[1]:.4f}), plain {plain_ms:.4f} ms ({four[2]:.4f}, "
          f"{four[3]:.4f})", flush=True)
    return dict(mlp_fwd_work(n), err=err, ms=ms, plain_ms=plain_ms,
                library_ms=None)


def check_mlp_kernels(torch, fused_mlp):
    """Phase 3, fused MLP: F-MLP and D-MLP at the training M and at one
    render chunk, B-MLP at the training M, against their twins."""
    gen = torch.Generator("cuda").manual_seed(0)
    ws = mlp_weights(torch, gen)
    stats = {"fwd": {"err": 0.0}, "bwd": {"err": 0.0}, "den": {"err": 0.0}}
    for n in (N_SAMPLES, N_RENDER):
        x, d, g = mlp_rows(torch, gen, n)
        stats["fwd"][n] = check_fmlp_rows(torch, fused_mlp, "random rows", ws,
                                          x, d)
        stats["fwd"]["err"] = max(stats["fwd"]["err"], stats["fwd"][n]["err"])
        dk = fused_mlp.fused_density_mlp(ws[0], ws[1], x)
        dp = fused_mlp.fused_density_mlp_plain(ws[0], ws[1], x)
        torch.cuda.synchronize()
        errs = {"den": float((dk - dp).abs().max())}
        runs = {"den": (lambda: fused_mlp.fused_density_mlp(ws[0], ws[1], x),
                        lambda: fused_mlp.fused_density_mlp_plain(
                            ws[0], ws[1], x))}
        if n == N_SAMPLES:
            (bk, dxk), (bk2, dxk2) = (fused_mlp.fused_mlp_bwd(ws, x, d, g)
                                      for _ in range(2))
            bp, dxp = fused_mlp.fused_ngp_mlp_bwd_plain(ws, x, d, g)
            torch.cuda.synchronize()
            dx_err = float((dxk - dxp).abs().max())
            rel = [float((a - b).abs().max()) / float(b.abs().max())
                   for a, b in zip(bk, bp)]
            same = torch.equal(dxk, dxk2) and all(
                torch.equal(a, b) for a, b in zip(bk, bk2))
            print(f"kernel B-MLP, N={n}: dx max abs err {dx_err:.3e} "
                  f"(tolerance {MLP_ATOL:g}); weight grads max err rel to "
                  f"max {', '.join(f'{r:.3e}' for r in rel)} (tolerance "
                  f"{MLP_WGRAD_RTOL_OF_MAX:g}); two runs bitwise equal: "
                  f"{same}", flush=True)
            if not (dx_err <= MLP_ATOL
                    and all(r <= MLP_WGRAD_RTOL_OF_MAX for r in rel)
                    and same):
                raise SystemExit("kernel B-MLP disagrees with its plain twin")
            errs["bwd"] = max([dx_err] + [float((a - b).abs().max())
                                          for a, b in zip(bk, bp)])
            runs["bwd"] = (lambda: fused_mlp.fused_mlp_bwd(ws, x, d, g),
                           lambda: fused_mlp.fused_ngp_mlp_bwd_plain(
                               ws, x, d, g))
        print(f"kernel D-MLP, N={n}: max abs err {errs['den']:.3e} "
              f"(tolerance {MLP_ATOL:g})", flush=True)
        if not errs["den"] <= MLP_ATOL:
            raise SystemExit("kernel D-MLP disagrees with its plain twin")
        for kern, (k_fn, p_fn) in runs.items():
            ms, plain_ms, four = time_pair(k_fn, p_fn)
            print(f"time mlp {kern}, N={n}: kernel {ms:.4f} ms ({four[0]:.4f}, "
                  f"{four[1]:.4f}), plain {plain_ms:.4f} ms ({four[2]:.4f}, "
                  f"{four[3]:.4f})", flush=True)
            stats[kern][n] = dict(
                {"bwd": mlp_bwd_work, "den": density_work}[kern](n), ms=ms,
                plain_ms=plain_ms)
            stats[kern]["err"] = max(stats[kern]["err"], errs[kern])
        del x, d, g, dk, dp
    return stats


def headline_cfg(ngp_synthetic_cfg, pallas_mlp, **scene):
    cfg = ngp_synthetic_cfg(hash_levels=4, hash_features=8, **scene)
    cfg.compacted_batch = 1 << 17
    cfg.march_budget_factor = 2
    cfg.hashmap_fast_cap = 1 << 19
    cfg.use_pallas_mlp = pallas_mlp
    return cfg


def train_windows(torch, runner, steps):
    """Train `steps` steps in 16-step windows; returns (losses, window
    seconds, total seconds)."""
    losses, window_s = [], []
    t_all = time.perf_counter()
    for w in range(steps // 16):
        t_w = time.perf_counter()
        loss = runner.train_range(16 * w, 16 * (w + 1))
        losses.append(float(loss))  # waits for the window's last step
        window_s.append(time.perf_counter() - t_w)
        print(f"  window {w}: steps {16 * w}-{16 * w + 15}, loss "
              f"{losses[-1]:.6f}, {window_s[-1]:.4f} s, next shape "
              f"{runner.sampler.n_rays_per_batch} x "
              f"{runner.sampler.n_samples_per_ray}", flush=True)
    torch.cuda.synchronize()
    return losses, window_s, time.perf_counter() - t_all


def check_training(torch, runner, losses):
    finite = all(math.isfinite(x) for x in losses) and all(
        bool(torch.isfinite(p).all()) for p in runner.model.parameters())
    if not finite:
        raise SystemExit(f"non-finite loss or parameters: losses {losses}")
    if not losses[-1] < losses[0]:
        raise SystemExit(f"the loss did not fall over {HEADLINE_STEPS} steps: "
                         f"{losses}")


def run_fused_path(torch, Runner, ngp_synthetic_cfg, fused_mlp, hash_nbr,
                   mse2psnr):
    """Phase 5: the headline with the fused MLP kernels, then its test
    images rendered with them and with the plain chain."""
    headline_cfg(ngp_synthetic_cfg, True)
    runner = Runner(device="cuda")
    if not runner.model._fused_ok:
        raise SystemExit("cfg.use_pallas_mlp did not open the fused gate")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fused_mlp.fused_mlp_fwd.launches = 0
    fused_mlp.fused_mlp_bwd.launches = 0
    fused_mlp.fused_density_mlp.launches = 0
    hash_nbr.encode_fwd.launches = 0
    hash_nbr.grad_table.launches = 0
    losses, window_s, total_s = train_windows(torch, runner, HEADLINE_STEPS)
    train_launches = {"fwd": fused_mlp.fused_mlp_fwd.launches,
                      "bwd": fused_mlp.fused_mlp_bwd.launches,
                      "hash_fwd": hash_nbr.encode_fwd.launches,
                      "hash_bwd": hash_nbr.grad_table.launches}
    peak = torch.cuda.max_memory_allocated()
    print(f"fused headline: {HEADLINE_STEPS} steps in {total_s:.4f} s = "
          f"{HEADLINE_STEPS / total_s:.3f} steps/s (windows 1-2: "
          f"{32 / sum(window_s[1:]):.3f} steps/s), peak memory "
          f"{peak / 2**20:.1f} MiB, launches F-MLP {train_launches['fwd']} "
          f"B-MLP {train_launches['bwd']} F {train_launches['hash_fwd']} B "
          f"{train_launches['hash_bwd']}, on {card_line()}", flush=True)
    check_training(torch, runner, losses)
    if train_launches["bwd"] != HEADLINE_STEPS \
            or train_launches["fwd"] < HEADLINE_STEPS \
            or train_launches["hash_fwd"] <= 0 \
            or train_launches["hash_bwd"] <= 0:
        raise SystemExit(f"the fused kernels did not run once a step: "
                         f"{train_launches}")

    from jnerf_tpu_torch.utils.registry import DATASETS, build_from_cfg

    runner.dataset["test"] = build_from_cfg(runner.cfg.dataset.test, DATASETS,
                                            device="cuda")
    n_img = runner.dataset["test"].n_images
    u = torch.rand((runner.render_chunk_rays,), device="cuda",
                   generator=torch.Generator("cuda").manual_seed(0))
    chunks = n_img * -(-runner.H * runner.W // runner.render_chunk_rays)
    renders = {}
    for fused in (True, False):
        runner.model._fused_ok = fused
        fused_mlp.fused_mlp_fwd.launches = 0
        hash_nbr.encode_fwd.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mses = runner.render_test(save_img=False, u=u)
        torch.cuda.synchronize()
        per_img = (time.perf_counter() - t0) / n_img
        launches = (fused_mlp.fused_mlp_fwd.launches,
                    hash_nbr.encode_fwd.launches)
        imgs = [runner.render_img("test", img_id=i, u=u)[0]
                for i in range(n_img)]
        renders[fused] = (imgs, launches)
        print(f"render_test ({'F-MLP' if fused else 'plain chain'}): "
              f"{n_img} images of {runner.W}x{runner.H}, "
              f"{per_img * 1e3:.3f} ms per image, PSNR "
              f"{', '.join(f'{float(mse2psnr(m)):.3f}' for m in mses)} dB, "
              f"launches F-MLP {launches[0]}, kernel F {launches[1]} "
              f"({chunks} chunks)", flush=True)
    runner.model._fused_ok = True
    (f_mlp, f_hash), (p_mlp, p_hash) = renders[True][1], renders[False][1]
    if f_mlp < chunks or f_hash < chunks or p_hash < chunks or p_mlp != 0:
        raise SystemExit(f"the render did not launch kernel F in every chunk "
                         f"and F-MLP in every fused one: {renders[True][1]} "
                         f"fused, {renders[False][1]} plain, {chunks} chunks")
    diffs = [abs(a - b) for a, b in zip(renders[True][0], renders[False][0])]
    max_diff = max(float(x.max()) for x in diffs)
    mean_diff = sum(float(x.mean()) for x in diffs) / len(diffs)
    print(f"render fused vs plain chain: max |diff| {max_diff:.3e}, mean "
          f"|diff| {mean_diff:.3e} (bounds {RENDER_MAX_DIFF:g}, "
          f"{RENDER_MEAN_DIFF:g})", flush=True)
    if not (max_diff <= RENDER_MAX_DIFF and mean_diff <= RENDER_MEAN_DIFF):
        raise SystemExit("the fused render disagrees with the plain chain's")
    if not all(math.isfinite(float(x.sum())) for x in diffs):
        raise SystemExit("non-finite render")
    launches = dict(train_launches, fwd=train_launches["fwd"] + f_mlp,
                    render_fwd=f_mlp, render_hash_fwd=f_hash,
                    den=dmlp_launches(fused_mlp, "the fused path"))
    return launches, capture_render_chunk(runner, fused_mlp, u)


def capture_render_chunk(runner, fused_mlp, u):
    """Render test image 0 with the model's forward and F-MLP wrapped, and
    return what reached them in its middle chunk (rays through the image's
    centre rows): the warped positions ``pos`` [4096 * 256, 3] and F-MLP's
    inputs ``ws`` (the five weights), ``x`` (bf16 [.., 32], kernel F's
    output) and ``d`` (bf16 [.., 16])."""
    want = -(-runner.H * runner.W // runner.render_chunk_rays) // 2
    got, calls = {}, {"fwd": 0, "mlp": 0}
    model, orig_mlp = runner.model, fused_mlp.fused_ngp_mlp
    orig_fwd = model.forward

    def forward(pos, dirs):
        if calls["fwd"] == want:
            got["pos"] = pos.detach().contiguous().clone()
        calls["fwd"] += 1
        return orig_fwd(pos, dirs)

    def mlp(weights, pos_feat, dir_feat):
        if calls["mlp"] == want:
            got.update(ws=[w.detach().clone() for w in weights],
                       x=pos_feat.detach().clone(), d=dir_feat.detach().clone())
        calls["mlp"] += 1
        return orig_mlp(weights, pos_feat, dir_feat)

    model.forward = forward
    fused_mlp.fused_ngp_mlp = mlp
    try:
        runner.render_img("test", img_id=0, u=u)
    finally:
        del model.forward
        fused_mlp.fused_ngp_mlp = orig_mlp
    if "x" not in got:
        raise SystemExit("the render did not reach F-MLP")
    return got


def dmlp_launches(fused_mlp, path):
    """D-MLP's launch count since its reset before `path`, which must be 0:
    neither package calls it on a path."""
    n = fused_mlp.fused_density_mlp.launches
    if n != 0:
        raise SystemExit(f"D-MLP launched {n} times on {path}")
    return n


def run_headline(torch, Runner, ngp_synthetic_cfg, hash_nbr, fused_mlp):
    """Phase 4: the slice, with the kernels' launch counts from its run."""
    headline_cfg(ngp_synthetic_cfg, False)
    t0 = time.perf_counter()
    runner = Runner(device="cuda")
    torch.cuda.synchronize()
    print(f"headline f8l4+m17f2k19: setup {time.perf_counter() - t0:.3f} s, "
          f"table {runner.model.pos_encoder.spec.level_sizes}, "
          f"{runner.sampler.n_rays_per_batch} rays x "
          f"{runner.sampler.n_samples_per_ray} samples, cap "
          f"{runner.sampler.compacted_batch}", flush=True)

    torch.cuda.reset_peak_memory_stats()
    hash_nbr.encode_fwd.launches = 0
    hash_nbr.grad_table.launches = 0
    fused_mlp.fused_density_mlp.launches = 0
    losses, window_s, total_s = train_windows(torch, runner, HEADLINE_STEPS)
    launches = {"fwd": hash_nbr.encode_fwd.launches,
                "bwd": hash_nbr.grad_table.launches,
                "den": dmlp_launches(fused_mlp, "the headline")}
    peak = torch.cuda.max_memory_allocated()
    print(f"headline: {HEADLINE_STEPS} steps in {total_s:.4f} s = "
          f"{HEADLINE_STEPS / total_s:.3f} steps/s (incl. 3 grid refreshes; "
          f"windows 1-2: {32 / sum(window_s[1:]):.3f} steps/s), peak memory "
          f"{peak / 2**20:.1f} MiB, launches F {launches['fwd']} B "
          f"{launches['bwd']}, on {card_line()}", flush=True)
    check_training(torch, runner, losses)
    if launches["fwd"] <= 0 or launches["bwd"] <= 0:
        raise SystemExit(f"a kernel was not launched on the main path: "
                         f"{launches}")
    pos, g = capture_steps(runner, hash_nbr.HashEncode, HEADLINE_STEPS, 1)
    empty = g.abs().sum(dim=1) == 0
    print(f"captured step {HEADLINE_STEPS}: {pos.shape[0]} sample slots, "
          f"{int(empty.sum())} with a zero gradient row (empty slots), "
          f"{torch.unique(pos, dim=0).shape[0]} distinct positions",
          flush=True)
    return launches, (pos, g)


def check_small_step(torch, Runner, ngp_synthetic_cfg, fused_mlp, pallas_mlp):
    """Phase 6: one tiny step on the card against the same step on the CPU
    (same params, grid state and draws): loss rtol 1e-3, and per gradient
    tensor mean |diff| <= 1e-3 of its largest entry (bf16 rounding flips,
    as in tests/test_torch_step.py).  With ``pallas_mlp`` the cap is 8192
    kept samples of 256 x 128, so that the step runs the fused kernels on
    the card (and their twins on the CPU).  The largest single difference is
    printed, not held to a bound: rays are computed on each device, and a
    sample that lies within an ulp of a cell border may take the
    neighbouring hash entry on one of them."""
    cfg = ngp_synthetic_cfg(n_images=4, H=32, W=32, n_rays_per_batch=256,
                            target_batch_size=1 << 12, grid_size=32,
                            nerf_steps=128, hash_levels=4, hash_features=8,
                            log2_hashmap_size=13)
    cfg.compacted_batch = 1024
    cfg.march_budget_factor = 2
    if pallas_mlp:
        cfg.update(use_pallas_mlp=True, compacted_batch=8192,
                   target_batch_size=1 << 14)
    gpu = Runner(device="cuda")
    if gpu.model._fused_ok != pallas_mlp:
        raise SystemExit("the fused gate does not follow cfg.use_pallas_mlp")
    gpu.train_range(0, 16)
    cpu = Runner(device="cpu")
    cpu.model.load_state_dict({k: v.cpu() for k, v in
                               gpu.model.state_dict().items()})
    cpu.sampler.load_state_dict(gpu.sampler.state_dict())
    n_rays, n_samples = gpu.sampler.n_rays_per_batch, gpu.sampler.n_samples_per_ray
    ds = gpu.dataset["train"]
    gen = torch.Generator().manual_seed(1)
    idx = torch.randint(0, ds.n_images * ds.H * ds.W, (n_rays,), generator=gen)
    bg = torch.rand((n_rays, 3), generator=gen)
    u = torch.rand((n_rays,), generator=gen)
    out = {}
    fused_mlp.fused_mlp_fwd.launches = fused_mlp.fused_mlp_bwd.launches = 0
    for name, r in (("cuda", gpu), ("cpu", cpu)):
        dev = r.device
        r.model.zero_grad(set_to_none=True)
        total, main, _ = r.forward_loss(n_rays, n_samples, idx=idx.to(dev),
                                        bg=bg.to(dev), u=u.to(dev))
        total.backward()
        out[name] = (float(main.detach()), {k: p.grad.cpu() for k, p in
                                   r.model.named_parameters()})
    l_gpu, l_cpu = out["cuda"][0], out["cpu"][0]
    worst = []
    for k, ref in out["cpu"][1].items():
        diff = (out["cuda"][1][k] - ref).abs()
        scale = float(ref.abs().max())
        worst.append((k, float(diff.max()) / scale, float(diff.mean()) / scale))
    fused = (fused_mlp.fused_mlp_fwd.launches, fused_mlp.fused_mlp_bwd.launches)
    if fused != ((1, 1) if pallas_mlp else (0, 0)):
        raise SystemExit(f"fused MLP launches {fused} in the small step")
    print(f"small step card vs CPU ({'fused' if pallas_mlp else 'plain'} "
          f"MLP, {n_rays} x {n_samples}): loss {l_gpu:.6f} vs {l_cpu:.6f}; grads "
          + ", ".join(f"{k} max {a:.2e} mean {b:.2e}" for k, a, b in worst),
          flush=True)
    if not abs(l_gpu - l_cpu) <= 1e-3 * abs(l_cpu):
        raise SystemExit("the card's step loss disagrees with the CPU's")
    if any(b > 1e-3 for _, _, b in worst):
        raise SystemExit("the card's step gradients disagree with the CPU's")


def run_quality(torch, Runner, ngp_synthetic_cfg, hash_nbr, fused_mlp,
                img2mse, mse2psnr):
    """Phase 7: the headline on the hard scene for QUALITY_STEPS steps, its
    val PSNR at EARLY_STEPS and at QUALITY_STEPS, and a checkpoint round
    trip; returns the launch counts of its training run."""
    import numpy as np
    from jnerf_tpu_torch.utils.registry import DATASETS, build_from_cfg

    t_phase = time.perf_counter()
    cfg = headline_cfg(ngp_synthetic_cfg, False, H=512, W=512, scene="hard",
                       ssaa=2, n_val=4, tot_train_steps=QUALITY_STEPS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sizes = [build_from_cfg(cfg.dataset[split], DATASETS,
                            device="cuda").n_images
             for split in ("train", "val")]
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    print(f"hard scene: 512x512 ssaa 2, {sizes[0]} train + {sizes[1]} val "
          f"images built on the card in {build_s:.3f} s, on {card_line()}",
          flush=True)
    runner = Runner(device="cuda")
    u = torch.rand((runner.render_chunk_rays,), device="cuda",
                   generator=torch.Generator("cuda").manual_seed(0))

    def val_psnr():
        renders, psnrs = [], []
        for i in range(runner.dataset["val"].n_images):
            img, _alpha, tar = runner.render_img("val", img_id=i, u=u)
            renders.append(img)
            psnrs.append(float(mse2psnr(img2mse(torch.from_numpy(img),
                                                torch.from_numpy(tar)))))
        return sum(psnrs) / len(psnrs), psnrs, renders

    hash_nbr.encode_fwd.launches = 0
    hash_nbr.grad_table.launches = 0
    fused_mlp.fused_density_mlp.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    runner.train_range(0, EARLY_STEPS)
    train_s = time.perf_counter() - t0
    early, early_views, _ = val_psnr()
    print(f"quality at {EARLY_STEPS} steps: val PSNR mean {early:.3f} dB, "
          f"per view {', '.join(f'{p:.3f}' for p in early_views)} (the JAX "
          f"package's {JAX_EARLY_PSNR} on a TPU; not held, see "
          f"QUALITY_STEPS)", flush=True)
    t0 = time.perf_counter()
    loss = float(runner.train_range(EARLY_STEPS, QUALITY_STEPS))
    train_s += time.perf_counter() - t0
    launches = {"fwd": hash_nbr.encode_fwd.launches,
                "bwd": hash_nbr.grad_table.launches,
                "den": dmlp_launches(fused_mlp, "the quality run")}
    if launches["fwd"] <= 0 or launches["bwd"] <= 0 or not math.isfinite(loss):
        raise SystemExit(f"quality run: launches {launches}, loss {loss}")
    mean, psnrs, renders = val_psnr()
    print(f"quality: {QUALITY_STEPS} steps in {train_s:.3f} s "
          f"({QUALITY_STEPS / train_s:.3f} steps/s), loss {loss:.6f}, "
          f"launches F {launches['fwd']} B {launches['bwd']}; val PSNR mean "
          f"{mean:.3f} dB, per view {', '.join(f'{p:.3f}' for p in psnrs)} "
          f"(bar {QUALITY_PSNR_BAR:.3f}: the JAX package's {JAX_QUALITY_PSNR} "
          f"less 0.5)", flush=True)
    if not mean >= QUALITY_PSNR_BAR:
        raise SystemExit(f"hard-scene PSNR {mean:.3f} dB is under "
                         f"{QUALITY_PSNR_BAR:.3f} dB")

    path = "work_dirs/chip_smoke/params.pkl"
    runner.save_ckpt(path)
    del runner
    cfg.update(load_ckpt=True, ckpt_path=path)
    again = Runner(device="cuda")
    img = again.render_img("val", img_id=0, u=u)[0]
    same = bool(np.array_equal(img, renders[0]))
    print(f"checkpoint {path}: reloaded at step {again.start}, val view 0 "
          f"rendered again bitwise equal: {same}", flush=True)
    if not (same and again.start == QUALITY_STEPS):
        raise SystemExit("the checkpoint did not reload the trained field")
    print(f"hard-scene quality phase: {time.perf_counter() - t_phase:.3f} s",
          flush=True)
    return launches


def bf16_ulps(torch, a, b) -> int:
    """Largest distance in bf16 ulps between two bf16 tensors (bit
    patterns mapped to a line on which adjacent values differ by 1)."""
    def line(x):
        bits = x.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)

    return int((line(a) - line(b)).abs().max())


def check_hash_xor(torch, hash_xor, hash_grid, name, spec, pos, g):
    """Kernels F and B in xor mode against their twins on one set of
    samples (pos [N, 3], f32 upstream gradient g [N, F*L]), with a random
    table: the bf16 forward within FWD_ATOL and one bf16 ulp of the twin
    (the JAX package's rounding), the f32 forward within FWD_ATOL, the
    table gradient (bf16 products, and f32) within BWD_RTOL_OF_MAX of its
    largest entry.  Times the bf16 kernels (the path's dtype) against their
    twins, and kernel B beside the scatter alone."""
    dev = pos.device
    L, F = spec.n_levels, spec.n_features_per_level
    n = pos.shape[0]
    bf16 = torch.bfloat16
    gen = torch.Generator(dev).manual_seed(2)
    table = torch.randn((spec.n_entries, F), generator=gen, device=dev) * 0.1
    fk = hash_xor.encode_xor_fwd(spec, table, pos, bf16)
    fp = hash_grid.hash_encode_xor_plain(spec, table, pos, bf16)
    fk32 = hash_xor.encode_xor_fwd(spec, table, pos)
    fp32 = hash_grid.hash_encode_xor_plain(spec, table, pos)
    torch.cuda.synchronize()
    f_err = float((fk.float() - fp.float()).abs().max())
    ulps = bf16_ulps(torch, fk, fp)
    f32_err = float((fk32 - fp32).abs().max())
    print(f"kernel F xor [{name}]: bf16 max abs err {f_err:.3e}, {ulps} ulp "
          f"(tolerance abs {FWD_ATOL:g}, 1 ulp); f32 max abs err "
          f"{f32_err:.3e}", flush=True)
    if not (f_err <= FWD_ATOL and ulps <= 1 and f32_err <= FWD_ATOL):
        raise SystemExit(f"kernel F (xor) disagrees with its twin at {name}")
    del fk, fp, fk32, fp32
    b_errs = {}
    for rnd in (True, False):
        bk = hash_xor.grad_table_xor(spec, pos, g, rnd)
        bp = hash_grid.grad_table_xor_plain(spec, pos, g, rnd)
        torch.cuda.synchronize()
        err, top = float((bk - bp).abs().max()), float(bp.abs().max())
        b_errs[rnd] = err
        print(f"kernel B xor [{name}] ({'bf16' if rnd else 'f32'} products): "
              f"max abs err {err:.3e}, rel to max {err / top:.3e} (tolerance "
              f"{BWD_RTOL_OF_MAX:g} of max |ref| = {top:.4g})", flush=True)
        if not err <= BWD_RTOL_OF_MAX * top:
            raise SystemExit(f"kernel B (xor) disagrees with its twin at {name}")
        del bk, bp
    ms, plain_ms, (k1, k2, p1, p2) = time_pair(
        lambda: hash_xor.encode_xor_fwd(spec, table, pos, bf16),
        lambda: hash_grid.hash_encode_xor_plain(spec, table, pos, bf16))
    idx, vals = hash_grid.xor_contributions(spec, pos, g, True)
    rows = int(torch.unique(idx).numel())
    fwd = dict(hash_fwd_work(n, L, F, rows, out_bytes=2), err=f_err, ulps=ulps,
               f32_err=f32_err, ms=ms, plain_ms=plain_ms, library_ms=None)
    print(f"time xor fwd [{name}], N={n}: kernel (bf16 out) {ms:.4f} ms "
          f"({k1:.4f}, {k2:.4f}), plain {plain_ms:.4f} ms ({p1:.4f}, "
          f"{p2:.4f}); bound {fwd['bound_ms']:.4f} ms ({rows} table rows "
          "read)", flush=True)

    def scatter():
        acc = torch.zeros((spec.n_entries, F), dtype=torch.float32, device=dev)
        return acc.index_put_((idx,), vals, accumulate=True)

    ms, plain_ms, (k1, k2, p1, p2) = time_pair(
        lambda: hash_xor.grad_table_xor(spec, pos, g, True),
        lambda: hash_grid.grad_table_xor_plain(spec, pos, g, True))
    lib_ms = (cuda_ms(scatter) + cuda_ms(scatter)) / 2
    bwd = dict(hash_bwd_work(n, L, F, spec.n_entries), err=max(b_errs.values()),
               ms=ms, plain_ms=plain_ms, library_ms=lib_ms)
    print(f"time xor bwd [{name}], N={n}: kernel {ms:.4f} ms ({k1:.4f}, "
          f"{k2:.4f}), plain {plain_ms:.4f} ms ({p1:.4f}, {p2:.4f}), the "
          f"scatter alone (index_put_ accumulate) {lib_ms:.4f} ms; bound "
          f"{bwd['bound_ms']:.4f} ms", flush=True)
    del idx, vals, table
    return {"fwd": fwd, "bwd": bwd}


def capture_steps(runner, fn_class, step, n_steps):
    """Train steps [step, step + n_steps) with ``fn_class``'s backward
    wrapped; returns the positions and the f32 upstream gradients that
    reached it, concatenated over the steps."""
    import torch

    got = []
    orig = fn_class.__dict__["backward"]

    def backward(ctx, g):
        got.append((ctx.saved_tensors[0].clone(),
                    g.float().contiguous().clone()))
        return orig.__func__(ctx, g)

    fn_class.backward = staticmethod(backward)
    try:
        runner.train_range(step, step + n_steps)
    finally:
        fn_class.backward = orig
    if len(got) != n_steps:
        raise SystemExit(f"{n_steps} steps reached the hash backward "
                         f"{len(got)} times")
    return (torch.cat([p for p, _ in got]).contiguous(),
            torch.cat([g for _, g in got]).contiguous())


def cli_config(path, scene, log_dir, steps, indexing):
    """A user's config: ngp_base.py with the data, log directory, step count
    and hash indexing overridden."""
    base = Path(__file__).resolve().parent / "projects/ngp/configs/ngp_base.py"
    Path(path).write_text(textwrap.dedent(f"""\
        _base_ = {str(base)!r}
        dataset_dir = {scene!r}
        dataset = dict(train=dict(root_dir=dataset_dir),
                       val=dict(root_dir=dataset_dir),
                       test=dict(root_dir=dataset_dir))
        log_dir = {log_dir!r}
        tot_train_steps = {steps}
        hash_indexing = {indexing!r}
    """))
    return path


def background_psnr(torch, read_image, mse2psnr, scene, n_test):
    """Mean over the test images of the PSNR of predicting the background
    (ngp_base's black) everywhere, from the targets as the runner composes
    them."""
    out = []
    for i in range(n_test):
        img = read_image(os.path.join(scene, "test", f"r_{i}.png"))
        target = img[..., :3] * img[..., 3:]
        out.append(float(mse2psnr(torch.tensor(float((target ** 2).mean())))))
    return sum(out) / len(out)


def run_cli(torch, run_net, hash_nbr, hash_xor, fused_mlp, mse2psnr):
    """Phase 8: the CLI's train and test tasks on a blender-format scene,
    linear and xor; returns (per-mode results, the xor run's runner)."""
    from jnerf_tpu_torch.dataset.dataset_util import read_image
    from jnerf_tpu_torch.dataset.synthetic import make_synthetic_scene
    from jnerf_tpu_torch.runner import Runner

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    counters = {"F": hash_nbr.encode_fwd, "B": hash_nbr.grad_table,
                "F xor": hash_xor.encode_xor_fwd,
                "B xor": hash_xor.grad_table_xor,
                "D-MLP": fused_mlp.fused_density_mlp}
    train_s = [0.0]
    orig_range = Runner.train_range

    def timed_range(self, *a, **k):
        t0 = time.perf_counter()
        out = orig_range(self, *a, **k)
        torch.cuda.synchronize()
        train_s[0] += time.perf_counter() - t0
        return out

    def counts():
        return {k: fn.launches for k, fn in counters.items()}

    def reset():
        for fn in counters.values():
            fn.launches = 0

    try:
        scene = os.path.join(tmp, "scene")
        t0 = time.perf_counter()
        make_synthetic_scene(scene, n_train=24, n_val=2, n_test=4, H=CLI_HW,
                             W=CLI_HW, device="cuda")
        bg = background_psnr(torch, read_image, mse2psnr, scene, 4)
        print(f"cli scene: 24 + 2 + 4 images of {CLI_HW}x{CLI_HW} written in "
              f"{time.perf_counter() - t0:.3f} s; background-only test PSNR "
              f"{bg:.3f} dB, on {card_line()}", flush=True)
        results, xor_runner = {}, None
        Runner.train_range = timed_range
        for mode, steps in (("linear_rows", CLI_STEPS), ("xor", XOR_STEPS)):
            logs = os.path.join(tmp, f"logs_{mode}")
            cfg = cli_config(os.path.join(tmp, f"cfg_{mode}.py"), scene, logs,
                             steps, mode)
            argv = ["--config-file", cfg, "--device", "cuda"]
            reset()
            train_s[0] = 0.0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            runner, psnr = run_net.main(argv + ["--task", "train"])
            task_s = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
            n_train = counts()
            reset()
            _, psnr_again = run_net.main(argv + ["--task", "test"])
            n_test = counts()
            spec = runner.model.pos_encoder.spec
            out = os.path.join(logs, runner.exp_name)
            pngs = [os.path.join(out, "test", f"{runner.exp_name}_{k}_{i}.png")
                    for i in range(4) for k in ("r", "gt")]
            if steps > runner.val_freq:
                pngs += [os.path.join(out, f"img{runner.val_freq}.png")]
            shapes = {read_image(p).shape for p in pngs}
            print(f"cli {mode}: {steps} steps, table {spec.n_entries} entries "
                  f"({len(spec.level_sizes)} levels, largest "
                  f"{max(spec.level_sizes)}); train task {task_s:.3f} s, "
                  f"steps {train_s[0]:.3f} s = {steps / train_s[0]:.3f} "
                  f"steps/s, peak memory {peak / 2**20:.1f} MiB; TOTAL TEST "
                  f"PSNR {psnr:.3f} dB (train task), {psnr_again:.3f} dB "
                  f"(--task test); launches train {n_train}, test {n_test}; "
                  f"{len(pngs)} PNGs decoded, shapes {sorted(shapes)}",
                  flush=True)
            if not os.path.isfile(os.path.join(out, "params.pkl")) \
                    or shapes - {(CLI_HW, CLI_HW, 3), (CLI_HW, CLI_HW, 4)}:
                raise SystemExit(f"cli {mode}: params.pkl or a PNG is missing "
                                 "or wrong")
            if not (psnr >= bg + CLI_PSNR_OVER_BG
                    and psnr_again >= bg + CLI_PSNR_OVER_BG
                    and abs(psnr_again - psnr) <= CLI_TEST_RETEST):
                raise SystemExit(f"cli {mode}: test PSNR {psnr:.3f} / "
                                 f"{psnr_again:.3f} dB against background "
                                 f"{bg:.3f} dB")
            used, unused = (("F xor", "B xor"), ("F", "B")) if mode == "xor" \
                else (("F", "B"), ("F xor", "B xor"))
            if n_train[used[1]] < steps or n_train[used[0]] < steps \
                    or n_test[used[0]] <= 0 or n_test[used[1]] != 0 \
                    or any(n_train[k] or n_test[k] for k in unused) \
                    or n_train["D-MLP"] or n_test["D-MLP"]:
                raise SystemExit(f"cli {mode}: the run did not go through its "
                                 f"kernels: train {n_train}, test {n_test}")
            results[mode] = dict(steps=steps, steps_per_s=steps / train_s[0],
                                 task_s=task_s, peak_mib=peak / 2**20,
                                 psnr=psnr, psnr_test_task=psnr_again,
                                 bg_psnr=bg, train_launches=n_train,
                                 test_launches=n_test)
            if mode == "xor":
                xor_runner = runner
            del runner
    finally:
        Runner.train_range = orig_range
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"cli phase: {time.perf_counter() - t_phase:.3f} s", flush=True)
    return results, xor_runner


def build_kernels(torch, cuda_lib):
    """Phase 2: one nvcc per source, started together."""
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    names = ("hash_encode", "fused_mlp")
    preludes = (cuda_lib.hash_prelude(), "")
    with ThreadPoolExecutor(len(names)) as pool:
        libs = list(pool.map(cuda_lib.build, names, preludes))
    cuda_lib.hash_encode_lib()
    cuda_lib.fused_mlp_lib()
    print(f"built {', '.join(lib.name for lib in libs)} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for lib in libs:
        for line in lib.with_suffix(".log").read_text().splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling",
                                       "Compile time")):
                print(f"  ptxas: {line.strip()}", flush=True)


def require_cuda():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs an NVIDIA GPU: "
                         "torch.cuda.is_available() is false")
    return torch


def kernel_row(name, source, replaces, launches, stats, shape, **extra):
    """One entry of the kernels line: stats holds the timed shape's
    ms, plain_ms, library_ms and work (bound_ms, bound_by, bytes, flops)."""
    row = {"name": name, "route": "cuda", "source": source,
           "replaces": replaces, "launches": launches}
    row.update({k: stats[k] for k in ("ms", "plain_ms", "bound_ms",
                                      "bound_by", "library_ms", "bytes",
                                      "flops")})
    row["shape"] = shape
    row.update(extra)
    return row


def main() -> int:
    t_start = time.perf_counter()
    torch = require_cuda()
    from jnerf_tpu_torch.models.losses import img2mse, mse2psnr
    from jnerf_tpu_torch.ops import (
        cuda_lib, fused_mlp, hash_grid, hash_nbr, hash_xor,
    )
    from jnerf_tpu_torch.ops.hash_grid import HashGridSpec
    from jnerf_tpu_torch.runner import Runner
    from jnerf_tpu_torch.tools import run_net
    from jnerf_tpu_torch.utils.bench_cfg import ngp_synthetic_cfg

    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    print(f"card: {card_line()}", flush=True)
    build_kernels(torch, cuda_lib)

    specs = hash_specs(HashGridSpec)
    hs = {}
    for name, spec in specs.items():
        hs["uniform " + name] = check_hash(torch, hash_nbr, "uniform " + name,
                                           spec, *uniform_samples(torch, spec))
    mlp = check_mlp_kernels(torch, fused_mlp)
    launches, (step_pos, step_g) = run_headline(
        torch, Runner, ngp_synthetic_cfg, hash_nbr, fused_mlp)
    # The step's own clustered samples at both specs (F*L = 32 for both;
    # at f2l16 the gradient is the f8l4 step's, the positions are what
    # contend).
    for name, spec in specs.items():
        hs["step " + name] = check_hash(torch, hash_nbr, "step " + name, spec,
                                        step_pos, step_g)
    del step_pos, step_g
    fused_launches, chunk = run_fused_path(torch, Runner, ngp_synthetic_cfg,
                                           fused_mlp, hash_nbr, mse2psnr)
    # Kernel F on one render chunk's own positions at both specs, F-MLP on
    # the same chunk's own rows (kernel F's bf16 output and the SH rows).
    for name, spec in specs.items():
        hs["render chunk " + name] = {"fwd": check_hash_fwd(
            torch, hash_nbr, "render chunk " + name, spec, chunk["pos"])}
        hs["render chunk " + name]["fwd"]["launches"] = \
            fused_launches["render_hash_fwd"]
    mlp_chunk = check_fmlp_rows(torch, fused_mlp, "render chunk",
                                chunk["ws"], chunk["x"], chunk["d"])
    n_chunk = chunk["x"].shape[0]
    print(f"render chunk: {n_chunk} samples, "
          f"{int((chunk['pos'] == 0.5).all(dim=1).sum())} at the empty-slot "
          f"position (0.5, 0.5, 0.5)", flush=True)
    del chunk
    for pallas_mlp in (False, True):
        check_small_step(torch, Runner, ngp_synthetic_cfg, fused_mlp,
                         pallas_mlp)
    quality_launches = run_quality(torch, Runner, ngp_synthetic_cfg, hash_nbr,
                                   fused_mlp, img2mse, mse2psnr)
    cli, xor_runner = run_cli(torch, run_net, hash_nbr, hash_xor, fused_mlp,
                              mse2psnr)
    xspec = xor_runner.model.pos_encoder.spec
    if xspec.n_entries != XOR_N_ENTRIES:
        raise SystemExit(f"the xor table has {xspec.n_entries} entries, not "
                         f"{XOR_N_ENTRIES}")
    # Two steps' kept samples (2 x 2^16) of the trained xor field.
    xor_pos, xor_g = capture_steps(xor_runner, hash_xor.HashEncodeXor,
                                   XOR_STEPS, 2)
    del xor_runner
    xs = {"trained field": check_hash_xor(torch, hash_xor, hash_grid,
                                          "trained field", xspec, xor_pos,
                                          xor_g)}
    n_xor = xor_pos.shape[0]
    del xor_pos, xor_g
    xs["uniform"] = check_hash_xor(torch, hash_xor, hash_grid, "uniform",
                                   xspec, *uniform_samples(torch, xspec))

    head = "step f8l4@2^19"
    others = ("uniform f8l4@2^19", "uniform f2l16@2^18", "step f2l16@2^18")
    fwd_others = others + ("render chunk f8l4@2^19", "render chunk f2l16@2^18")
    fwd_keys = ("ms", "plain_ms", "bound_ms", "f32_ms")
    src = "jnerf_tpu_torch/csrc/fused_mlp.cu"
    no_lib = "no single PyTorch call computes it"
    kernels = [
        kernel_row(
            "hash_encode_fwd (kernel F)", "jnerf_tpu_torch/csrc/hash_encode.cu",
            "jnerf_tpu/ops/hash_nbr.py:261", launches["fwd"],
            hs[head]["fwd"],
            f"one headline step's {N_SAMPLES} kept samples, f8l4@2^19, bf16 "
            "output (the path's dtype; f32_ms: the f32 output)",
            max_abs_err=max(h["fwd"]["err"] for h in hs.values()),
            library=no_lib + " (a gather of bf16-rounded rows, each "
            "product rounded to bf16, summed in f32)",
            fused_path_launches=fused_launches["hash_fwd"],
            quality_path_launches=quality_launches["fwd"],
            cli_path_launches=cli["linear_rows"]["train_launches"]["F"],
            f32_ms=hs[head]["fwd"]["f32_ms"],
            **{k: {m: hs[k]["fwd"][m] for m in fwd_keys
                   + (("launches",) if k.startswith("render") else ())}
               for k in fwd_others}),
        kernel_row(
            "hash_encode_bwd (kernel B)", "jnerf_tpu_torch/csrc/hash_encode.cu",
            "jnerf_tpu/ops/hash_nbr.py:382", launches["bwd"], hs[head]["bwd"],
            f"one headline step's {N_SAMPLES} kept samples, f8l4@2^19",
            also_replaces=["jnerf_tpu/ops/hash_nbr.py:431",
                           "jnerf_tpu/ops/hash_nbr.py:513"],
            max_abs_err=max(hs[k]["bwd"]["err"] for k in (head,) + others),
            library="index_put_(accumulate=True) of the precomputed weighted "
            "contributions: the scatter alone",
            fused_path_launches=fused_launches["hash_bwd"],
            quality_path_launches=quality_launches["bwd"],
            cli_path_launches=cli["linear_rows"]["train_launches"]["B"],
            **{k: {m: hs[k]["bwd"][m] for m in ("ms", "plain_ms", "bound_ms",
                                                "library_ms")}
               for k in others}),
        kernel_row(
            "fused_mlp_fwd (F-MLP)", src, "jnerf_tpu/ops/fused_mlp.py:113",
            fused_launches["fwd"], dict(mlp["fwd"][N_SAMPLES], library_ms=None),
            f"N={N_SAMPLES} random rows",
            max_abs_err=max(mlp["fwd"]["err"], mlp_chunk["err"]),
            library=no_lib,
            **{f"N={N_RENDER} random rows": {
                m: mlp["fwd"][N_RENDER][m]
                for m in ("ms", "plain_ms", "bound_ms")},
               f"render chunk N={n_chunk}": dict(
                   {m: mlp_chunk[m] for m in ("ms", "plain_ms", "bound_ms")},
                   launches=fused_launches["render_fwd"])}),
        kernel_row(
            "fused_mlp_bwd (B-MLP)", src, "jnerf_tpu/ops/fused_mlp.py:123",
            fused_launches["bwd"], dict(mlp["bwd"][N_SAMPLES], library_ms=None),
            f"N={N_SAMPLES}", max_abs_err=mlp["bwd"]["err"], library=no_lib),
        kernel_row(
            "fused_density_mlp (D-MLP)", src, "jnerf_tpu/ops/fused_mlp.py:242",
            launches["den"] + fused_launches["den"] + quality_launches["den"],
            dict(mlp["den"][N_SAMPLES], library_ms=None), f"N={N_SAMPLES}",
            on_path="none: neither package calls it on a path; phase 3 "
            "launches it against its twin",
            max_abs_err=mlp["den"]["err"], library=no_lib,
            **{f"N={N_RENDER}": {m: mlp["den"][N_RENDER][m]
                                 for m in ("ms", "plain_ms", "bound_ms")}}),
        kernel_row(
            "hash_encode_xor_fwd (kernel F, xor mode)",
            "jnerf_tpu_torch/csrc/hash_encode.cu",
            "jnerf_tpu/ops/hash_grid.py:186",
            cli["xor"]["train_launches"]["F xor"], xs["trained field"]["fwd"],
            f"two steps' {n_xor} kept samples of the trained xor field, "
            "flagship xor table "
            f"({XOR_N_ENTRIES} entries, 16 levels x 2), bf16 output",
            max_abs_err=max(x["fwd"]["err"] for x in xs.values()),
            max_bf16_ulps=max(x["fwd"]["ulps"] for x in xs.values()),
            library=no_lib + " (a gather of bf16 rows, bf16 weights and "
            "products, summed in f32)",
            test_task_launches=cli["xor"]["test_launches"]["F xor"],
            uniform={m: xs["uniform"]["fwd"][m]
                     for m in ("ms", "plain_ms", "bound_ms")}),
        kernel_row(
            "hash_encode_xor_bwd (kernel B, xor mode)",
            "jnerf_tpu_torch/csrc/hash_encode.cu",
            "jnerf_tpu/ops/hash_grid.py:206",
            cli["xor"]["train_launches"]["B xor"], xs["trained field"]["bwd"],
            "the same samples and table, bf16 products summed in f32",
            max_abs_err=max(x["bwd"]["err"] for x in xs.values()),
            library="index_put_(accumulate=True) of the precomputed "
            "contributions: the scatter alone",
            uniform={m: xs["uniform"]["bwd"][m]
                     for m in ("ms", "plain_ms", "bound_ms", "library_ms")}),
    ]
    for k in kernels:
        k["max_abs_err"] = float(k["max_abs_err"])
    print(f"chip_smoke.py: all phases passed in "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

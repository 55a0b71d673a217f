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
   uniform samples (f8l4 at a 2^19 level cap and f2l16 at 2^18); the fused
   MLP kernels F-MLP and D-MLP at 2^17 rows (the training M) and 2^20 rows
   (one render chunk), B-MLP at 2^17;
4. the slice: 48 training steps of the f8l4+m17f2k19 bench headline
   (Runner(device='cuda').train_range), with launch counts that show the
   main path went through both hash kernels, steps/s and peak memory;
   then one more step whose kept samples (positions and the f32 upstream
   gradient of the encoder) are captured, and kernels F and B checked and
   timed on them at both specs, kernel B also beside the scatter alone
   (index_put_ with accumulate=True);
5. the fused path: the same headline with cfg.use_pallas_mlp, 48 steps
   (B-MLP launched once a step), then its test split rendered
   (render_test), F-MLP launched there too, each image's PSNR, and the
   same images rendered with the plain MLP chain for comparison;
6. one small training step on the card against the same step on the CPU
   (the plain twins, which the CPU tests hold against the JAX package),
   with the plain MLP chain and with the fused kernels.

The last lines are the kernel table as JSON (each kernel with its bound:
the larger of its bytes over the memory rate and its operations over the
peak rate of their type, counted by the *_work functions below), the card
line, and {"ok": true, "device": {...}}.
"""

import json
import math
import subprocess
import sys
import time

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


def hash_fwd_work(n, n_levels, n_features, rows_read) -> dict:
    """Kernel F: pos [n, 3] and the table rows it reads (rows_read of 4F
    bytes, each read once) in, [n, F*L] f32 out."""
    nbytes = 12 * n + 4 * n_features * rows_read + 4 * n_features * n_levels * n
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


def check_hash(torch, hash_nbr, name, spec, pos, g):
    """Kernels F and B against their twins on one spec and one set of
    samples (positions pos [N, 3], f32 upstream gradient g [N, F*L]):
    e0 mismatches and errors, then times of both kernels and twins, and of
    the scatter alone (index_put_ with accumulate=True of the weighted
    contributions, computed outside the timed region)."""
    dev = pos.device
    L, F = spec.n_levels, spec.n_features_per_level
    n = pos.shape[0]
    gen = torch.Generator(dev).manual_seed(1)
    table = torch.randn((spec.n_entries, F), generator=gen, device=dev) * 0.1
    e0k = torch.zeros((n, L), dtype=torch.int32, device=dev)
    e0p = torch.zeros_like(e0k)
    fk = hash_nbr.encode_fwd(spec, table, pos, e0_out=e0k)
    fp = hash_nbr.hash_encode_plain(spec, table, pos, e0_out=e0p)
    bk = hash_nbr.grad_table(spec, pos, g)
    bp = hash_nbr.grad_table_plain(spec, pos, g)
    idx, wts = corner_entries(torch, hash_nbr, spec, pos)
    vals = (wts[:, None] * g.reshape(n, F, L).permute(2, 0, 1)
            .repeat_interleave(8, dim=0).reshape(-1, F))
    torch.cuda.synchronize()
    e0_bad = int((e0k != e0p).sum())
    f_err = float((fk - fp).abs().max())
    b_err = float((bk - bp).abs().max())
    b_max = float(bp.abs().max())
    print(f"kernel F [{name}]: e0 mismatches {e0_bad} of {n * L}, max abs err "
          f"{f_err:.3e} (tolerance abs {FWD_ATOL:g}, e0 0)", flush=True)
    print(f"kernel B [{name}]: max abs err {b_err:.3e}, rel to max "
          f"{b_err / b_max:.3e} (tolerance {BWD_RTOL_OF_MAX:g} of max |ref| = "
          f"{b_max:.4g})", flush=True)
    if e0_bad or not f_err <= FWD_ATOL:
        raise SystemExit(f"kernel F disagrees with its plain twin at {name}")
    if not b_err <= BWD_RTOL_OF_MAX * b_max:
        raise SystemExit(f"kernel B disagrees with its plain twin at {name}")

    def scatter():
        out = torch.zeros((spec.n_entries, F), dtype=torch.float32, device=dev)
        return out.index_put_((idx,), vals, accumulate=True)

    lib_err = float((scatter() - bp).abs().max())
    out = {"fwd": {"err": f_err}, "bwd": {"err": b_err}}
    runs = {"fwd": (lambda: hash_nbr.encode_fwd(spec, table, pos),
                    lambda: hash_nbr.hash_encode_plain(spec, table, pos)),
            "bwd": (lambda: hash_nbr.grad_table(spec, pos, g),
                    lambda: hash_nbr.grad_table_plain(spec, pos, g))}
    for kern, (k_fn, p_fn) in runs.items():
        ms, plain_ms, (k1, k2, p1, p2) = time_pair(k_fn, p_fn)
        print(f"time {kern} [{name}], N={n}: kernel {ms:.4f} ms ({k1:.4f}, "
              f"{k2:.4f}), plain {plain_ms:.4f} ms ({p1:.4f}, {p2:.4f})",
              flush=True)
        out[kern].update(ms=ms, plain_ms=plain_ms)
    rows = int(torch.unique(idx).numel())
    out["fwd"].update(hash_fwd_work(n, L, F, rows), library_ms=None)
    out["bwd"].update(hash_bwd_work(n, L, F, spec.n_entries))
    lib_ms = (cuda_ms(scatter) + cuda_ms(scatter)) / 2
    out["bwd"].update(library_ms=lib_ms)
    print(f"time bwd [{name}]: the scatter alone "
          f"(index_put_ accumulate) {lib_ms:.4f} ms, max abs err "
          f"{lib_err:.3e}; bound {out['bwd']['bound_ms']:.4f} ms "
          f"({out['bwd']['bytes']} B); kernel F bound "
          f"{out['fwd']['bound_ms']:.4f} ms ({rows} table rows read)",
          flush=True)
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


def check_mlp_kernels(torch, fused_mlp):
    """Phase 3, fused MLP: F-MLP and D-MLP at the training M and at one
    render chunk, B-MLP at the training M, against their twins."""
    gen = torch.Generator("cuda").manual_seed(0)
    ws = mlp_weights(torch, gen)
    stats = {"fwd": {"err": 0.0}, "bwd": {"err": 0.0}, "den": {"err": 0.0}}
    for n in (N_SAMPLES, N_RENDER):
        x, d, g = mlp_rows(torch, gen, n)
        fk = fused_mlp.fused_mlp_fwd(ws, x, d)
        fp = fused_mlp.fused_ngp_mlp_plain(ws, x, d)
        dk = fused_mlp.fused_density_mlp(ws[0], ws[1], x)
        dp = fused_mlp.fused_density_mlp_plain(ws[0], ws[1], x)
        torch.cuda.synchronize()
        errs = {"fwd": float((fk - fp).abs().max()),
                "den": float((dk - dp).abs().max())}
        runs = {"fwd": (lambda: fused_mlp.fused_mlp_fwd(ws, x, d),
                        lambda: fused_mlp.fused_ngp_mlp_plain(ws, x, d)),
                "den": (lambda: fused_mlp.fused_density_mlp(ws[0], ws[1], x),
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
        for kern, name in (("fwd", "F-MLP"), ("den", "D-MLP")):
            print(f"kernel {name}, N={n}: max abs err {errs[kern]:.3e} "
                  f"(tolerance {MLP_ATOL:g})", flush=True)
            if not errs[kern] <= MLP_ATOL:
                raise SystemExit(f"kernel {name} disagrees with its plain twin")
        for kern, (k_fn, p_fn) in runs.items():
            ms, plain_ms, four = time_pair(k_fn, p_fn)
            print(f"time mlp {kern}, N={n}: kernel {ms:.4f} ms ({four[0]:.4f}, "
                  f"{four[1]:.4f}), plain {plain_ms:.4f} ms ({four[2]:.4f}, "
                  f"{four[3]:.4f})", flush=True)
            stats[kern][n] = dict(
                {"fwd": mlp_fwd_work, "bwd": mlp_bwd_work,
                 "den": density_work}[kern](n), ms=ms, plain_ms=plain_ms)
            stats[kern]["err"] = max(stats[kern]["err"], errs[kern])
        del x, d, g, fk, fp, dk, dp
    return stats


def headline_cfg(ngp_synthetic_cfg, pallas_mlp):
    cfg = ngp_synthetic_cfg(hash_levels=4, hash_features=8)
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
    renders = {}
    for fused in (True, False):
        runner.model._fused_ok = fused
        fused_mlp.fused_mlp_fwd.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mses = runner.render_test(save_img=False, u=u)
        torch.cuda.synchronize()
        per_img = (time.perf_counter() - t0) / n_img
        launches = fused_mlp.fused_mlp_fwd.launches
        imgs = [runner.render_img("test", img_id=i, u=u)[0]
                for i in range(n_img)]
        renders[fused] = (imgs, launches)
        print(f"render_test ({'F-MLP' if fused else 'plain chain'}): "
              f"{n_img} images of {runner.W}x{runner.H}, "
              f"{per_img * 1e3:.3f} ms per image, PSNR "
              f"{', '.join(f'{float(mse2psnr(m)):.3f}' for m in mses)} dB, "
              f"F-MLP launches {launches}", flush=True)
    runner.model._fused_ok = True
    if renders[True][1] <= 0 or renders[False][1] != 0:
        raise SystemExit("F-MLP did not run (only) on the fused render")
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
    return dict(train_launches, fwd=train_launches["fwd"] + renders[True][1],
                den=dmlp_launches(fused_mlp, "the fused path"))


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
    pos, g = capture_step(runner, hash_nbr, HEADLINE_STEPS)
    empty = g.abs().sum(dim=1) == 0
    print(f"captured step {HEADLINE_STEPS}: {pos.shape[0]} sample slots, "
          f"{int(empty.sum())} with a zero gradient row (empty slots), "
          f"{torch.unique(pos, dim=0).shape[0]} distinct positions",
          flush=True)
    return launches, (pos, g)


def capture_step(runner, hash_nbr, step):
    """Train step `step` with the encoder's backward wrapped, and return
    the positions [M, 3] and the f32 upstream gradient [M, F*L] that
    reached kernel B in it."""
    got = []
    orig = hash_nbr.HashEncode.__dict__["backward"]

    def backward(ctx, g):
        if not got:
            got.append((ctx.saved_tensors[0].clone(),
                        g.float().contiguous().clone()))
        return orig.__func__(ctx, g)

    hash_nbr.HashEncode.backward = staticmethod(backward)
    try:
        runner.train_range(step, step + 1)
    finally:
        hash_nbr.HashEncode.backward = orig
    if not got:
        raise SystemExit("the step did not reach the hash backward")
    return got[0]


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


def build_kernels(torch, cuda_lib):
    """Phase 2: one nvcc per source, started together."""
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    names = ("hash_encode", "fused_mlp")
    with ThreadPoolExecutor(len(names)) as pool:
        libs = list(pool.map(cuda_lib.build, names))
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
    torch = require_cuda()
    from jnerf_tpu_torch.models.losses import mse2psnr
    from jnerf_tpu_torch.ops import cuda_lib, fused_mlp, hash_nbr
    from jnerf_tpu_torch.ops.hash_grid import HashGridSpec
    from jnerf_tpu_torch.runner import Runner
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
    fused_launches = run_fused_path(torch, Runner, ngp_synthetic_cfg,
                                    fused_mlp, hash_nbr, mse2psnr)
    for pallas_mlp in (False, True):
        check_small_step(torch, Runner, ngp_synthetic_cfg, fused_mlp,
                         pallas_mlp)

    head = "step f8l4@2^19"
    others = ("uniform f8l4@2^19", "uniform f2l16@2^18", "step f2l16@2^18")
    src = "jnerf_tpu_torch/csrc/fused_mlp.cu"
    no_lib = "no single PyTorch call computes it"
    kernels = [
        kernel_row(
            "hash_encode_fwd (kernel F)", "jnerf_tpu_torch/csrc/hash_encode.cu",
            "jnerf_tpu/ops/hash_nbr.py:261", launches["fwd"],
            hs[head]["fwd"],
            f"one headline step's {N_SAMPLES} kept samples, f8l4@2^19",
            max_abs_err=max(h["fwd"]["err"] for h in hs.values()),
            library=no_lib + " (a gather of bf16-rounded rows, each "
            "product rounded to bf16, summed in f32)",
            fused_path_launches=fused_launches["hash_fwd"],
            **{k: {m: hs[k]["fwd"][m] for m in ("ms", "plain_ms", "bound_ms")}
               for k in others}),
        kernel_row(
            "hash_encode_bwd (kernel B)", "jnerf_tpu_torch/csrc/hash_encode.cu",
            "jnerf_tpu/ops/hash_nbr.py:381", launches["bwd"], hs[head]["bwd"],
            f"one headline step's {N_SAMPLES} kept samples, f8l4@2^19",
            also_replaces=["jnerf_tpu/ops/hash_nbr.py:430",
                           "jnerf_tpu/ops/hash_nbr.py:512"],
            max_abs_err=max(h["bwd"]["err"] for h in hs.values()),
            library="index_put_(accumulate=True) of the precomputed weighted "
            "contributions: the scatter alone",
            fused_path_launches=fused_launches["hash_bwd"],
            **{k: {m: hs[k]["bwd"][m] for m in ("ms", "plain_ms", "bound_ms",
                                                "library_ms")}
               for k in others}),
        kernel_row(
            "fused_mlp_fwd (F-MLP)", src, "jnerf_tpu/ops/fused_mlp.py:113",
            fused_launches["fwd"], dict(mlp["fwd"][N_SAMPLES], library_ms=None),
            f"N={N_SAMPLES}", max_abs_err=mlp["fwd"]["err"], library=no_lib,
            **{f"N={N_RENDER}": {m: mlp["fwd"][N_RENDER][m]
                                 for m in ("ms", "plain_ms", "bound_ms")}}),
        kernel_row(
            "fused_mlp_bwd (B-MLP)", src, "jnerf_tpu/ops/fused_mlp.py:123",
            fused_launches["bwd"], dict(mlp["bwd"][N_SAMPLES], library_ms=None),
            f"N={N_SAMPLES}", max_abs_err=mlp["bwd"]["err"], library=no_lib),
        kernel_row(
            "fused_density_mlp (D-MLP)", src, "jnerf_tpu/ops/fused_mlp.py:242",
            launches["den"] + fused_launches["den"],
            dict(mlp["den"][N_SAMPLES], library_ms=None), f"N={N_SAMPLES}",
            on_path="none: neither package calls it on a path; phase 3 "
            "launches it against its twin",
            max_abs_err=mlp["den"]["err"], library=no_lib,
            **{f"N={N_RENDER}": {m: mlp["den"][N_RENDER][m]
                                 for m in ("ms", "plain_ms", "bound_ms")}}),
    ]
    for k in kernels:
        k["max_abs_err"] = float(k["max_abs_err"])
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Drive the PyTorch port of jnerf-tpu once on an NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card, nvcc and the port's sources beside this file; exits
nonzero, printing no result, without them.  Phases, each of which raises
on failure:

1. the card: its name and power limit (nvidia-smi);
2. build the CUDA kernels from jnerf_tpu_torch/csrc;
3. each kernel against its plain PyTorch twin on the card at the main
   path's shapes (2^17 samples; f8l4 at a 2^19 level cap and f2l16 at
   2^18), with errors, base-entry mismatches and times;
4. the slice: 48 training steps of the f8l4+m17f2k19 bench headline
   (Runner(device='cuda').train_range), with launch counts that show the
   main path went through both kernels, steps/s and peak memory;
5. one small training step on the card against the same step on the CPU
   (the plain twins, which the CPU tests hold against the JAX package).

The last lines are the kernel table as JSON, the card line, and
{"ok": true, "device": {...}}.
"""

import json
import math
import subprocess
import sys
import time

N_SAMPLES = 1 << 17  # the kept-sample cap M of the headline config
HEADLINE_STEPS = 48
# Kernel F equals its twin but for a rare bf16 rounding flip of one corner
# product (~5e-4 at |table| ~ 0.1); kernel B sums in the atomics' order.
FWD_ATOL = 1e-3
BWD_RTOL_OF_MAX = 1e-5


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=20, warmup=3) -> float:
    """Mean device time of fn() over `iters` launches, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def check_kernels(torch, hash_nbr, HashGridSpec):
    """Phase 3: both kernels against their twins at the main path's shapes."""
    specs = {
        "f8l4@2^19": HashGridSpec(n_levels=4, n_features_per_level=8,
                                  log2_hashmap_size=19, max_level_size=1 << 19),
        "f2l16@2^18": HashGridSpec(n_levels=16, n_features_per_level=2,
                                   log2_hashmap_size=19, max_level_size=1 << 18),
    }
    assert specs["f8l4@2^19"].level_sizes == (4096, 524288, 524288, 524288)
    assert specs["f8l4@2^19"].n_entries == 1_576_960
    assert specs["f2l16@2^18"].n_entries == 3_214_536
    dev = torch.device("cuda")
    stats = {"fwd": {"err": 0.0}, "bwd": {"err": 0.0}}
    for name, spec in specs.items():
        L, F = spec.n_levels, spec.n_features_per_level
        gen = torch.Generator(dev).manual_seed(0)
        pos = torch.rand((N_SAMPLES, 3), generator=gen, device=dev)
        table = torch.randn((spec.n_entries, F), generator=gen, device=dev) * 0.1
        g = torch.randn((N_SAMPLES, F * L), generator=gen, device=dev)

        e0k = torch.zeros((N_SAMPLES, L), dtype=torch.int32, device=dev)
        e0p = torch.zeros_like(e0k)
        fk = hash_nbr.encode_fwd(spec, table, pos, e0_out=e0k)
        fp = hash_nbr.hash_encode_plain(spec, table, pos, e0_out=e0p)
        bk = hash_nbr.grad_table(spec, pos, g)
        bp = hash_nbr.grad_table_plain(spec, pos, g)
        torch.cuda.synchronize()
        e0_bad = int((e0k != e0p).sum())
        f_err = float((fk - fp).abs().max())
        f_rel = f_err / float(fp.abs().max())
        b_err = float((bk - bp).abs().max())
        b_max = float(bp.abs().max())
        print(f"kernel F [{name}]: e0 mismatches {e0_bad} of {N_SAMPLES * L}, "
              f"max abs err {f_err:.3e}, rel to max {f_rel:.3e} "
              f"(tolerance abs {FWD_ATOL:g}, e0 0)", flush=True)
        print(f"kernel B [{name}]: max abs err {b_err:.3e}, rel to max "
              f"{b_err / b_max:.3e} (tolerance {BWD_RTOL_OF_MAX:g} of "
              f"max |ref| = {b_max:.4g})", flush=True)
        if e0_bad or not f_err <= FWD_ATOL:
            raise SystemExit(f"kernel F disagrees with its plain twin at {name}")
        if not b_err <= BWD_RTOL_OF_MAX * b_max:
            raise SystemExit(f"kernel B disagrees with its plain twin at {name}")
        stats["fwd"]["err"] = max(stats["fwd"]["err"], f_err)
        stats["bwd"]["err"] = max(stats["bwd"]["err"], b_err)

        # Plain, kernel, kernel, plain: each time is the mean of its two.
        runs = {"fwd": (lambda: hash_nbr.encode_fwd(spec, table, pos),
                        lambda: hash_nbr.hash_encode_plain(spec, table, pos)),
                "bwd": (lambda: hash_nbr.grad_table(spec, pos, g),
                        lambda: hash_nbr.grad_table_plain(spec, pos, g))}
        for kern, (k_fn, p_fn) in runs.items():
            p1, k1, k2, p2 = (cuda_ms(f) for f in (p_fn, k_fn, k_fn, p_fn))
            ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
            print(f"time {kern} [{name}], N={N_SAMPLES}: kernel {ms:.4f} ms "
                  f"({k1:.4f}, {k2:.4f}), plain {plain_ms:.4f} ms "
                  f"({p1:.4f}, {p2:.4f})", flush=True)
            stats[kern][name] = (ms, plain_ms)
    return stats


def run_headline(torch, Runner, ngp_synthetic_cfg, hash_nbr):
    """Phase 4: the slice, with the kernels' launch counts from its run."""
    cfg = ngp_synthetic_cfg(hash_levels=4, hash_features=8)
    cfg.compacted_batch = 1 << 17
    cfg.march_budget_factor = 2
    cfg.hashmap_fast_cap = 1 << 19
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
    losses, window_s = [], []
    t_all = time.perf_counter()
    for w in range(HEADLINE_STEPS // 16):
        t_w = time.perf_counter()
        loss = runner.train_range(16 * w, 16 * (w + 1))
        losses.append(float(loss))  # waits for the window's last step
        window_s.append(time.perf_counter() - t_w)
        print(f"  window {w}: steps {16 * w}-{16 * w + 15}, loss "
              f"{losses[-1]:.6f}, {window_s[-1]:.4f} s, next shape "
              f"{runner.sampler.n_rays_per_batch} x "
              f"{runner.sampler.n_samples_per_ray}", flush=True)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t_all
    launches = {"fwd": hash_nbr.encode_fwd.launches,
                "bwd": hash_nbr.grad_table.launches}
    peak = torch.cuda.max_memory_allocated()

    finite = all(math.isfinite(x) for x in losses) and all(
        bool(torch.isfinite(p).all()) for p in runner.model.parameters())
    print(f"headline: {HEADLINE_STEPS} steps in {total_s:.4f} s = "
          f"{HEADLINE_STEPS / total_s:.3f} steps/s (incl. 3 grid refreshes; "
          f"windows 1-2: {32 / sum(window_s[1:]):.3f} steps/s), peak memory "
          f"{peak / 2**20:.1f} MiB, launches F {launches['fwd']} B "
          f"{launches['bwd']}, on {card_line()}", flush=True)
    if not finite:
        raise SystemExit(f"non-finite loss or parameters: losses {losses}")
    if not losses[-1] < losses[0]:
        raise SystemExit(f"the loss did not fall over {HEADLINE_STEPS} steps: "
                         f"{losses}")
    if launches["fwd"] <= 0 or launches["bwd"] <= 0:
        raise SystemExit(f"a kernel was not launched on the main path: "
                         f"{launches}")
    return launches


def check_small_step(torch, Runner, ngp_synthetic_cfg):
    """Phase 5: one tiny step on the card against the same step on the CPU
    (same params, grid state and draws): loss rtol 1e-3, and per gradient
    tensor mean |diff| <= 1e-3 of its largest entry (bf16 rounding flips,
    as in tests/test_torch_step.py).  The largest single difference is
    printed, not held to a bound: rays are computed on each device, and a
    sample that lies within an ulp of a cell border may take the
    neighbouring hash entry on one of them."""
    cfg = ngp_synthetic_cfg(n_images=4, H=32, W=32, n_rays_per_batch=256,
                            target_batch_size=1 << 12, grid_size=32,
                            nerf_steps=128, hash_levels=4, hash_features=8,
                            log2_hashmap_size=13)
    cfg.compacted_batch = 1024
    cfg.march_budget_factor = 2
    gpu = Runner(device="cuda")
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
    print(f"small step card vs CPU: loss {l_gpu:.6f} vs {l_cpu:.6f}; grads "
          + ", ".join(f"{k} max {a:.2e} mean {b:.2e}" for k, a, b in worst),
          flush=True)
    if not abs(l_gpu - l_cpu) <= 1e-3 * abs(l_cpu):
        raise SystemExit("the card's step loss disagrees with the CPU's")
    if any(b > 1e-3 for _, _, b in worst):
        raise SystemExit("the card's step gradients disagree with the CPU's")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs an NVIDIA GPU: "
                         "torch.cuda.is_available() is false")
    from jnerf_tpu_torch.ops import cuda_lib, hash_nbr
    from jnerf_tpu_torch.ops.hash_grid import HashGridSpec
    from jnerf_tpu_torch.runner import Runner
    from jnerf_tpu_torch.utils.bench_cfg import ngp_synthetic_cfg

    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    print(f"card: {card_line()}", flush=True)

    t0 = time.perf_counter()
    lib = cuda_lib.build("hash_encode")
    cuda_lib.hash_encode_lib()
    print(f"built {lib.name} in {time.perf_counter() - t0:.2f} s", flush=True)
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}", flush=True)

    stats = check_kernels(torch, hash_nbr, HashGridSpec)
    launches = run_headline(torch, Runner, ngp_synthetic_cfg, hash_nbr)
    check_small_step(torch, Runner, ngp_synthetic_cfg)

    head = "f8l4@2^19"
    kernels = [
        {"name": "hash_encode_fwd (kernel F)", "route": "cuda",
         "source": "jnerf_tpu_torch/csrc/hash_encode.cu",
         "replaces": "jnerf_tpu/ops/hash_nbr.py:261",
         "launches": launches["fwd"], "max_abs_err": stats["fwd"]["err"],
         "ms": stats["fwd"][head][0], "plain_ms": stats["fwd"][head][1],
         "shape": f"N={N_SAMPLES} {head}",
         "f2l16@2^18": {"ms": stats["fwd"]["f2l16@2^18"][0],
                        "plain_ms": stats["fwd"]["f2l16@2^18"][1]}},
        {"name": "hash_encode_bwd (kernel B)", "route": "cuda",
         "source": "jnerf_tpu_torch/csrc/hash_encode.cu",
         "replaces": "jnerf_tpu/ops/hash_nbr.py:381",
         "also_replaces": ["jnerf_tpu/ops/hash_nbr.py:430",
                           "jnerf_tpu/ops/hash_nbr.py:512"],
         "launches": launches["bwd"], "max_abs_err": stats["bwd"]["err"],
         "ms": stats["bwd"][head][0], "plain_ms": stats["bwd"][head][1],
         "shape": f"N={N_SAMPLES} {head}",
         "f2l16@2^18": {"ms": stats["bwd"]["f2l16@2^18"][0],
                        "plain_ms": stats["bwd"]["f2l16@2^18"][1]}},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

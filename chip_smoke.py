"""Drive the PyTorch port of jnerf-tpu once on an NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card, nvcc and the port's sources beside this file; exits
nonzero, printing no result, without them.  Every NGP training run below
goes through ``Runner.train_range``, which on the card runs each refresh
window as the replay of a CUDA graph after an eager warm-up window of its
shape (the launch counters count the replays' launches); where a phase
needs a step's own tensors it trains that step eagerly.  The NeuS,
Mip-NeRF and Plenoxels runners' ``train`` run their windows (up to 16
steps, cut as their JAX runners cut them) the same way.  Phases, each of
which raises on failure:

1. the card: its name and power limit (nvidia-smi);
2. build the CUDA kernels from jnerf_tpu_torch/csrc (hash_encode.cu,
   fused_mlp.cu, envelope.cu and voxel_grid.cu) and the host-side C++
   cores (marching tetrahedra, the
   JPEG codec, the MPEG-4 encoder), all in parallel, with ptxas' register
   and spill lines;
3. each kernel against its plain PyTorch twin on the card at the main
   path's shapes, with errors and times: the hash kernels F and B at 2^17
   uniform samples (f8l4 at a 2^19 level cap and f2l16 at 2^18; kernel F
   timed with the bf16 output the path uses, and checked to be its f32
   output rounded; kernel B equal, bit for bit, to its twin on CPU copies
   and to a second launch, and held to the f64 sum of its contributions);
   the fused MLP kernels F-MLP and D-MLP at 2^17 rows (the
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
9. the probe-mode grid refresh: the headline with grid_update_mode="probe"
   for 1024 steps, kernel F counted in the refreshes' density queries, its
   test PSNR held 10 dB over the background's, then one probe and one
   sweep refresh of the trained field timed;
10. the NGP mesh tool (`python -m jnerf_tpu_torch.tools.extract_mesh`, its
   entry point in this process) at 384^3 on phase 8's trained linear field:
   both PLYs, over 1000 vertices inside the unit cube, kernel F counted in
   the density grid and the vertex-colour render, each step timed; then
   the native and numpy marching tetrahedra on a 128^3 slice of the grid
   (every 3rd point of each axis), equal and timed;
11. vanilla NeRF: projects/nerf/configs/nerf_base.py at full width (8 x
   256, frequency encodings of 10 and 4 octaves) through the CLI on phase
   8's scene, 1024 steps at learning rate 5e-4 (the config's 1e-2 does not
   train this MLP) and the test set, whose PSNR must clear the
   background's by 3 dB; no repo kernel runs;
12. NeuS: projects/neus/configs/neus_womask.py at full width (SDF 8 x 256
   with 257 outputs, background NeRF 8 x 256, colour 4 x 256; 512 rays of
   64 + 64 + 32 samples) through the CLI (--type mesh) on a DTU-format
   scene of 32 images of 400 x 300 written by the port: the
   geometric-init mesh at 128^3, --task train for 800 steps through graph
   windows (a checkpoint at the end; f32, TF32 off), then --task
   validate_mesh at 512^3.  The
   colour loss of the last 100 steps must be at most half that of the
   first 100, the eikonal term finite, and the trained mesh's vertices
   closer to the analytic object, on average, than the init mesh's; no
   repo kernel runs;
13. Mip-NeRF: projects/mipnerf/configs/mip_base.py at full width (8 x 256
   trunk, skip after layer 4, 1 x 128 colour branch, 2 levels x 128
   samples, 4096 rays; f32, TF32 off) through the CLI on phase 8's scene:
   one shrunk step on the card against the CPU, --task train for 384
   steps through graph windows, then --task test from params.pkl, whose
   PSNR must clear that of
   predicting black everywhere by 3 dB; no repo kernel runs;
14. Plenoxels: projects/svox2/configs/svox2_base.py at full width (256^3,
   basis 9, 5000 rays, step 0.5) through the CLI on phase 8's scene: a
   dense and a sparse small step on the card against the CPU, then 512
   dense steps at 256^3 (the test PSNR must clear the all-white
   background's by 1 dB), the upsample to a sparse 512^3 grid and 128
   sparse steps (the active cells and the tables' size bounded, the MSE
   below 0.2), all through graph windows, and the grid's .npz saved, timed
   and loaded back; kernel V (the grid gradient) runs once a step and no
   other repo kernel runs, and one step's kernel V inputs of the trained
   dense and sparse grids are kept for phase 23;
15. pixelNeRF (`python -m jnerf_tpu_torch.projects.pixelnerf.main`, its
   main in this process) at the JAX script's widths (512-channel encoder,
   512-wide trunk, 3 references of 100^2, 2048 rays x 64 samples; f32, TF32
   off) on its analytic scene, after one small step on the card against
   the CPU: 2 epochs of 102 steps, the second epoch's mean loss below the
   first's, then pixelnerf.pkl loaded into a fresh model that must render
   a batch as the trained one does; no repo kernel runs;
16. Recursive-NeRF (`python -m jnerf_tpu_torch.projects.recursive_nerf.main`)
   at the script's widths (W=256, head_num 8, 1024 rays x 64 samples) on
   its 16 views of 80^2, after one small step on the card against the CPU:
   800 iterations with the stages at 200/400/600, all three `stage ->
   level` transitions, the last 50 iterations' MSE below the first 50's,
   then recursive_nerf.pkl loaded back as in phase 15; no repo kernel
   runs;
17. data parallelism (`jnerf_tpu_torch/parallel/dryrun.py`): two ranks on
   the card over gloo run `dryrun_multichip(2)` (the collectives on CUDA
   tensors, the JAX dry run's flagship step after a step-300 refresh, in
   bf16 and in f32, and a two-window train_range whose shapes the ranks
   check at each window); this process runs each flagship step alone from
   the same seed and holds the ranks to it (the f32 gradients within 1e-5
   of their largest entries, the losses at rtol 1e-5, the refreshed grids
   at rtol 1e-5 / atol 1e-6 with the bitfields equal), kernels F and B
   counted in each rank's step; then `dryrun_multichip(1)`, NCCL at world
   size 1;
18. the real-capture configs through the CLI (`run_net.main` in this
   process), on captures that the port writes on the card in the real
   captures' layouts (the spheres in a patterned room, opaque JPEG
   photographs at quality 95 through write_image): projects/ngp/configs/
   ngp_fox.py (full width, aabb_scale 4 from the json: 3 grid cascades,
   cone-angle steps) on a fox layout (50 + 2 frames of 1080 x 1920,
   images/0001.jpg, ..., fl_x/fl_y/cx/cy and nonzero k1/k2/p1/p2), --task
   train for 1536 of the config's 40,000 steps and --task test, the
   encode and decode seconds printed; then ngp_llff.py (aabb_scale 64: 7
   cascades) on an LLFF layout (20 views of 4032 x 3024 as
   images/IMG_*.JPG and poses_bounds.npy, no images_8/, so the loader
   decodes the JPEGs to minify them to 504 x 378), --task train for 1024
   steps, --task test and --task render, whose demo.mp4 (80 frames at 28
   fps) a box walk checks.  Each TOTAL TEST PSNR must clear that of
   predicting each test frame's mean colour everywhere by 10 dB, and the
   test task must read within 0.5 dB of the train task's; kernels F and B
   must run in every training task, F alone in the test and render
   tasks, and both are checked against their twins and timed on two
   steps' kept samples of each trained field (3,391,728 and 3,596,432
   table entries);
19. the port's measuring tools, each through its entry point's main in
   this process (so the launch counters read what it ran):
   `python -m jnerf_tpu_torch.bench` with the headline f8l4+m17f2k19 at
   the bench's defaults (512^2 images, 512 warm-up and 256 timed steps)
   and each of its other five configs at 32 + 32 steps, every line
   without an error entry, its iters/s positive and kernels F and B
   counted in every config; then `tools.bench_psnr` on the hard-scene
   headline for TOOL_STEPS iterations after its 256 warm-up steps,
   `tools.probe_tiers` on the headline, `tools.probe_demand` and
   `tools.time_step` at shortened steps, each with finite positive
   numbers and kernels F and B counted, and `tools.probe_cap19`, also
   with kernels F and B counted, whose kernel B must stand within kernel
   B's bound of phase 3 of the exact adjoint, and kernel F within kernel
   F's of its twin, at f8l4 and f4l8 with 2^19-entry levels and at the
   bench's other tables, f8l4 at 2^16 and f4l8 at 2^17 (f2l16 at 2^18 is
   phase 3's);
20. the archived TPU envelope probes' ports
   (`jnerf_tpu_torch/tools/archive/`), each through its main in this
   process with the envelope kernels' counters set to 0 just before and
   read just after, at the archive's sizes (probe_final's sections 3-5:
   its 1-2 GiB sections 1-2 are left to the chip runs that PERF.md names),
   each required to launch its kernels (K1 row gather, K2 element gather,
   K3 row scatter-add, K4 packed hash scatter); then each kernel held to
   its twin at an archived shape (K1 and K2 bit for bit, K3 and K4 within
   BWD_RTOL_OF_MAX of the f64 sum; K3 and K4's v2d, alt2 and novals also
   bit for bit to the twin on CPU copies and to a second launch) and timed
   beside its twin and a library call (K2 also its host time a call);
21. training repeats from a seed: the headline (plain MLP) for 48 steps
   and the xor hash (f2l16) for 32, each twice from one seed in this
   process, through graph windows; the parameters, Adam's moments and
   count, the EMA, the occupancy grid's state, the generator's state and
   every step's loss (read from each window's loss buffer) must be equal
   bit for bit, and kernel B counted in every step;
22. graph windows against eager ones: the headline for 4 windows, the xor
   hash (f2l16) and the fused-MLP headline for 2, each from one seed
   through ``train_range`` (graph replays) and through
   ``train_range_eager`` (loops of ``train_step``); both must end in equal
   bits (phase 21's state and every step's loss) with equal launch
   counts, and one more graph window run under torch.profiler must show
   kernels F and B (and F-MLP) launched as often as the counters say.
   Then `python -m jnerf_tpu_torch.tools.window_time` on the headline:
   host ms, kernel ms, busy share, launches a step and peak memory of
   each path at the adapted shape;
23. the families' windows: NeuS, Mip-NeRF and Plenoxels (dense 256^3,
   then sparse 512^3 after the upsample) at full width on the scenes of
   phases 12-14, each trained for two windows a grid through graphs twice
   and through the eager loop once from one seed; the three runs must end
   in equal bits (parameters, optimizer state and counts, grid buffers,
   the generator, every step's loss) with equal launch counts (kernel V
   once a Plenoxels step).  One more window of the graph run and of the
   eager run gives each path's host ms and kernel ms a step, busy share
   and peak memory; one more eager window runs under
   torch.use_deterministic_algorithms(warn_only) and the ops it names are
   printed.  pixelNeRF at the script's widths trains a few steps twice
   from one seed with equal bits.  Kernel V is held to its plain version
   on CPU copies bit for bit, to a second launch and inside guard zones
   on phase 14's dense and sparse inputs (the dense grid's sample path,
   the sparse grid's item path), its sort to the plain plan, and timed
   beside the plain version, index_add_ of the materialized products
   alone and the whole index_add_ path (keep mask, compaction, products
   and index_add_), with its device time split by CUDA kernel into
   compaction, sort, row starts and sum.

Each of phases 9-23 prints its time and its peak device memory.  To make
room for phase 18, phase 10 runs at 384^3 (was 512^3), phase 12 for 800
steps (was 1000) and phase 13 for 384 (was 512).

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
# product (~5e-4 at |table| ~ 0.1).  Kernel B sums in its twin's fixed
# order: it must equal the twin run on CPU copies (on CUDA tensors the
# twin's index_add_ adds with atomics, in no fixed order) and a second
# launch, bit for bit, and is also held to the f64 sum of the same f32
# contributions.
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
# the 0.5 dB allowance (PERF.md §6).  At 8192, where the bar holds, a seed
# repeats to the last digit since kernel B sums in a fixed order: seed 42
# (this phase's) read 35.311 dB twice on an H100, 0.917 dB over the bar,
# and seeds 43 and 44 read 40.817 and 40.345 (logs/torch/eval8192/pr16/).
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
# Phase 9: the headline with the probe-mode grid refresh.
PROBE_STEPS = 1024
PROBE_PSNR_OVER_BG = 10.0
# Phase 10: the NGP mesh tool on phase 8's linear field, at 384^3 of the
# tool's 512^3, cut with phases 12-13 to make room for phase 18 (at 512^3
# the phase took 69.5 s on an H100, 27.4 s of it marching on the host).
MESH_RES = 384
# Phase 11: vanilla NeRF (nerf_base.py) on phase 8's scene.  The config's
# learning rate, 1e-2, does not train its 8 x 256 MLP: on an H100,
# `python3 -m jnerf_tpu_torch.tools.nerf_lr_probe` read a test PSNR of
# 4.915 dB after 1024 steps at 1e-2 and 24.459 dB at the NeRF paper's 5e-4,
# against 18.834 dB for the background alone (PERF.md §6).
VANILLA_STEPS = 1024
VANILLA_LR = 5e-4
VANILLA_PSNR_OVER_BG = 3.0
# Phase 12: NeuS (neus_womask.py) on a DTU-format scene of the port's.
# 800 of the config's 100,000 steps: cut from 1500 with phase 13 for the
# script's time, then from 1000 for phase 18's (over 1500 steps on an H100
# the colour loss fell from 1.081 to 0.025, its pass bar being half; the
# loss logged at step 800 of a 1000-step run was 0.031 against 0.352 at
# 100).
NEUS_STEPS = 800
NEUS_IMAGES, NEUS_H, NEUS_W = 32, 300, 400
NEUS_INIT_RES = 128
# Phase 13: Mip-NeRF (mip_base.py) on phase 8's scene, 384 of its 40,001
# steps: with 1024, and NeuS at 1500, the script took 818.0 s on an H100,
# over its ~700 s aim (PERF.md section 6); 512 read 32.180 dB against 17.2
# for black, and phase 18 took the time of the last 128.
MIP_STEPS = 384
MIP_PSNR_OVER_BLACK = 3.0
MIP_SMALL_RTOL = 1e-4
# Phase 14: Plenoxels (svox2_base.py) on phase 8's scene: 512 dense steps
# at 256^3, then 128 sparse at 512^3.
SVOX_ITERS, SVOX_UPSAMP = 640, 512
SVOX_PSNR_OVER_WHITE = 1.0
SVOX_SPARSE_MSE = 0.2
SVOX_SMALL_RTOL = 1e-4
# Phase 15: pixelNeRF at the JAX script's widths on its analytic scene, 2 of
# the script's 10 epochs (the JAX package's own test runs 2).
PIX_EPOCHS = 2
# Phase 16: Recursive-NeRF at the JAX script's widths, 800 of its 3000
# iterations with step1/2/3 at 200/400/600 (of 500/1000/1500), so that every
# stage runs and all three anchor splits happen.
REC_ITERS, REC_STAGES = 800, (200, 400, 600)
# Both: one small step on the card against the CPU: the loss within 1e-5
# relative, the largest gradient |diff| within 1e-5 of the largest entry.
MINI_SMALL_RTOL = 1e-5
# Phase 18: the real-capture configs on captures in their layouts, JPEG
# photographs written by the port: ngp_fox.py (the fox's 50 + 2 frames of
# 1080 x 1920, aabb_scale 4) for FOX_STEPS of its 40,000 steps, ngp_llff.py
# (fern's 20 views of 4032 x 3024, minified by 8, aabb_scale 64) for
# LLFF_STEPS.  Each test PSNR must clear that of predicting each test
# frame's mean colour everywhere by CAPTURE_PSNR_OVER_MEAN.
FOX_STEPS = 1536
LLFF_STEPS = 1024
FOX_HW, LLFF_HW = (1080, 1920), (3024, 4032)
CAPTURE_PSNR_OVER_MEAN = 10.0
FOX_CASCADES, LLFF_CASCADES = 3, 7
FOX_N_ENTRIES, LLFF_N_ENTRIES = 3_391_728, 3_596_432
# Phase 19: the measuring tools.  The bench's headline runs at the bench's
# defaults; its other configs, bench_psnr's iterations and the probes'
# warm-up steps are cut (from 64 + 64 bench steps, 256 iterations and 20
# steady steps, with which the phase took 60.5 s and the script 891.0 s on
# an H100 whose host ran the hard-scene phase at 71 steps/s) so that the
# script stays near 800 s.
TOOL_BENCH_SHORT = ["--warmup", "32", "--steps", "32"]
TOOL_STEPS = 128
TOOL_STEADY_STEPS = 5
RENDER_FRAMES, RENDER_FPS = 80, 28

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
    """Kernels F and B against their plain versions on one spec and one set
    of samples (positions pos [N, 3], f32 upstream gradient g [N, F*L]):
    kernel F as check_hash_fwd; kernel B equal, bit for bit, to its twin
    on CPU copies and to a second launch, and its error against the f64
    sum of the same contributions (the twin's corner entries and weights,
    each f32 product exact in f64; index_add_ in f64), kernel B's time
    against the twin's (on the card), and the time of the scatter alone
    (index_put_ with accumulate=True of the weighted f32 contributions,
    computed outside the timed region)."""
    dev = pos.device
    L, F = spec.n_levels, spec.n_features_per_level
    n = pos.shape[0]
    out = {"fwd": check_hash_fwd(torch, hash_nbr, name, spec, pos)}
    bk = hash_nbr.grad_table(spec, pos, g)
    repeat = torch.equal(bk, hash_nbr.grad_table(spec, pos, g))
    t_twin = time.perf_counter()
    bp = hash_nbr.grad_table_plain(spec, pos.cpu(), g.cpu())
    twin_equal = torch.equal(bk.cpu(), bp)
    t_twin = time.perf_counter() - t_twin
    bp = bp.to(dev)
    idx, wts = corner_entries(torch, hash_nbr, spec, pos)
    vals64 = (wts.double()[:, None] * g.double().reshape(n, F, L)
              .permute(2, 0, 1).repeat_interleave(8, dim=0).reshape(-1, F))
    ref = torch.zeros((spec.n_entries, F), dtype=torch.float64,
                      device=dev).index_add_(0, idx, vals64)
    vals = vals64.float()  # the f32 products, rounded as f32 multiplies round
    del vals64
    torch.cuda.synchronize()
    b_err = float((bk.double() - ref).abs().max())
    twin_err = float((bp.double() - ref).abs().max())
    b_max = float(ref.abs().max())
    print(f"kernel B [{name}]: equal to its twin on CPU copies "
          f"({t_twin:.2f} s): {twin_equal}, to a second launch: {repeat}; "
          f"max abs err "
          f"{b_err:.3e} from the f64 sum, rel to max {b_err / b_max:.3e} "
          f"(tolerance {BWD_RTOL_OF_MAX:g} of max |ref| = {b_max:.4g}); the "
          f"f32 twin's {twin_err / b_max:.3e}", flush=True)
    if not (twin_equal and repeat and b_err <= BWD_RTOL_OF_MAX * b_max):
        raise SystemExit(f"kernel B disagrees with its twin or the sum at "
                         f"{name}")

    def scatter():
        acc = torch.zeros((spec.n_entries, F), dtype=torch.float32, device=dev)
        return acc.index_put_((idx,), vals, accumulate=True)

    lib_err = float((scatter().double() - ref).abs().max())
    del ref
    ms, plain_ms, (k1, k2, p1, p2) = time_pair(
        lambda: hash_nbr.grad_table(spec, pos, g),
        lambda: hash_nbr.grad_table_plain(spec, pos, g))
    print(f"time bwd [{name}], N={n}: kernel {ms:.4f} ms ({k1:.4f}, "
          f"{k2:.4f}), plain {plain_ms:.4f} ms ({p1:.4f}, {p2:.4f})",
          flush=True)
    lib_ms = (cuda_ms(scatter) + cuda_ms(scatter)) / 2
    out["bwd"] = dict(hash_bwd_work(n, L, F, spec.n_entries), err=b_err, ms=ms,
                      plain_ms=plain_ms, library_ms=lib_ms,
                      equal_to_twin=twin_equal)
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
    table gradient (bf16 products, and f32) equal, bit for bit, to its twin
    on CPU copies and to a second launch.  Times the bf16 kernels (the
    path's dtype) against their twins, and kernel B beside the scatter
    alone."""
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
        repeat = torch.equal(bk, hash_xor.grad_table_xor(spec, pos, g, rnd))
        t_twin = time.perf_counter()
        bp = hash_grid.grad_table_xor_plain(spec, pos.cpu(), g.cpu(), rnd)
        twin_equal = torch.equal(bk.cpu(), bp)
        t_twin = time.perf_counter() - t_twin
        err = float((bk.cpu() - bp).abs().max())
        b_errs[rnd] = err
        print(f"kernel B xor [{name}] ({'bf16' if rnd else 'f32'} products): "
              f"equal to its twin on CPU copies ({t_twin:.2f} s): "
              f"{twin_equal}, to a second launch: {repeat}; max abs err "
              f"{err:.3e}", flush=True)
        if not (twin_equal and repeat):
            raise SystemExit(f"kernel B (xor) differs from its twin or from "
                             f"itself at {name}")
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
    """Train steps [step, step + n_steps) eagerly (a replayed graph would
    not call the wrapper) with ``fn_class``'s backward wrapped; returns the
    positions and the f32 upstream gradients that reached it,
    concatenated over the steps."""
    import torch

    got = []
    orig = fn_class.__dict__["backward"]

    def backward(ctx, g):
        got.append((ctx.saved_tensors[0].clone(),
                    g.float().contiguous().clone()))
        return orig.__func__(ctx, g)

    fn_class.backward = staticmethod(backward)
    try:
        runner.train_range_eager(step, step + n_steps)
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


def run_cli(torch, run_net, hash_nbr, hash_xor, fused_mlp, tmp):
    """Phase 8: the CLI's train and test tasks on a blender-format scene
    written under ``tmp``, linear and xor; returns (per-mode results, with
    each mode's config file, the xor run's runner, the scene's path)."""
    from jnerf_tpu_torch.dataset.dataset_util import read_image
    from jnerf_tpu_torch.dataset.synthetic import (
        background_psnr, make_synthetic_scene,
    )
    from jnerf_tpu_torch.runner import Runner

    t_phase = time.perf_counter()
    counters = launch_counters(hash_nbr, hash_xor, fused_mlp)
    train_s = [0.0]
    orig_range = Runner.train_range

    def timed_range(self, *a, **k):
        t0 = time.perf_counter()
        out = orig_range(self, *a, **k)
        torch.cuda.synchronize()
        train_s[0] += time.perf_counter() - t0
        return out

    try:
        scene = os.path.join(tmp, "scene")
        t0 = time.perf_counter()
        make_synthetic_scene(scene, n_train=24, n_val=2, n_test=4, H=CLI_HW,
                             W=CLI_HW, device="cuda")
        bg = background_psnr(scene, 4)
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
            reset_counts(counters)
            train_s[0] = 0.0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            runner, psnr = run_net.main(argv + ["--task", "train"])
            task_s = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
            n_train = read_counts(counters)
            reset_counts(counters)
            _, psnr_again = run_net.main(argv + ["--task", "test"])
            n_test = read_counts(counters)
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
                                 test_launches=n_test, cfg=cfg)
            if mode == "xor":
                xor_runner = runner
            del runner
    finally:
        Runner.train_range = orig_range
    print(f"cli phase: {time.perf_counter() - t_phase:.3f} s", flush=True)
    return results, xor_runner, scene


def launch_counters(hash_nbr, hash_xor, fused_mlp):
    """Every kernel wrapper's launch counter, by kernel."""
    from jnerf_tpu_torch.ops import voxel_grid

    return {"F": hash_nbr.encode_fwd, "B": hash_nbr.grad_table,
            "F xor": hash_xor.encode_xor_fwd, "B xor": hash_xor.grad_table_xor,
            "F-MLP": fused_mlp.fused_mlp_fwd, "B-MLP": fused_mlp.fused_mlp_bwd,
            "D-MLP": fused_mlp.fused_density_mlp, "V": voxel_grid.corner_grad}


def reset_counts(counters):
    for fn in counters.values():
        fn.launches = 0


def read_counts(counters):
    return {k: fn.launches for k, fn in counters.items()}


def phase_start(torch):
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return time.perf_counter()


def phase_end(torch, name, t0):
    """Print and return (seconds, peak MiB) of a phase started at t0."""
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**20
    print(f"{name} phase: {secs:.3f} s, peak memory {peak:.1f} MiB", flush=True)
    return secs, peak


def psnr_over_background(torch, runner, mse2psnr, u):
    """(mean test PSNR, mean PSNR of predicting the run's background
    everywhere) over the runner's test split."""
    mses = runner.render_test(save_img=False, u=u)
    ds = runner.dataset["test"]
    bg = runner.background_color.numpy()
    bg_psnr = []
    for i in range(ds.n_images):
        tar = ds.image(i)
        tar = tar[..., :3] * tar[..., 3:] + bg * (1 - tar[..., 3:])
        bg_psnr.append(float(mse2psnr(float(((tar - bg) ** 2).mean()))))
    psnr = [float(mse2psnr(m)) for m in mses]
    return sum(psnr) / len(psnr), sum(bg_psnr) / len(bg_psnr)


def time_refresh(torch, runner, step, reps=5):
    """Mean device time of one grid refresh at ``step``'s sample counts,
    by CUDA events, the sampler's state restored after each."""
    sampler = runner.sampler
    state = sampler.state

    def once():
        sampler.update_density_grid(training_step=step,
                                    generator=runner.generator)
        sampler.state = state

    return cuda_ms(once, iters=reps)


def run_probe(torch, Runner, ngp_synthetic_cfg, counters, mse2psnr):
    """Phase 9: the headline with the probe-mode grid refresh
    (grid_update_mode='probe') for PROBE_STEPS steps; kernel F counted in
    the refreshes' density queries; the test split's PSNR against the
    background's; then one probe and one sweep refresh of the trained
    field timed."""
    t_phase = phase_start(torch)
    cfg = headline_cfg(ngp_synthetic_cfg, False)
    cfg.grid_update_mode = "probe"
    runner = Runner(device="cuda")
    refresh = {"n": 0, "F": 0}
    orig_update = runner._update_grid

    def update_grid(step):
        before = counters["F"].launches
        orig_update(step)
        refresh["n"] += 1
        refresh["F"] += counters["F"].launches - before

    runner._update_grid = update_grid
    reset_counts(counters)
    t0 = time.perf_counter()
    loss = float(runner.train_range(0, PROBE_STEPS))
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = read_counts(counters)
    del runner._update_grid
    u = torch.rand((runner.render_chunk_rays,), device="cuda",
                   generator=torch.Generator("cuda").manual_seed(0))
    psnr, bg = psnr_over_background(torch, runner, mse2psnr, u)
    g = runner.sampler.grid_config
    counts = runner.sampler.grid_update_counts(PROBE_STEPS)
    probe_ms = time_refresh(torch, runner, PROBE_STEPS)
    runner.sampler.grid_update_mode = "sweep"
    sweep_ms = time_refresh(torch, runner, PROBE_STEPS)
    runner.sampler.grid_update_mode = "probe"
    print(f"probe headline: {PROBE_STEPS} steps in {train_s:.3f} s = "
          f"{PROBE_STEPS / train_s:.3f} steps/s, loss {loss:.6f}, "
          f"{refresh['n']} probe refreshes launched kernel F "
          f"{refresh['F']} times ({g.n_cells * (g.max_cascade + 1)} cells "
          f"probed before step 256, {counts} after); launches {launches}; "
          f"test PSNR {psnr:.3f} dB, background alone {bg:.3f} dB; one "
          f"refresh of the trained field: probe {probe_ms:.4f} ms, sweep "
          f"{sweep_ms:.4f} ms, on {card_line()}", flush=True)
    if not (math.isfinite(loss) and psnr >= bg + PROBE_PSNR_OVER_BG):
        raise SystemExit(f"probe training: loss {loss}, test PSNR {psnr:.3f} "
                         f"dB against background {bg:.3f} dB")
    if refresh["F"] <= 0 or launches["B"] < PROBE_STEPS \
            or refresh["n"] != PROBE_STEPS // runner.sampler.update_den_freq:
        raise SystemExit(f"probe training did not go through its kernels: "
                         f"{launches}, refreshes {refresh}")
    secs, peak = phase_end(torch, "probe", t_phase)
    return dict(steps=PROBE_STEPS, steps_per_s=PROBE_STEPS / train_s,
                psnr=psnr, bg_psnr=bg, launches=launches,
                refreshes=refresh["n"], refresh_launches=refresh["F"],
                probe_refresh_ms=probe_ms, sweep_refresh_ms=sweep_ms,
                phase_s=secs, peak_mib=peak)


def read_ply_vertices(np, path):
    """(vertices [V, 3] f32, face count) of a binary PLY of write_ply."""
    data = Path(path).read_bytes()
    head, body = data.split(b"end_header\n", 1)
    nv = int(head.split(b"element vertex ")[1].split(b"\n")[0])
    nf = int(head.split(b"element face ")[1].split(b"\n")[0])
    stride = 15 if b"property uchar red" in head else 12
    rec = np.frombuffer(body[:stride * nv], np.uint8).reshape(nv, stride)
    return rec[:, :12].copy().view(np.float32).reshape(nv, 3), nf


def run_mesh_tool(torch, extract_mesh, counters, cfg_path):
    """Phase 10: the NGP mesh tool (its entry point, in this process) at
    MESH_RES on phase 8's trained linear field, each step timed; then the
    native and numpy marching tetrahedra on a 128^3 slice of its density
    grid (every 4th point of each axis), checked equal and timed."""
    import numpy as np

    t_phase = phase_start(torch)
    got, secs = {}, {}

    def timed(name, fn):
        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            secs[name] = secs.get(name, 0.0) + time.perf_counter() - t0
            got[name] = out
            return out
        return run

    names = ("density_grid", "vertex_colors", "marching_tetrahedra",
             "largest_component")
    saved = {name: getattr(extract_mesh, name) for name in names}
    for name in names:
        setattr(extract_mesh, name, timed(name, saved[name]))
    launches = {}
    orig_colors = extract_mesh.vertex_colors

    def colors(*a, **k):
        launches["grid F"] = counters["F"].launches
        return orig_colors(*a, **k)

    extract_mesh.vertex_colors = colors
    reset_counts(counters)
    try:
        t0 = time.perf_counter()
        paths = extract_mesh.mesh(["--config-file", cfg_path, "--resolution",
                                   str(MESH_RES), "--device", "cuda"])
        tool_s = time.perf_counter() - t0
    finally:
        for name, fn in saved.items():
            setattr(extract_mesh, name, fn)
    counts = read_counts(counters)
    launches["colour F"] = counts["F"] - launches["grid F"]
    sigma = got["density_grid"]
    plys = [read_ply_vertices(np, p) for p in paths]
    v_all, v_col = plys[0][0], plys[1][0]
    inside = bool(((v_all >= 0) & (v_all <= 1)).all()
                  and ((v_col >= 0) & (v_col <= 1)).all())
    print(f"mesh tool at {MESH_RES}^3: {tool_s:.3f} s (density grid "
          f"{secs['density_grid']:.3f} s, marching tetrahedra "
          f"{secs['marching_tetrahedra']:.3f} s, largest component "
          f"{secs['largest_component']:.3f} s, vertex colours "
          f"{secs['vertex_colors']:.3f} s); mesh-origin {len(v_all)} vertices "
          f"{plys[0][1]} faces, mesh-color {len(v_col)} vertices {plys[1][1]} "
          f"faces, all inside the unit cube: {inside}; sigma > 0.5 on "
          f"{int((sigma > 0.5).sum())} of {sigma.size} grid points; kernel F "
          f"launches: density grid {launches['grid F']}, colour render "
          f"{launches['colour F']}; all launches {counts}", flush=True)
    if not (len(v_all) > 1000 and len(v_col) > 1000 and inside
            and all(os.path.getsize(p) > 0 for p in paths)):
        raise SystemExit("the mesh tool's PLYs are missing, too small or "
                         "outside the AABB")
    if launches["grid F"] < (MESH_RES ** 3) // extract_mesh.QUERY_ROWS \
            or launches["colour F"] <= 0 or counts["D-MLP"]:
        raise SystemExit(f"the mesh tool did not go through kernel F: "
                         f"{launches}, {counts}")

    # Every k-th grid point of each axis: a 128^3 slice over the whole field.
    k = max(1, MESH_RES // 128)
    block = np.ascontiguousarray(sigma[::k, ::k, ::k])
    out, mt_s = {}, {}
    for use_native in (True, False):
        t0 = time.perf_counter()
        out[use_native] = saved["marching_tetrahedra"](block, 0.5, use_native)
        mt_s[use_native] = time.perf_counter() - t0
    (vn, tn), (vp, tp) = out[True], out[False]
    same = (len(vn) == len(vp) and len(tn) == len(tp) and np.array_equal(
        np.unique(np.round(vn, 4), axis=0), np.unique(np.round(vp, 4), axis=0)))
    print(f"marching tetrahedra on the grid's 128^3 slice (every {k}th "
          f"point of each axis): native "
          f"{mt_s[True]:.3f} s, numpy {mt_s[False]:.3f} s; {len(vn)} vertices, "
          f"{len(tn)} triangles; the same mesh: {same}", flush=True)
    if not (same and len(tn) > 0):
        raise SystemExit("native and numpy marching tetrahedra disagree")
    secs_phase, peak = phase_end(torch, "mesh tool", t_phase)
    return dict(res=MESH_RES, tool_s=tool_s, steps_s=secs,
                vertices=len(v_all), color_vertices=len(v_col),
                launches=launches, native_s=mt_s[True], numpy_s=mt_s[False],
                phase_s=secs_phase, peak_mib=peak)


def run_vanilla_nerf(torch, run_net, counters, mse2psnr, scene, bg, tmp):
    """Phase 11: projects/nerf/configs/nerf_base.py at full width (8 x 256,
    frequency encodings of 10 and 4 octaves) through the CLI, --task train
    for VANILLA_STEPS steps at learning rate VANILLA_LR and its test set,
    on phase 8's 256^2 scene; the test PSNR must clear the background's by
    VANILLA_PSNR_OVER_BG dB.  No repo kernel runs on this path."""
    t_phase = phase_start(torch)
    base = Path(__file__).resolve().parent / "projects/nerf/configs/nerf_base.py"
    cfg = os.path.join(tmp, "cfg_nerf.py")
    Path(cfg).write_text(textwrap.dedent(f"""\
        _base_ = {str(base)!r}
        dataset_dir = {scene!r}
        dataset = dict(train=dict(root_dir=dataset_dir),
                       val=dict(root_dir=dataset_dir),
                       test=dict(root_dir=dataset_dir))
        log_dir = {os.path.join(tmp, "logs_nerf")!r}
        tot_train_steps = {VANILLA_STEPS}
        optim = dict(type="Adam", lr={VANILLA_LR!r}, eps=1e-15,
                     betas=(0.9, 0.99))
    """))
    from jnerf_tpu_torch.runner import Runner

    train_s = [0.0]
    orig_range = Runner.train_range

    def timed_range(self, *a, **k):
        t0 = time.perf_counter()
        out = orig_range(self, *a, **k)
        torch.cuda.synchronize()
        train_s[0] += time.perf_counter() - t0
        return out

    reset_counts(counters)
    Runner.train_range = timed_range
    try:
        runner, psnr = run_net.main(["--config-file", cfg, "--device", "cuda",
                                     "--task", "train"])
    finally:
        Runner.train_range = orig_range
    counts = read_counts(counters)
    net = runner.model
    width = [tuple(layer.w.shape) for layer in net.pts_linears]
    print(f"vanilla NeRF (nerf_base.py): {type(net).__name__} pts layers "
          f"{width}, encodings {net.pos_encoder.out_dim} / "
          f"{net.dir_encoder.out_dim}, compute {net.compute_dtype}; "
          f"{VANILLA_STEPS} steps in {train_s[0]:.3f} s = "
          f"{VANILLA_STEPS / train_s[0]:.3f} steps/s, last shape "
          f"{runner.sampler.n_rays_per_batch} x "
          f"{runner.sampler.n_samples_per_ray}; TOTAL TEST PSNR {psnr:.3f} dB, "
          f"background alone {bg:.3f} dB; kernel launches {counts}, on "
          f"{card_line()}", flush=True)
    if len(width) != 8 or width[0] != (63, 256) or net.dir_encoder.out_dim != 27:
        raise SystemExit(f"nerf_base.py did not build 8 x 256: {width}")
    if any(counts.values()):
        raise SystemExit(f"vanilla NeRF launched a repo kernel: {counts}")
    if not psnr >= bg + VANILLA_PSNR_OVER_BG:
        raise SystemExit(f"vanilla NeRF test PSNR {psnr:.3f} dB is not "
                         f"{VANILLA_PSNR_OVER_BG} dB over the background's "
                         f"{bg:.3f}")
    secs, peak = phase_end(torch, "vanilla NeRF", t_phase)
    return dict(steps=VANILLA_STEPS, steps_per_s=VANILLA_STEPS / train_s[0],
                psnr=psnr, bg_psnr=bg, phase_s=secs, peak_mib=peak)


def mesh_distance(np, neus_sdf, path):
    """(vertex count, mean |analytic SDF| of a PLY's vertices)."""
    v, _ = read_ply_vertices(np, path)
    return len(v), float(np.abs(neus_sdf(v.astype(np.float64))).mean())


def run_neus(torch, run_net, counters, tmp):
    """Phase 12: projects/neus/configs/neus_womask.py at full width through
    the CLI (--type mesh) on a DTU-format scene the port writes: the
    geometric-init mesh, --task train for NEUS_STEPS steps (a checkpoint at
    the end), then --task validate_mesh (512^3, world space)."""
    import numpy as np

    from jnerf_tpu_torch.dataset.synthetic import (
        make_synthetic_neus_scene, neus_sdf,
    )
    from jnerf_tpu_torch.runner import NeuSRunner
    from jnerf_tpu_torch.utils.config import init_cfg

    t_phase = phase_start(torch)
    if torch.backends.cuda.matmul.allow_tf32:
        raise SystemExit("TF32 matmuls are on: NeuS runs in f32")
    t0 = time.perf_counter()
    scene = make_synthetic_neus_scene(os.path.join(tmp, "neus_scene"),
                                      n_images=NEUS_IMAGES, H=NEUS_H, W=NEUS_W)
    scene_s = time.perf_counter() - t0
    base = (Path(__file__).resolve().parent
            / "projects/neus/configs/neus_womask.py")
    cfg = os.path.join(tmp, "cfg_neus.py")
    exp = os.path.join(tmp, "neus_exp")
    Path(cfg).write_text(textwrap.dedent(f"""\
        _base_ = {str(base)!r}
        dataset = dict(dataset_dir={scene!r})
        base_exp_dir = {exp!r}
        end_iter = {NEUS_STEPS}
        save_freq = {NEUS_STEPS}
    """))
    init_cfg(cfg)
    fresh = NeuSRunner(device="cuda")
    net = fresh.neus_network
    shapes = {"sdf": [tuple(layer.w.shape) for layer in net.sdf_network.layers],
              "nerf": len(net.nerf_outside.pts_linears),
              "color": [tuple(layer.w.shape)
                        for layer in net.color_network.layers]}
    r = fresh.renderer
    init_n, init_d = mesh_distance(np, neus_sdf, fresh.validate_mesh(
        world_space=True, resolution=NEUS_INIT_RES))
    del fresh, net

    losses, marks = [], []
    orig_window = NeuSRunner.train_window

    def train_window(self, n, graph=None):
        out = orig_window(self, n, graph)
        losses.append(out.clone())
        end = self.iter_step + n
        if end % self.report_freq == 0:  # its report line waits anyway
            torch.cuda.synchronize()
            marks.append((end, time.perf_counter()))
        return out

    argv = ["--config-file", cfg, "--device", "cuda", "--type", "mesh"]
    reset_counts(counters)
    NeuSRunner.train_window = train_window
    try:
        t0 = time.perf_counter()
        runner, _ = run_net.main(argv + ["--task", "train"])
        torch.cuda.synchronize()
        train_task_s = time.perf_counter() - t0
        graphs = len(runner.windows.cache)
    finally:
        NeuSRunner.train_window = orig_window
    hist = torch.cat(losses).cpu()
    # Report lines every 100 steps wait for the device: the rate between
    # the first and the last report.
    (s0, t_0), (s1, t_1) = marks[0], marks[-1]
    steps_per_s = (s1 - s0) / (t_1 - t_0)
    del runner
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again, ply = run_net.main(argv + ["--task", "validate_mesh"])
    mesh_s = time.perf_counter() - t0
    counts = read_counts(counters)
    n_v, dist = mesh_distance(np, neus_sdf, ply)
    first, last = float(hist[:100, 1].mean()), float(hist[-100:, 1].mean())
    eik = hist[:, 2]
    print(f"NeuS (neus_womask.py): scene {NEUS_IMAGES} images of "
          f"{NEUS_W}x{NEUS_H} written in {scene_s:.3f} s; SDF layers "
          f"{shapes['sdf']}, background NeRF {shapes['nerf']} layers, colour "
          f"{shapes['color']}; {r.n_samples} + {r.n_importance} + "
          f"{r.n_outside} samples, {again.batch_size} rays; {len(hist)} "
          f"steps in {len(losses)} windows ({graphs} graphs), train task "
          f"{train_task_s:.3f} s, {steps_per_s:.3f} steps/s (steps "
          f"{s0}-{s1}); colour loss first 100 {first:.5f}, "
          f"last 100 {last:.5f}; eikonal last {float(eik[-1]):.5f}, finite "
          f"{bool(torch.isfinite(eik).all())}; validate_mesh at 512^3 "
          f"{mesh_s:.3f} s (iter {again.iter_step}): {n_v} vertices, mean "
          f"|SDF| {dist:.5f}; geometric-init mesh at {NEUS_INIT_RES}^3: "
          f"{init_n} vertices, mean |SDF| {init_d:.5f}; kernel launches "
          f"{counts}, on {card_line()}", flush=True)
    if shapes["sdf"][0] != (39, 256) or shapes["sdf"][-1] != (256, 257) \
            or shapes["nerf"] != 8 or len(shapes["color"]) != 5 \
            or (r.n_samples, r.n_importance, r.n_outside) != (64, 64, 32) \
            or again.batch_size != 512:
        raise SystemExit(f"neus_womask.py did not build its full width: "
                         f"{shapes}")
    if len(hist) != NEUS_STEPS or again.iter_step != NEUS_STEPS \
            or graphs < 1:
        raise SystemExit(f"NeuS ran {len(hist)} steps ({graphs} graphs), "
                         f"validate_mesh read iter {again.iter_step}")
    if not (last <= 0.5 * first and bool(torch.isfinite(eik).all())
            and bool(torch.isfinite(hist).all())):
        raise SystemExit(f"NeuS colour loss {first:.5f} -> {last:.5f}, "
                         f"eikonal finite {bool(torch.isfinite(eik).all())}")
    if not (n_v > 1000 and dist < init_d):
        raise SystemExit(f"the NeuS mesh ({n_v} vertices) is no closer to the "
                         f"object ({dist:.5f}) than the init mesh "
                         f"({init_d:.5f})")
    if any(counts.values()):
        raise SystemExit(f"NeuS launched a repo kernel: {counts}")
    secs, peak = phase_end(torch, "NeuS", t_phase)
    return dict(steps=NEUS_STEPS, steps_per_s=steps_per_s, scene=scene,
                color_loss_first=first, color_loss_last=last,
                validate_mesh_s=mesh_s, vertices=n_v, mean_abs_sdf=dist,
                init_mean_abs_sdf=init_d, phase_s=secs, peak_mib=peak)


def write_cfg(path, base, body):
    """A user's config file: ``_base_`` = projects/<base> and ``body``."""
    full = Path(__file__).resolve().parent / "projects" / base
    Path(path).write_text(f"_base_ = {str(full)!r}\n" + textwrap.dedent(body))
    return path


def grad_diffs(grads, ref):
    """Per tensor (name, max |diff|, mean |diff|), each over the reference
    gradient's largest entry."""
    out = []
    for k, r in ref.items():
        d = (grads[k].cpu() - r).abs()
        scale = float(r.abs().max())
        out.append((k, float(d.max()) / scale, float(d.mean()) / scale))
    return out


def check_mip_small_step(torch, scene, tmp):
    """One step of a shrunk mip_base.py (256 rays, 32 samples a level, a 4 x
    64 trunk) on the card and on the CPU from the same weights, batch and
    draws: the loss at rtol MIP_SMALL_RTOL, each gradient's mean |diff|
    within MIP_SMALL_RTOL of its largest entry (f32 on both sides; the
    sums run in other orders and the IPE's sin of arguments up to ~10^3
    rounds differently), the largest printed."""
    from jnerf_tpu_torch.ops.mip import F32_EPS
    from jnerf_tpu_torch.runner import MipRunner
    from jnerf_tpu_torch.utils.config import init_cfg

    cfg = write_cfg(os.path.join(tmp, "cfg_mip_small.py"),
                    "mipnerf/configs/mip_base.py", f"""\
        dataset_dir = {scene!r}
        dataset = dict(train=dict(root_dir=dataset_dir, batch_size=256),
                       val=dict(root_dir=dataset_dir, batch_size=256),
                       test=dict(root_dir=dataset_dir, batch_size=256))
        log_dir = {os.path.join(tmp, "logs_mip_small")!r}
        num_samples = 32
        net_depth = 4
        net_width = 64
        net_width_condition = 32
        seed = 0
    """)
    init_cfg(cfg)
    gpu, cpu = MipRunner(device="cuda"), MipRunner(device="cpu")
    cpu.model.load_state_dict({k: v.cpu() for k, v in
                               gpu.model.state_dict().items()})
    rays, rgb = next(cpu.dataset["train"])
    gen = torch.Generator().manual_seed(1)
    draws = [{"u": torch.rand((256, 33), generator=gen)},
             {"u": torch.rand((256, 33), generator=gen) * (1 / 33 - F32_EPS)}]
    out = []
    for r in (gpu, cpu):
        dev = r.device
        r.model.zero_grad(set_to_none=True)
        loss, _ = r.forward_loss(
            type(rays)(*(x.to(dev) for x in rays)), rgb.to(dev),
            [{"u": d["u"].to(dev)} for d in draws])
        loss.backward()
        out.append((float(loss.detach()), {
            k: p.grad.cpu() for k, p in r.model.named_parameters()}))
    (l_gpu, g_gpu), (l_cpu, g_cpu) = out
    worst = grad_diffs(g_gpu, g_cpu)
    print(f"Mip-NeRF small step card vs CPU (256 x 2 x 32, 4 x 64): loss "
          f"{l_gpu:.7f} vs {l_cpu:.7f}; grads max/mean "
          f"{max(a for _, a, _ in worst):.2e} / "
          f"{max(b for _, _, b in worst):.2e}", flush=True)
    if not abs(l_gpu - l_cpu) <= MIP_SMALL_RTOL * l_cpu:
        raise SystemExit("the card's Mip-NeRF step loss disagrees with the "
                         "CPU's")
    if any(b > MIP_SMALL_RTOL for _, _, b in worst):
        raise SystemExit(f"the card's Mip-NeRF gradients disagree: {worst}")


def run_mip(torch, run_net, counters, scene, tmp):
    """Phase 13: projects/mipnerf/configs/mip_base.py at full width (8 x 256
    trunk, skip after layer 4, 1 x 128 colour branch, 2 levels x 128
    samples, 4096 rays; f32, TF32 off) through the CLI on phase 8's 256^2
    scene: the small card-vs-CPU step, then --task train for MIP_STEPS of
    the config's 40,001 steps (the one cut: the run's time), then --task
    test from params.pkl, whose PSNR must clear that of predicting black
    everywhere (the config's background) by MIP_PSNR_OVER_BLACK dB.  No
    repo kernel runs on this path."""
    import numpy as np

    from jnerf_tpu_torch.runner import MipRunner

    t_phase = phase_start(torch)
    if torch.backends.cuda.matmul.allow_tf32:
        raise SystemExit("TF32 matmuls are on: Mip-NeRF runs in f32")
    check_mip_small_step(torch, scene, tmp)
    cfg = write_cfg(os.path.join(tmp, "cfg_mip.py"),
                    "mipnerf/configs/mip_base.py", f"""\
        dataset_dir = {scene!r}
        dataset = dict(train=dict(root_dir=dataset_dir),
                       val=dict(root_dir=dataset_dir),
                       test=dict(root_dir=dataset_dir))
        log_dir = {os.path.join(tmp, "logs_mip")!r}
        tot_train_steps = {MIP_STEPS}
    """)
    losses, train_s = [], [0.0]
    orig_window, orig_train = MipRunner.train_window, MipRunner.train

    def train_window(self, n, graph=None):
        out = orig_window(self, n, graph)
        losses.append(out.clone())
        return out

    def train(self):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig_train(self)
        torch.cuda.synchronize()
        train_s[0] = time.perf_counter() - t0
        return out

    argv = ["--config-file", cfg, "--device", "cuda"]
    reset_counts(counters)
    MipRunner.train_window, MipRunner.train = train_window, train
    try:
        runner, last = run_net.main(argv + ["--task", "train"])
    finally:
        MipRunner.train_window, MipRunner.train = orig_window, orig_train
    train_peak = torch.cuda.max_memory_allocated() / 2**20
    graphs = len(runner.windows.cache)
    hist = torch.cat(losses).cpu()
    net, s = runner.model, runner.sampler
    trunk = [tuple(layer.w.shape) for layer in net.trunk]
    cond = [tuple(layer.w.shape) for layer in net.condition]
    del runner
    t0 = time.perf_counter()
    again, psnr = run_net.main(argv + ["--task", "test"])
    test_s = time.perf_counter() - t0
    counts = read_counts(counters)
    ds = again.dataset["test"]
    black = float(np.mean([
        -10 * np.log10(float(((ds.image(i)[..., :3] * ds.image(i)[..., 3:])
                              ** 2).mean())) for i in range(ds.n_images)]))
    first, end = float(hist[:64].mean()), float(hist[-64:].mean())
    print(f"Mip-NeRF (mip_base.py): trunk {trunk}, condition {cond}, "
          f"{again.num_levels} levels x {s.num_samples} samples, "
          f"{again.dataset['train'].batch_size} rays, lr "
          f"{again.schedule_wrap.init_lr} (at step {MIP_STEPS}: "
          f"{again.schedule_wrap.schedule(MIP_STEPS):.3e}); {len(hist)} "
          f"steps in {len(losses)} windows ({graphs} graphs) in "
          f"{train_s[0]:.3f} s = {len(hist) / train_s[0]:.3f} "
          f"steps/s, peak memory {train_peak:.1f} MiB; loss first 64 "
          f"{first:.5f}, last 64 {end:.5f}, last {last:.5f}; --task test "
          f"({ds.n_images} images, {test_s:.3f} s, iter {again.start}): TOTAL "
          f"TEST PSNR {psnr:.3f} dB, black alone {black:.3f} dB; kernel "
          f"launches {counts}, on {card_line()}", flush=True)
    if len(trunk) != 8 or trunk[0] != (48, 256) or trunk[5] != (304, 256) \
            or cond != [(283, 128)] or s.num_samples != 128 \
            or again.dataset["train"].batch_size != 4096:
        raise SystemExit(f"mip_base.py did not build its full width: {trunk}")
    if len(hist) != MIP_STEPS or again.start != MIP_STEPS or graphs < 1 \
            or not bool(torch.isfinite(hist).all()):
        raise SystemExit(f"Mip-NeRF ran {len(hist)} steps (test read "
                         f"{again.start}), losses finite "
                         f"{bool(torch.isfinite(hist).all())}")
    if any(counts.values()):
        raise SystemExit(f"Mip-NeRF launched a repo kernel: {counts}")
    if not psnr >= black + MIP_PSNR_OVER_BLACK:
        raise SystemExit(f"Mip-NeRF test PSNR {psnr:.3f} dB is not "
                         f"{MIP_PSNR_OVER_BLACK} dB over black's {black:.3f}")
    secs, peak = phase_end(torch, "Mip-NeRF", t_phase)
    return dict(steps=MIP_STEPS, steps_per_s=MIP_STEPS / train_s[0],
                psnr=psnr, black_psnr=black, loss_first=first, loss_last=end,
                phase_s=secs, peak_mib=peak)


def white_psnr(np, ds):
    """Mean PSNR of predicting white everywhere over a test split."""
    out = []
    for i in range(ds.n_images):
        tar = ds.image(i)
        tar = tar[..., :3] * tar[..., 3:] + (1 - tar[..., 3:])
        out.append(-10 * np.log10(float(((tar - 1) ** 2).mean())))
    return float(np.mean(out))


def check_svox2_small_steps(torch, scene, tmp):
    """One dense step at reso 24 and, after an upsample to 48^3 past a
    threshold of 30,000 cells, one sparse step (its TV rows passed in), on
    the card and on the CPU from the same random grid and batch: the MSE
    at rtol SVOX_SMALL_RTOL and each table's gradient within
    SVOX_SMALL_RTOL of its largest entry (the upstream gradients round in
    other orders on the card), and equal links."""
    import numpy as np

    from jnerf_tpu_torch.runner import Svox2Runner
    from jnerf_tpu_torch.utils.config import init_cfg

    cfg = write_cfg(os.path.join(tmp, "cfg_svox2_small.py"),
                    "svox2/configs/svox2_base.py", f"""\
        dataset_dir = {scene!r}
        dataset = dict(train=dict(root=dataset_dir, split='train'),
                       test=dict(root=dataset_dir, split='test'))
        log_dir = {os.path.join(tmp, "logs_svox2_small")!r}
        model = dict(reso=24, radius=1.3)
        reso_list = [[24] * 3, [48] * 3]
        sparse_cell_threshold = 30000
        density_thresh = 2.4
        sparse_dilate = 1
        batch_size = 512
    """)
    init_cfg(cfg)
    gpu, cpu = Svox2Runner(device="cuda"), Svox2Runner(device="cpu")
    rng = np.random.default_rng(0)
    d = torch.from_numpy(rng.uniform(0, 3, (24,) * 3).astype(np.float32))
    s = torch.from_numpy((rng.normal(size=(24,) * 3 + (27,)) * 0.3)
                         .astype(np.float32))
    for r in (gpu, cpu):
        with torch.no_grad():
            r.grid.density.copy_(d)
            r.grid.sh.copy_(s)
    report = []
    for mode in ("dense", "sparse"):
        if mode == "sparse":
            for r in (gpu, cpu):
                r.upsample((48, 48, 48))
            if not torch.equal(gpu.grid.links.cpu(), cpu.grid.links):
                raise SystemExit("the card's sparse links differ")
        ro, rd, rgb = cpu.dataset["train"].next_batch(512)
        cap = cpu.grid.cells.shape[0] if mode == "sparse" else 1
        gen = torch.Generator().manual_seed(2)
        rows = (torch.randint(0, cap, (1 << 18,), generator=gen),
                torch.randint(0, cap, (1 << 16,), generator=gen))
        out = []
        for r in (gpu, cpu):
            dev = r.device
            mse = r.train_step(ro.to(dev), rd.to(dev), rgb.to(dev), 0.3, 1e-2,
                               tv_rows=tuple(x.to(dev) for x in rows))
            out.append((float(mse), {k: p.grad.cpu() for k, p in
                                     r.grid.tables().items()}))
        (m_gpu, g_gpu), (m_cpu, g_cpu) = out
        worst = grad_diffs(g_gpu, g_cpu)
        report.append(f"{mode}: MSE {m_gpu:.7f} vs {m_cpu:.7f}, grads max "
                      f"{max(a for _, a, _ in worst):.2e}")
        if not abs(m_gpu - m_cpu) <= SVOX_SMALL_RTOL * m_cpu \
                or any(a > SVOX_SMALL_RTOL for _, a, _ in worst):
            raise SystemExit(f"the card's {mode} Plenoxels step disagrees "
                             f"with the CPU's: {report[-1]}")
    print("Plenoxels small steps card vs CPU (reso 24, 512 rays): "
          + "; ".join(report), flush=True)


def run_svox2(torch, run_net, counters, scene, tmp):
    """Phase 14: projects/svox2/configs/svox2_base.py at full width (256^3,
    basis 9, 5000 rays, step 0.5 voxel: 887 samples a ray dense and 1774
    sparse, the config's TV weights and rates) through the CLI on phase 8's
    scene, after the small card-vs-CPU steps.  Cuts, each for the run's
    time: n_iters 640 of 128,000 and upsamp_every 512 of 38,400, so that
    512 dense steps run at 256^3 and 128 sparse steps at 512^3.  The sigma
    learning rate's delay is off, as lr_sigma_delay_steps = 0 asks (the
    JAX package's svox2 tests set it): both packages read a 0 there as the
    default 15,000 (ROADMAP.md section 3), so the delay's multiplier is set
    to 1 as well.  density_thresh is the config's 5.0 unless no cell of
    the trained 256^3 grid reaches it; then it is lowered to the grid's
    99th-percentile density, printed.  Pass: after the dense steps the
    test PSNR clears the all-white background's by SVOX_PSNR_OVER_WHITE
    dB; after the upsample 0 < n_active < 512^3 / 4 and cap * 28 * 4 < 6e9
    (as in tests/test_svox2.py); the sparse MSE is finite and below
    SVOX_SPARSE_MSE; the .npz round trip holds density_data within f16's
    rounding (atol 2e-3, rtol 2^-11).  Every step runs as a graph window
    but each grid's first (its warm-up) and launches kernel V once, and no
    other repo kernel runs; one step's kernel V inputs of the trained dense
    and sparse grids are kept for phase 23."""
    import numpy as np

    from jnerf_tpu_torch.models.networks import SparseGrid
    from jnerf_tpu_torch.runner import Svox2Runner

    t_phase = phase_start(torch)
    check_svox2_small_steps(torch, scene, tmp)
    cfg = write_cfg(os.path.join(tmp, "cfg_svox2.py"),
                    "svox2/configs/svox2_base.py", f"""\
        dataset_dir = {scene!r}
        dataset = dict(train=dict(root=dataset_dir, split='train'),
                       test=dict(root=dataset_dir, split='test'))
        log_dir = {os.path.join(tmp, "logs_svox2")!r}
        n_iters = {SVOX_ITERS}
        upsamp_every = {SVOX_UPSAMP}
        lr_sigma_delay_steps = 0
        lr_sigma_delay_mult = 1.0
    """)
    marks = {}
    orig_train, orig_up = Svox2Runner.train, SparseGrid.upsample

    def upsample(self, new_reso):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        orig_up(self, new_reso)
        torch.cuda.synchronize()
        marks["upsample_s"] = time.perf_counter() - t0

    def train(self, n_iters=None):
        # The config's single run, cut where the upsample falls so that
        # the dense grid can be scored: the same steps in the same order.
        n_iters = n_iters or self.n_iters
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        marks["dense_mse"] = orig_train(self, self.upsamp_every)
        marks["dense_s"] = time.perf_counter() - t0
        marks["dense_peak"] = torch.cuda.max_memory_allocated() / 2**20
        marks["dense_samples"] = self.grid.n_samples_for(self.step_size)
        marks["dense_reso"] = self.grid.spec.reso
        marks["psnr"] = self.eval_psnr()
        dens = self.grid.density.detach().reshape(-1)
        marks["max_density"] = float(dens.max())
        thresh = self.grid.density_thresh
        if lower_density_thresh(torch, self) != thresh:
            marks["lowered"] = self.grid.density_thresh
        marks["graphs dense"] = len(self.windows.cache)
        marks["voxel dense"] = capture_voxel_inputs(torch, self,
                                                    self.batch_size)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        mse = orig_train(self, n_iters - self.upsamp_every)
        torch.cuda.synchronize()
        marks["sparse_s"] = time.perf_counter() - t0
        marks["sparse_peak"] = torch.cuda.max_memory_allocated() / 2**20
        marks["graphs sparse"] = len(self.windows.cache)
        marks["voxel sparse"] = capture_voxel_inputs(torch, self,
                                                     self.batch_size)
        return mse

    reset_counts(counters)
    Svox2Runner.train, SparseGrid.upsample = train, upsample
    try:
        runner, mse = run_net.main(["--config-file", cfg, "--device", "cuda",
                                    "--task", "train"])
    finally:
        Svox2Runner.train, SparseGrid.upsample = orig_train, orig_up
    counts = read_counts(counters)
    grid = runner.grid
    white = white_psnr(np, runner.dataset["test"])
    n_active = int((grid.cells >= 0).sum())
    cap = int(grid.cells.shape[0])
    t0 = time.perf_counter()
    path = runner.save()
    save_s = time.perf_counter() - t0
    before = grid.density_data.detach().clone()
    t0 = time.perf_counter()
    runner.load(path)
    load_s = time.perf_counter() - t0
    n = int(grid.links.max()) + 1
    got = grid.density_data.detach()[:n]
    npz_err = float((got - before[:n]).abs().max())
    npz_ok = bool(((got - before[:n]).abs()
                   <= 2e-3 + 2.0 ** -11 * before[:n].abs()).all())
    dense_steps = SVOX_UPSAMP
    sparse_steps = SVOX_ITERS - SVOX_UPSAMP
    lowered = marks.get("lowered")
    print(f"Plenoxels (svox2_base.py): {dense_steps} dense steps at "
          f"{marks['dense_reso']} "
          f"({marks['dense_samples']} samples a ray) in "
          f"{marks['dense_s']:.3f} s = {dense_steps / marks['dense_s']:.3f} "
          f"steps/s, peak memory {marks['dense_peak']:.1f} MiB, MSE "
          f"{marks['dense_mse']:.5f}; test PSNR {marks['psnr']:.3f} dB, white "
          f"alone {white:.3f} dB; largest density {marks['max_density']:.4f}, "
          f"density_thresh "
          + (f"lowered to {lowered:.5f}" if lowered is not None
             else f"{grid.density_thresh}")
          + f"; upsample to {grid.spec.reso} in {marks['upsample_s']:.3f} s: "
          f"{n_active} active cells (cap {cap}, {cap * 28 * 4 / 1e9:.3f} GB); "
          f"{sparse_steps} sparse steps ({grid.n_samples_for(runner.step_size)}"
          f" samples a ray) in {marks['sparse_s']:.3f} s = "
          f"{sparse_steps / marks['sparse_s']:.3f} steps/s incl. the upsample, "
          f"peak memory {marks['sparse_peak']:.1f} MiB, last MSE {mse:.5f}; "
          f".npz save {save_s:.3f} s ({os.path.getsize(path) / 2**20:.1f} MiB), "
          f"load {load_s:.3f} s, density_data max |diff| {npz_err:.2e}; "
          f"graphs dense {marks['graphs dense']}, sparse "
          f"{marks['graphs sparse']}; kernel launches {counts}, on "
          f"{card_line()}", flush=True)
    if runner.gstep != SVOX_ITERS or not grid.sparse \
            or marks["dense_reso"] != (256, 256, 256) \
            or grid.spec.reso != (512, 512, 512) or grid.spec.basis_dim != 9 \
            or runner.batch_size != 5000:
        raise SystemExit(f"Plenoxels ran {runner.gstep} steps, ended at "
                         f"{grid.spec}, sparse {grid.sparse}")
    if not marks["psnr"] >= white + SVOX_PSNR_OVER_WHITE:
        raise SystemExit(f"Plenoxels dense test PSNR {marks['psnr']:.3f} dB "
                         f"is not {SVOX_PSNR_OVER_WHITE} dB over white's "
                         f"{white:.3f}")
    if not (0 < n_active < 512 ** 3 // 4 and cap * 28 * 4 < 6e9):
        raise SystemExit(f"the sparse grid holds {n_active} cells, cap {cap}")
    if not (np.isfinite(mse) and mse < SVOX_SPARSE_MSE):
        raise SystemExit(f"the sparse MSE is {mse}")
    if not npz_ok:
        raise SystemExit(f"the .npz round trip moved density_data by "
                         f"{npz_err}")
    if counts.pop("V") != SVOX_ITERS or any(counts.values()) \
            or marks["graphs dense"] < 1 or marks["graphs sparse"] < 1:
        raise SystemExit(f"Plenoxels did not launch kernel V once a step, "
                         f"launched another kernel ({counts}), or ran no "
                         f"window as a graph")
    secs, peak = phase_end(torch, "Plenoxels", t_phase)
    return dict(dense_steps_per_s=dense_steps / marks["dense_s"],
                sparse_steps_per_s=sparse_steps / marks["sparse_s"],
                psnr=marks["psnr"], white_psnr=white, n_active=n_active,
                cap=cap, save_s=save_s, phase_s=secs, peak_mib=peak,
                launches=SVOX_ITERS,
                voxel={"dense 256^3": marks["voxel dense"],
                       "sparse 512^3": marks["voxel sparse"]})


def mini_small_step(torch, name, make, loss_of):
    """One step of a mini-project's loss on the card and on the CPU from
    the same weights and draws: ``make()`` builds the CPU model,
    ``loss_of(model, device)`` its loss.  The loss within MINI_SMALL_RTOL
    relative, the largest gradient |diff| within MINI_SMALL_RTOL of the
    largest gradient entry."""
    cpu = make()
    gpu = make().to("cuda")
    gpu.load_state_dict(cpu.state_dict())
    out = []
    for model, dev in ((gpu, "cuda"), (cpu, "cpu")):
        loss = loss_of(model, dev)
        loss.backward()
        out.append((float(loss.detach()), {
            k: p.grad.cpu() for k, p in model.named_parameters()
            if p.grad is not None}))
    (l_gpu, g_gpu), (l_cpu, g_cpu) = out
    if set(g_gpu) != set(g_cpu):
        raise SystemExit(f"{name}: the card's step reached other parameters")
    top = max(float(g.abs().max()) for g in g_cpu.values())
    if not top > 0:
        raise SystemExit(f"{name}: the small step has no gradient")
    diff = max(float((g_gpu[k] - g).abs().max()) for k, g in g_cpu.items())
    print(f"{name} small step card vs CPU: loss {l_gpu:.7f} vs {l_cpu:.7f}; "
          f"largest grad |diff| {diff:.3e} of the largest entry {top:.3e} "
          f"({diff / top:.2e})", flush=True)
    if not abs(l_gpu - l_cpu) <= MINI_SMALL_RTOL * abs(l_cpu):
        raise SystemExit(f"the card's {name} step loss disagrees with the "
                         "CPU's")
    if not diff <= MINI_SMALL_RTOL * top:
        raise SystemExit(f"the card's {name} gradients disagree")


def run_pixelnerf(torch, counters, tmp):
    """Phase 15: pixelNeRF through its script's main (--synthetic, --device
    cuda, PIX_EPOCHS epochs) at the JAX script's widths, after one small
    step (5 views of 32^2, a 32-wide trunk, 256 rays x 16 samples) on the
    card against the CPU.  Pass: the second epoch's mean loss below the
    first's, every loss finite, no repo kernel launched, and
    pixelnerf.pkl, loaded into a fresh model, renders a batch within 1e-6
    of the trained model.  Returns steps/s, the epochs' losses and the
    peak memory."""
    import pickle

    import numpy as np

    from jnerf_tpu_torch.projects.pixelnerf import main as pix
    from jnerf_tpu_torch.utils.convert import jax_params_to_state_dict

    t_phase = phase_start(torch)
    images, poses, focal = pix.make_synthetic(5, 32, 32)
    ro, rd, rgb = (torch.as_tensor(a[:256]) for a in pix.camera_rays(
        images[3:], poses[3:], focal))
    u = torch.rand((16,), generator=torch.Generator().manual_seed(1))

    def loss_of(model, dev):
        return pix.loss_fn(model, torch.as_tensor(images[:3], device=dev),
                           poses[:3], focal, ro.to(dev), rd.to(dev),
                           rgb.to(dev), u.to(dev), 16)

    mini_small_step(torch, "pixelNeRF",
                    lambda: pix.build_model("cpu", net_width=32), loss_of)
    if torch.backends.cudnn.allow_tf32 \
            or torch.backends.cuda.matmul.allow_tf32:
        raise SystemExit("TF32 is on: pixelNeRF runs in f32")
    out = os.path.join(tmp, "pixelnerf")
    reset_counts(counters)
    model, hist = pix.main(["--synthetic", "--epochs", str(PIX_EPOCHS),
                            "--out", out, "--device", "cuda"])
    counts = read_counts(counters)
    train_peak = torch.cuda.max_memory_allocated() / 2**20
    steps = len(hist["step_loss"])
    net = model["net"]
    print(f"pixelNeRF (the JAX script's widths: encoder "
          f"{model['enc'].out_channels} channels, trunk {net.net_width}, "
          f"{pix.N_SAMPLES} samples, batch 2048): {steps} steps in "
          f"{hist['seconds']:.3f} s = {steps / hist['seconds']:.3f} steps/s, "
          f"peak memory {train_peak:.1f} MiB; epoch losses "
          f"{[round(x, 6) for x in hist['epoch_loss']]}; kernel launches "
          f"{counts}, on {card_line()}", flush=True)
    if model["enc"].out_channels != 512 or net.net_width != 512 \
            or steps != PIX_EPOCHS * (21 * 100 * 100 // 2048):
        raise SystemExit("pixelNeRF did not run at the script's widths")
    if not np.isfinite(hist["step_loss"]).all() \
            or not hist["epoch_loss"][1] < hist["epoch_loss"][0]:
        raise SystemExit(f"pixelNeRF's loss did not fall: "
                         f"{hist['epoch_loss']}")
    if any(counts.values()):
        raise SystemExit(f"pixelNeRF launched a repo kernel: {counts}")
    with open(os.path.join(out, "pixelnerf.pkl"), "rb") as f:
        again = pix.build_model("cuda", seed=0)
        again.load_state_dict(jax_params_to_state_dict(pickle.load(f)))
    images, poses, focal = pix.make_synthetic()
    ro, rd, rgb = (torch.as_tensor(a[:2048], device="cuda") for a in
                   pix.camera_rays(images[3:], poses[3:], focal))
    refs = torch.as_tensor(images[:3], device="cuda")
    u = torch.full((pix.N_SAMPLES,), 0.5, device="cuda")
    with torch.no_grad():
        a, b = (pix.loss_fn(m, refs, poses[:3], focal, ro, rd, rgb, u)
                for m in (model, again))
    if not (bool(torch.isfinite(a)) and abs(float(a) - float(b)) <= 1e-6):
        raise SystemExit(f"pixelnerf.pkl renders another loss: {float(a)} "
                         f"vs {float(b)}")
    secs, peak = phase_end(torch, "pixelNeRF", t_phase)
    return dict(steps=steps, steps_per_s=steps / hist["seconds"],
                epoch_loss=hist["epoch_loss"], train_peak_mib=train_peak,
                phase_s=secs, peak_mib=peak)


def run_recursive_nerf(torch, counters, tmp):
    """Phase 16: Recursive-NeRF through its script's main (--synthetic,
    --device cuda) at the JAX script's widths, REC_ITERS iterations with
    step1/2/3 at REC_STAGES, after one small step at level 3 (head_num 8,
    W=64, 128 rays x 16 samples, anchors from a k-means split) on the card
    against the CPU.  Pass: the three `stage -> level` transitions, the
    last 50 iterations' MSE below the first 50's, every MSE finite, no
    repo kernel launched, and recursive_nerf.pkl, loaded into a fresh
    model, renders a batch within 1e-6 of the trained model.  Returns
    steps/s a stage and the peak memory."""
    import pickle

    import numpy as np

    from jnerf_tpu_torch.models.networks.recursive_nerf import split_anchors
    from jnerf_tpu_torch.projects.pixelnerf.main import (
        camera_rays, make_synthetic,
    )
    from jnerf_tpu_torch.projects.recursive_nerf import main as rec
    from jnerf_tpu_torch.utils.convert import jax_params_to_state_dict

    t_phase = phase_start(torch)
    images, poses, focal = make_synthetic(2, 16, 16)
    ro, rd, rgb = (torch.as_tensor(a[::4]) for a in camera_rays(
        images, poses, focal))
    u = torch.rand((16,), generator=torch.Generator().manual_seed(2))

    def make():
        model = rec.build_model("cpu", width=64)
        with torch.no_grad():
            _, unc, pts = rec.render(model, ro, rd, u, 3, 16)
        return split_anchors(model, pts, unc.reshape(-1))

    def loss_of(model, dev):
        return rec.loss_fn(model, ro.to(dev), rd.to(dev), rgb.to(dev),
                           u.to(dev), 3, 16)[0]

    mini_small_step(torch, "Recursive-NeRF", make, loss_of)
    out = os.path.join(tmp, "recursive_nerf")
    step1, step2, step3 = REC_STAGES
    reset_counts(counters)
    model, hist = rec.main([
        "--synthetic", "--n-iters", str(REC_ITERS), "--step1", str(step1),
        "--step2", str(step2), "--step3", str(step3), "--out", out,
        "--device", "cuda"])
    counts = read_counts(counters)
    train_peak = torch.cuda.max_memory_allocated() / 2**20
    mse = np.asarray(hist["mse"])
    first, last = float(mse[:50].mean()), float(mse[-50:].mean())
    rates = {f"level {lvl}": n / s for lvl, n, s in hist["stages"] if n}
    print(f"Recursive-NeRF (the JAX script's widths: W {model.W}, "
          f"{model.node_num} nodes, {model.linear_num} linears, 1024 rays x "
          f"64 samples): {len(mse)} iterations, steps/s "
          f"{ {k: round(v, 3) for k, v in rates.items()} }, transitions "
          f"{hist['transitions']}, peak memory {train_peak:.1f} MiB; MSE "
          f"first 50 {first:.5f}, last 50 {last:.5f}; kernel launches "
          f"{counts}, on {card_line()}", flush=True)
    if (model.W, model.node_num, model.linear_num) != (256, 15, 54):
        raise SystemExit("Recursive-NeRF did not run at the script's widths")
    if len(mse) != REC_ITERS or hist["transitions"] != [1, 2, 3] \
            or not np.isfinite(mse).all():
        raise SystemExit(f"Recursive-NeRF ran {len(mse)} iterations, "
                         f"transitions {hist['transitions']}")
    if not last < first:
        raise SystemExit(f"Recursive-NeRF's MSE did not fall: {first} -> "
                         f"{last}")
    if any(counts.values()):
        raise SystemExit(f"Recursive-NeRF launched a repo kernel: {counts}")
    again = rec.build_model("cuda", seed=1)
    with open(os.path.join(out, "recursive_nerf.pkl"), "rb") as f:
        again.load_state_dict(jax_params_to_state_dict(pickle.load(f)))
    images, poses, focal = make_synthetic(n_images=16, H=80, W=80)
    ro, rd, rgb = (torch.as_tensor(a[::100], device="cuda") for a in
                   camera_rays(images, poses, focal))
    u = torch.full((64,), 0.5, device="cuda")
    with torch.no_grad():
        a, b = (rec.loss_fn(m, ro, rd, rgb, u, 3)[1] for m in (model, again))
    if not (bool(torch.isfinite(a)) and abs(float(a) - float(b)) <= 1e-6):
        raise SystemExit(f"recursive_nerf.pkl renders another MSE: "
                         f"{float(a)} vs {float(b)}")
    secs, peak = phase_end(torch, "Recursive-NeRF", t_phase)
    return dict(steps_per_s=rates, mse_first=first, mse_last=last,
                train_peak_mib=train_peak, phase_s=secs, peak_mib=peak)


def grad_gaps(got, ref):
    """Per gradient tensor, max |diff| over its largest entry."""
    return {k: float((got[k] - g).abs().max()) / float(g.abs().max())
            for k, g in ref.items()}


def run_parallel(torch):
    """Phase 17: data parallelism (`jnerf_tpu_torch/parallel`).  Two ranks
    share the card over gloo in `dryrun_multichip(2)`: the collectives
    checked on CUDA tensors, the flagship step after the step-300 refresh
    in bf16 (the JAX dry run's config) and in f32, and the two-window
    train_range.  This process then runs each flagship step alone from the
    same seed (mesh=None) and holds every rank to it: in f32 every gradient
    within 1e-5 of its largest entry, in both the loss at rtol 1e-5 and the
    grid at rtol 1e-5 / atol 1e-6 with the bitfield equal; kernel B
    launched once and kernel F at least once in each rank's step.  Then `dryrun_multichip(1)`: NCCL at
    world size 1, the collectives run.  Returns each rank's launches."""
    from jnerf_tpu_torch.parallel import dryrun

    t_phase = phase_start(torch)
    if dryrun.choose_backend(2, "cuda") != "gloo":
        raise SystemExit("two ranks on one card must take gloo")
    t0 = time.perf_counter()
    ranks = dryrun.dryrun_multichip(2, device="cuda")
    gloo_s = time.perf_counter() - t0
    dev = torch.device("cuda")
    fails = []
    for key, spec in (("flagship", dryrun.flagship_spec()),
                      ("flagship_f32", dryrun.flagship_spec(fp16=False))):
        one = dryrun.step_case(None, dev, spec)
        for r, res in enumerate(ranks):
            got = res[key]
            loss_gap = abs(got["loss"] - one["loss"]) / abs(one["loss"])
            grid = got["grid"]["density_grid"] - one["grid"]["density_grid"]
            grid_ok = bool((grid.abs() <= 1e-6 + 1e-5
                            * one["grid"]["density_grid"].abs()).all())
            bits = int((got["grid"]["bitfield"]
                        != one["grid"]["bitfield"]).sum())
            gaps = grad_gaps(got["grads"], one["grads"])
            print(f"parallel {key} rank {r}: loss {got['loss']:.7f} vs "
                  f"{one['loss']:.7f} (one process), rel gap {loss_gap:.2e}; "
                  f"grid max |diff| {float(grid.abs().max()):.2e}, {bits} "
                  f"bitfield cells differ; gradient max |diff| / largest "
                  "entry " + ", ".join(f"{k} {v:.2e}" for k, v in gaps.items()),
                  flush=True)
            if not loss_gap <= 1e-5:
                fails.append(f"{key} rank {r}: loss")
            if not (grid_ok and bits == 0):
                fails.append(f"{key} rank {r}: grid")
            if key == "flagship_f32" and max(gaps.values()) > 1e-5:
                fails.append(f"{key} rank {r}: gradients")
        print(f"parallel {key}: steps/s per rank "
              f"{[round(r[key]['steps_per_s'], 3) for r in ranks]} "
              f"(8 steps after the compared one), one process "
              f"{one['steps_per_s']:.3f}; step s per rank "
              f"{[round(r[key]['step_s'], 4) for r in ranks]}, one process "
              f"{one['step_s']:.4f}; refresh s per rank "
              f"{[round(r[key]['refresh_s'], 4) for r in ranks]}, one "
              f"process {one['refresh_s']:.4f}; peak MiB per rank "
              f"{[round(r[key]['peak_mib'], 1) for r in ranks]}, one process "
              f"{one['peak_mib']:.1f}; model rows per rank "
              f"{[r[key]['model_rows'] for r in ranks]} vs "
              f"{one['model_rows']}; launches per rank "
              f"{[r[key]['launches']['step'] for r in ranks]}, on "
              f"{card_line()}", flush=True)
        for r in ranks:
            step = r[key]["launches"]["step"]
            if step["B"] != 1 or step["F"] < 1:
                fails.append(f"{key}: launches {step}")
    wins = [r["windows"] for r in ranks]
    print(f"parallel windows: shapes per rank {[w['shapes'] for w in wins]}, "
          f"steps/s per rank {[round(w['steps_per_s'], 3) for w in wins]}, "
          f"peak MiB per rank {[round(w['peak_mib'], 1) for w in wins]}",
          flush=True)
    if not all(w["adapt_armed"] and len(w["shapes"]) == 2 for w in wins):
        fails.append("windows")
    if fails:
        raise SystemExit(f"phase 17 failed: {fails}")
    if dryrun.choose_backend(1, "cuda") != "nccl":
        raise SystemExit("one rank on one card must take NCCL")
    t0 = time.perf_counter()
    nccl = dryrun.dryrun_multichip(1, device="cuda")[0]
    nccl_s = time.perf_counter() - t0
    step = nccl["flagship"]["launches"]["step"]
    if step["B"] != 1 or step["F"] < 1:
        raise SystemExit(f"the NCCL step launched {step}")
    print(f"parallel: gloo x2 {gloo_s:.3f} s, NCCL x1 {nccl_s:.3f} s "
          f"(flagship steps/s {nccl['flagship']['steps_per_s']:.3f}), on "
          f"{card_line()}", flush=True)
    secs, peak = phase_end(torch, "parallel", t_phase)
    return dict(launches=[r["flagship"]["launches"] for r in ranks],
                nccl_launches=nccl["flagship"]["launches"], phase_s=secs)


def mean_colour_psnr(torch, ds):
    """Mean PSNR, over a split's images (opaque), of predicting each
    image's mean colour everywhere."""
    out = []
    for i in range(ds.n_images):
        img = torch.from_numpy(ds.image(i)[..., :3]).double()
        mse = float(((img - img.mean(dim=(0, 1))) ** 2).mean())
        out.append(-10.0 * math.log10(mse))
    return sum(out) / len(out)


class Stopwatch:
    """Wraps ``owner.name`` (a function or method) to add up its seconds
    and calls until ``restore()``; ``sync`` (e.g. torch.cuda.synchronize)
    runs before each call's clock stops."""

    def __init__(self, owner, name, sync=None):
        self.owner, self.name = owner, name
        self.orig = getattr(owner, name)
        self.seconds, self.calls = 0.0, 0
        orig, watch = self.orig, self

        def timed(*a, **k):
            t0 = time.perf_counter()
            out = orig(*a, **k)
            if sync is not None:
                sync()
            watch.seconds += time.perf_counter() - t0
            watch.calls += 1
            return out

        setattr(owner, name, timed)

    def restore(self):
        setattr(self.owner, self.name, self.orig)


def capture_config(path, base, scene, log_dir, steps):
    """A user's config over a capture: ``base`` (ngp_fox.py or
    ngp_llff.py) with the data, log directory and step count overridden."""
    base = Path(__file__).resolve().parent / "projects/ngp/configs" / base
    Path(path).write_text(textwrap.dedent(f"""\
        _base_ = {str(base)!r}
        dataset_dir = {scene!r}
        dataset = dict(train=dict(root_dir=dataset_dir),
                       val=dict(root_dir=dataset_dir),
                       test=dict(root_dir=dataset_dir))
        log_dir = {log_dir!r}
        tot_train_steps = {steps}
    """))
    return path


def capture_tasks(torch, run_net, counters, cfg, steps, tasks):
    """--task train (timed steps, peak memory) and then each of ``tasks``
    through the CLI in this process, each task's launches counted; returns
    (the train task's runner, results)."""
    from jnerf_tpu_torch.runner import Runner

    argv = ["--config-file", cfg, "--device", "cuda"]
    steps_watch = Stopwatch(Runner, "train_range", torch.cuda.synchronize)
    try:
        reset_counts(counters)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        runner, psnr = run_net.main(argv + ["--task", "train"])
        torch.cuda.synchronize()
        res = {"train": dict(task_s=time.perf_counter() - t0, psnr=psnr,
                             launches=read_counts(counters),
                             steps_per_s=steps / steps_watch.seconds,
                             peak_mib=torch.cuda.max_memory_allocated()
                             / 2**20)}
    finally:
        steps_watch.restore()
    for task in tasks:
        reset_counts(counters)
        t0 = time.perf_counter()
        _, out = run_net.main(argv + ["--task", task])
        torch.cuda.synchronize()
        res[task] = dict(task_s=time.perf_counter() - t0, out=out,
                         launches=read_counts(counters))
    return runner, res


def check_capture_run(name, runner, res, bar, cascades, n_entries, tasks):
    """The cascade count, the hash table's size, the test PSNRs against
    ``bar`` and each other, and kernels F and B in every task that
    trains (F alone in those that only render), no other kernel."""
    spec = runner.model.pos_encoder.spec
    n_casc = runner.sampler.grid_config.max_cascade + 1
    psnr, again = res["train"]["psnr"], res["test"]["out"]
    print(f"{name}: {n_casc} grid cascades (const_dt "
          f"{runner.sampler.const_dt}, cone angle "
          f"{runner.sampler.march_config.cone_angle:.6f}), table "
          f"{spec.n_entries} entries ({sum(s < r ** 3 for s, r in zip(spec.level_sizes, spec.resolutions))} "
          f"hashed levels, per-level scale {spec.per_level_scale:.4f}); "
          f"{res['train']['steps_per_s']:.3f} steps/s, train task "
          f"{res['train']['task_s']:.3f} s, peak memory "
          f"{res['train']['peak_mib']:.1f} MiB; TOTAL TEST PSNR {psnr:.3f} "
          f"dB (train task), {again:.3f} dB (--task test), bar {bar:.3f} dB; "
          + "; ".join(f"launches {t} {res[t]['launches']}"
                      for t in ("train",) + tasks), flush=True)
    if n_casc != cascades or spec.n_entries != n_entries:
        raise SystemExit(f"{name}: {n_casc} cascades and {spec.n_entries} "
                         f"entries, not {cascades} and {n_entries}")
    if not (psnr >= bar and again >= bar
            and abs(again - psnr) <= CLI_TEST_RETEST):
        raise SystemExit(f"{name}: test PSNR {psnr:.3f} / {again:.3f} dB "
                         f"against the bar {bar:.3f} dB")
    for task in ("train",) + tasks:
        n = res[task]["launches"]
        trains = task == "train"
        if n["F"] <= 0 or (n["B"] <= 0 if trains else n["B"] != 0) \
                or any(n[k] for k in n if k not in ("F", "B")):
            raise SystemExit(f"{name} --task {task} did not go through "
                             f"kernels F and B alone: {n}")


def run_captures(torch, run_net, hash_nbr, counters, tmp):
    """Phase 18: the real-capture configs through the CLI on captures that
    the port writes in their layouts: ngp_fox.py (train, test) on a
    fox-layout capture and ngp_llff.py (train, test, render) on an
    LLFF-layout one; kernels F and B checked and timed on two steps' kept
    samples of each trained field.  Returns the results and checks."""
    from jnerf_tpu_torch.dataset import dataset_util, llff_dataset
    from jnerf_tpu_torch.dataset.synthetic import (
        make_fox_capture, make_llff_capture,
    )
    from jnerf_tpu_torch.runner import runner as runner_module
    from jnerf_tpu_torch.utils.mp4 import describe

    t_phase = phase_start(torch)
    out, hs = {}, {}
    # (a) the fox layout: 50 + 2 JPEGs at 1080 x 1920.
    fox = os.path.join(tmp, "fox")
    enc = Stopwatch(dataset_util, "encode_jpeg")
    try:
        t0 = time.perf_counter()
        make_fox_capture(fox, n_train=50, n_test=2, H=FOX_HW[0],
                         W=FOX_HW[1], device="cuda")
        write_s = time.perf_counter() - t0
    finally:
        enc.restore()
    files = sorted(os.listdir(os.path.join(fox, "images")))
    t0 = time.perf_counter()
    shapes = {dataset_util.read_image_u8(os.path.join(fox, "images", f)).shape
              for f in files}
    dec_s = time.perf_counter() - t0
    size = sum(os.path.getsize(os.path.join(fox, "images", f)) for f in files)
    print(f"fox capture: {len(files)} JPEGs of {sorted(shapes)} (quality 95, "
          f"{size / 2**20:.1f} MiB) written in {write_s:.3f} s, of which "
          f"encode {enc.seconds:.3f} s ({enc.calls} calls, "
          f"{1e3 * enc.seconds / enc.calls:.1f} ms each); decode of the "
          f"{len(files)} {dec_s:.3f} s ({1e3 * dec_s / len(files):.1f} ms "
          f"each), on {card_line()}", flush=True)
    if len(files) != 52 or shapes != {(*FOX_HW, 3)}:
        raise SystemExit("fox capture: wrong files or shapes")
    cfg = capture_config(os.path.join(tmp, "cfg_fox.py"), "ngp_fox.py", fox,
                         os.path.join(tmp, "logs_fox"), FOX_STEPS)
    runner, res = capture_tasks(torch, run_net, counters, cfg, FOX_STEPS,
                                ("test",))
    bar = mean_colour_psnr(torch, runner.dataset["test"]) \
        + CAPTURE_PSNR_OVER_MEAN
    check_capture_run("fox", runner, res, bar, FOX_CASCADES, FOX_N_ENTRIES,
                      ("test",))
    spec = runner.model.pos_encoder.spec
    pos, g = capture_steps(runner, hash_nbr.HashEncode, FOX_STEPS, 2)
    del runner
    hs["fox"] = check_hash(torch, hash_nbr, "fox field aabb 4", spec, pos, g)
    hs["fox"]["n"] = pos.shape[0]
    del pos, g
    out["fox"] = dict(res, encode_s=enc.seconds, decode_s=dec_s, bar=bar,
                      frames=len(files))

    # (b) the LLFF layout: 20 JPEGs at 4032 x 3024, minified by 8.
    llff = os.path.join(tmp, "llff")
    enc = Stopwatch(dataset_util, "encode_jpeg")
    try:
        t0 = time.perf_counter()
        make_llff_capture(llff, n_views=20, H=LLFF_HW[0], W=LLFF_HW[1],
                          device="cuda")
        write_s = time.perf_counter() - t0
    finally:
        enc.restore()
    print(f"llff capture: 20 JPEGs of {LLFF_HW[1]}x{LLFF_HW[0]} written in "
          f"{write_s:.3f} s, "
          f"of which encode {enc.seconds:.3f} s", flush=True)
    cfg = capture_config(os.path.join(tmp, "cfg_llff.py"), "ngp_llff.py",
                         llff, os.path.join(tmp, "logs_llff"), LLFF_STEPS)
    dec = Stopwatch(llff_dataset, "read_image_u8")
    frame_enc = Stopwatch(runner_module.Mp4Writer, "write")
    try:
        runner, res = capture_tasks(torch, run_net, counters, cfg, LLFF_STEPS,
                                    ("test", "render"))
    finally:
        dec.restore()
        frame_enc.restore()
    print(f"llff minify: {dec.calls} JPEGs decoded in {dec.seconds:.3f} s "
          f"({1e3 * dec.seconds / max(dec.calls, 1):.1f} ms each), "
          f"{runner.W}x{runner.H} PNGs", flush=True)
    small = (LLFF_HW[1] // 8, LLFF_HW[0] // 8)
    if dec.calls != 20 or (runner.W, runner.H) != small:
        raise SystemExit("llff: the minify did not decode the 20 JPEGs")
    bar = mean_colour_psnr(torch, runner.dataset["test"]) \
        + CAPTURE_PSNR_OVER_MEAN
    check_capture_run("llff", runner, res, bar, LLFF_CASCADES,
                      LLFF_N_ENTRIES, ("test", "render"))
    video = describe(res["render"]["out"])
    per_frame = res["render"]["task_s"] / RENDER_FRAMES
    print(f"llff render: {res['render']['out']} {video}; "
          f"{per_frame:.4f} s a frame (the task over {RENDER_FRAMES} frames; "
          f"MPEG-4 encode {frame_enc.seconds / max(frame_enc.calls, 1):.4f} s "
          f"a frame)", flush=True)
    if video != dict(video, boxes=["ftyp", "moov", "mdat"], entry="mp4v",
                     width=small[0], height=small[1], samples=RENDER_FRAMES,
                     sync_samples=RENDER_FRAMES, fps=float(RENDER_FPS),
                     mdat_filled=True) or frame_enc.calls != RENDER_FRAMES:
        raise SystemExit(f"llff render: the mp4 is wrong: {video}")
    spec = runner.model.pos_encoder.spec
    pos, g = capture_steps(runner, hash_nbr.HashEncode, LLFF_STEPS, 2)
    del runner
    hs["llff"] = check_hash(torch, hash_nbr, "llff field aabb 64", spec, pos,
                            g)
    hs["llff"]["n"] = pos.shape[0]
    del pos, g
    out["llff"] = dict(res, minify_decode_s=dec.seconds, bar=bar,
                       video=video, render_s_per_frame=per_frame,
                       frame_encode_s=frame_enc.seconds / RENDER_FRAMES)
    secs, peak = phase_end(torch, "real-capture", t_phase)
    out.update(phase_s=secs, peak_mib=peak)
    return out, hs


def positive(x) -> bool:
    return isinstance(x, (int, float)) and math.isfinite(x) and x > 0


def run_tools(torch, counters):
    """Phase 19: the port's measuring tools through their entry points'
    main in this process, each with the launch counters set to 0 just
    before it and read just after.  Returns the launches, seconds and
    results, and raises if a tool failed, printed a non-finite or
    non-positive number, or ran without kernels F and B."""
    import contextlib
    import io

    from jnerf_tpu_torch import bench
    from jnerf_tpu_torch.tools import (
        bench_psnr, probe_cap19, probe_demand, probe_tiers, time_step,
    )

    t_phase = phase_start(torch)
    out = {"launches": {}, "seconds": {}}

    def counted(name, fn):
        reset_counts(counters)
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        out["seconds"][name] = time.perf_counter() - t0
        counts = out["launches"][name] = read_counts(counters)
        if not (counts["F"] > 0 and counts["B"] > 0):
            raise SystemExit(f"{name}: kernels F and B did not both run: "
                             f"{counts}")
        return res

    for s in bench.SHAPES:
        argv = ["--encoder", s] + ([] if s == bench.SHAPES[0]
                                   else TOOL_BENCH_SHORT)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            code = counted(f"bench {s}", lambda: bench.main(argv))
        text = buf.getvalue()
        print(text, end="", flush=True)
        line = json.loads(text.strip().splitlines()[-1])
        if code != 0 or "errors" in line["extra"] \
                or not positive(line["value"]):
            raise SystemExit(f"bench {s} failed (exit {code}): {line}")
        out[f"bench {s}"] = line
    head = ["--encoder", "f8l4", "--compact", "--compact-m", "17",
            "--march-factor", "2", "--fast-cap", "524288"]
    q = counted("bench_psnr", lambda: bench_psnr.main(
        head + ["--scene", "hard", "--iters", str(TOOL_STEPS)]))
    if not (positive(q["value"]) and positive(q["extra"]["iters_per_s"])):
        raise SystemExit(f"bench_psnr: {q}")
    out["bench_psnr"] = q
    tiers = counted("probe_tiers", lambda: probe_tiers.main(
        ["--encoder", "f8l4", "--compact-m", "17", "--march-factor", "2",
         "--fast-cap", "524288", "--steps", str(TOOL_STEPS)]))
    names = ("full", "march", "model_f", "model_fb", "comp_fb", "optim")
    if not all(positive(tiers[t]) and positive(tiers["event_ms"][t])
               and positive(tiers["kernel_ms"][t]) for t in names):
        raise SystemExit(f"probe_tiers: {tiers}")
    out["probe_tiers"] = tiers
    demand = counted("probe_demand", lambda: probe_demand.main(
        ["--steps", str(TOOL_STEPS)]))
    if not all(positive(w["measured_per_step"]) for w in demand["trace"]) \
            or not all(positive(t["kept_samples"])
                       and positive(t["slot_occupancy"])
                       and math.isfinite(t["frac_samples_dropped"])
                       for t in demand["trials"]):
        raise SystemExit(f"probe_demand: {demand}")
    steps = counted("time_step", lambda: time_step.main(
        ["--steps", str(TOOL_STEADY_STEPS)]))
    if not all(positive(host) and positive(dev)
               for host, dev in steps.values()):
        raise SystemExit(f"time_step: {steps}")
    out["time_step"] = steps
    cap19 = counted("probe_cap19", lambda: probe_cap19.main([]))
    for line in cap19:
        if not (line["rel_err"] <= BWD_RTOL_OF_MAX
                and line["fwd_err"] <= FWD_ATOL
                and all(positive(v) for k, v in line.items()
                        if k.endswith("_ms"))):
            raise SystemExit(f"probe_cap19 at {line['geom']}@{line['cap']}: "
                             f"kernel B off the exact adjoint by more than "
                             f"{BWD_RTOL_OF_MAX:g} of its largest entry, or "
                             f"kernel F by more than {FWD_ATOL:g}: {line}")
    out["probe_cap19"] = cap19
    secs, peak = phase_end(torch, "measuring tools", t_phase)
    out.update(phase_s=secs, peak_mib=peak)
    return out

# Phase 20: the archived TPU envelope probes through their mains, at their
# defaults but probe_final's sections 1-2 (1-2 GiB) and probe_round2's
# card-shape sweep, which the chip runs of PERF.md make; then each envelope
# kernel held to its twin once at an archived probe's shape.  The kernels
# each probe must launch:
ENVELOPE_PROBES = {
    "probe_rmw": ([], ("K3",)), "probe_scatter": ([], ("K3",)),
    "probe_scatter2": ([], ("K3",)), "probe_loop": ([], ("K1", "K3")),
    "probe_final": (["3", "4", "5"], ("K3",)),
    "probe_round2": ([], ("K1", "K2", "K3")), "probe_tpu": ([], ("K1", "K2")),
    "probe_tpu2": ([], ("K1", "K2")), "probe_bwd_var": ([], ("K4",)),
}
ENVELOPE_SITES = {
    "K1": ["tools/archive/probe_loop.py:52", "tools/archive/probe_round2.py:138",
           "tools/archive/probe_round2.py:177",
           "tools/archive/probe_tpu.py:72 (k_rows, k_onehot)",
           "tools/archive/probe_tpu2.py:93 (k_rowtake)"],
    "K2": ["tools/archive/probe_tpu.py:72 (k_flat, k_lane)",
           "tools/archive/probe_tpu2.py:93 (k_tala0, k_tala1)",
           "tools/archive/probe_round2.py:240"],
    "K3": ["tools/archive/probe_rmw.py:74", "tools/archive/probe_scatter.py:72",
           "tools/archive/probe_scatter2.py:55",
           "tools/archive/probe_loop.py:100", "tools/archive/probe_final.py:77",
           "tools/archive/probe_round2.py:212"],
    "K4": ["tools/archive/probe_bwd_var.py:101"],
}


def check_envelope(torch, envelope, common):
    """Each envelope kernel against its twin at an archived probe's shape:
    K1 and K2 bit for bit, K3 and K4 within BWD_RTOL_OF_MAX of the largest
    entry of the f64 sum of the same f32 contributions, and K3 and K4's
    v2d, alt2 and novals bit for bit (to a second launch and to the twin on
    CPU copies: they sum in index and sample order); kernel, twin and
    library call timed plain / kernel / kernel / plain.  Returns the
    kernels' stats."""
    import numpy as np

    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)
    out = {}

    def tensor(a):
        return torch.from_numpy(np.array(a)).to(dev)

    def stats(key, name, fn, plain, lib, nbytes, err):
        from jnerf_tpu_torch.tools.tool_util import host_us, kernel_time

        ms, plain_ms, four = time_pair(fn, plain)
        lib_ms = (cuda_ms(lib) + cuda_ms(lib)) / 2
        # The kernels' own time (the profiler's sum; noscat includes the
        # zeroing of its output), apart from the wrapper's host time.
        dev_ms, _ = kernel_time(fn, 20, dev)
        out[key] = dict(work(nbytes, 0, F32_FLOP_PER_S), ms=ms,
                        plain_ms=plain_ms, library_ms=lib_ms, err=err,
                        shape=name, device_ms=dev_ms)
        host = ""
        if key == "K2":  # host-bound at this shape: the wrapper's host time
            out[key]["host_us"] = host_us(fn, 10000)
            out[key]["library_host_us"] = host_us(lib, 10000)
            host = (f"; host {out[key]['host_us']:.3f} us a call, library "
                    f"{out[key]['library_host_us']:.3f}")
        print(f"time {key} [{name}]: kernel {ms:.4f} ms ({four[0]:.4f}, "
              f"{four[1]:.4f}; device {dev_ms:.4f}{host}), plain "
              f"{plain_ms:.4f}, library {lib_ms:.4f}, bound "
              f"{out[key]['bound_ms']:.4f} ms ({nbytes} B)", flush=True)

    def equal(name, got, want):
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise SystemExit(f"{name}: the kernel differs from its twin")
        print(f"{name}: equal to its twin", flush=True)

    # K1: probe_loop's gather, N = 2^20 of a [65536, 128] f32 table; with w
    # and with lane sums at probe_round2's / probe_tpu's [4096, 128].
    tbl = torch.randn((65536, 128), generator=gen, device=dev)
    idx = tensor(common.uniform_idx(1 << 20, 65536))
    equal("K1 [65536 x 512 B, N=2^20]", envelope.row_gather(tbl, idx),
          envelope.row_gather_plain(tbl, idx))
    small = tbl[:4096].contiguous()
    i2 = tensor(common.uniform_idx(1 << 20, 4096, seed=1))
    w = torch.randn((1 << 20, 128), generator=gen, device=dev)
    equal("K1 gather*w [4096 x 512 B]", envelope.row_gather(small, i2, w),
          envelope.row_gather_plain(small, i2, w))
    i3 = i2[:32768].contiguous()
    equal("K1 lane sums [4096 x 512 B, B=32768]",
          envelope.row_gather(small, i3, lane_sum=True),
          envelope.row_gather_plain(small, i3, lane_sum=True))
    del w, i2, i3, small
    stats("K1", "probe_loop: N=2^20 rows of a [65536, 128] f32 table",
          lambda: envelope.row_gather(tbl, idx),
          lambda: envelope.row_gather_plain(tbl, idx),
          lambda: tbl.index_select(0, idx),
          common.gather_bytes(1 << 20, 512, common.distinct(idx)), 0.0)
    del tbl, idx

    # K2: probe_round2's lane gather [8192, 128] (timed); flat and axis 0
    # at probe_tpu's and probe_tpu2's shapes.
    t4 = torch.randn((8192, 128), generator=gen, device=dev)
    i4 = tensor(common.uniform_idx(1 << 20, 128).reshape(8192, 128))
    equal("K2 axis1 [8192, 128]", envelope.elem_gather(t4, i4, "axis1"),
          envelope.elem_gather_plain(t4, i4, "axis1"))
    tp = t4[:4096].contiguous()
    fi = tensor(common.uniform_idx(8 * 32768, 1 << 19, seed=2)
                .reshape(8, 32768))
    equal("K2 flat [8, 32768] of 512K", envelope.elem_gather(tp, fi, "flat"),
          envelope.elem_gather_plain(tp, fi, "flat"))
    ai = tensor(common.uniform_idx(8192 * 128, 4096, seed=3).reshape(8192, 128))
    equal("K2 axis0 [8192, 128] from [4096, 128]",
          envelope.elem_gather(tp, ai, "axis0"),
          envelope.elem_gather_plain(tp, ai, "axis0"))
    del tp, fi, ai
    i64 = i4.long()
    stats("K2", "probe_round2 k_lane: take_along_axis on axis 1, [8192, 128]",
          lambda: envelope.elem_gather(t4, i4, "axis1"),
          lambda: envelope.elem_gather_plain(t4, i4, "axis1"),
          lambda: torch.gather(t4, 1, i64),
          common.elem_bytes(i4, common.distinct_along(i4, 1)), 0.0)
    del t4, i4, i64

    def held(key, name, got, exact):
        torch.cuda.synchronize()
        err = float((got.double() - exact).abs().max())
        top = float(exact.abs().max())
        print(f"{key} [{name}]: max abs err {err:.3e} from the f64 sum, "
              f"{err / top:.3e} of its largest entry (tolerance "
              f"{BWD_RTOL_OF_MAX:g})", flush=True)
        if not err <= BWD_RTOL_OF_MAX * top:
            raise SystemExit(f"{key} disagrees with the sum at {name}")
        return err

    # K3: probe_rmw's ray-coherent 2^21 rows into [32768, 128] f32.
    rows = tensor(common.clustered_rows(1 << 21, 32768))
    vals = torch.randn((1 << 21, 128), generator=gen, device=dev)
    name = "probe_rmw: 2^21 clustered rows into [32768, 128] f32"
    first = envelope.row_scatter_add(rows, vals, 32768)
    if not torch.equal(first, envelope.row_scatter_add(rows, vals, 32768)):
        raise SystemExit("K3: two launches differ")
    equal("K3 [probe_rmw; two launches equal] against its twin on CPU "
          "copies", first.cpu(),
          envelope.row_scatter_add_plain(rows.cpu(), vals.cpu(), 32768))
    err = held("K3", name, first,
               envelope.row_scatter_add_plain(rows, vals, 32768,
                                              torch.float64))
    del first
    stats("K3", name, lambda: envelope.row_scatter_add(rows, vals, 32768),
          lambda: envelope.row_scatter_add_plain(rows, vals, 32768),
          lambda: torch.zeros((32768, 128), device=dev)
          .index_add_(0, rows, vals),
          common.scatter_bytes(1 << 21, 512, 32768), err)
    del rows, vals

    # K4: probe_bwd_var's v2d, alt2 and novals at f2l16, N = 2^18, each
    # equal to its twin on CPU copies of the inputs and to a second launch;
    # v2d also held to the f64 sum and timed.
    from jnerf_tpu_torch.ops.hash_grid import HashGridSpec
    from jnerf_tpu_torch.tools.archive import probe_bwd_var

    spec = HashGridSpec(**probe_bwd_var.SPEC)
    n_rows = max(spec.level_sizes) // 8
    scales = np.asarray(spec.scales, np.float32)
    p = common.Probe(dev)
    pos, g, rows, slots = probe_bwd_var.inputs(p, spec)
    name = (f"probe_bwd_var v2d: f2l16, N={pos.shape[0]}, {n_rows} rows a "
            "level")
    args = (pos, g, rows, slots, scales, n_rows)
    cpu_args = tuple(a.cpu() for a in args[:4]) + args[4:]
    for variant, n_acc, mode in (("v2d", 1, "v2d"), ("alt2", 2, "v2d"),
                                 ("novals", 1, "novals")):
        first = envelope.packed_hash_scatter(*args, n_acc, mode)
        again = envelope.packed_hash_scatter(*args, n_acc, mode)
        torch.cuda.synchronize()
        if not torch.equal(first, again):
            raise SystemExit(f"K4 {variant}: two launches differ")
        equal(f"K4 {variant} [f2l16, N={pos.shape[0]}; two launches equal] "
              "against its twin on CPU copies", first.cpu(),
              envelope.packed_hash_scatter_plain(*cpu_args, n_acc, mode))
        del first, again
    err = held("K4", name, envelope.packed_hash_scatter(*args),
               envelope.packed_hash_scatter_plain(*args, dtype=torch.float64))
    L = spec.n_levels
    seg = torch.cat([(lvl * n_rows + rows[lvl].long()) * 8 + slots[lvl].long()
                     for lvl in range(L)])
    contrib = torch.cat([envelope.packed_contributions(
        pos, g, float(scales[lvl]), lvl, L) for lvl in range(L)])
    stats("K4", name, lambda: envelope.packed_hash_scatter(*args),
          lambda: envelope.packed_hash_scatter_plain(*args),
          lambda: torch.zeros((L * n_rows * 8, 16), device=dev)
          .index_add_(0, seg, contrib),
          probe_bwd_var.k4_bytes(L, pos.shape[0], n_rows, 1, "v2d"), err)
    return out


# The CUDA kernels behind each wrapper whose work takes several launches.
RADIX_KERNELS = ["bin_count_kernel<RadixBins>", "scan_reduce_kernel",
                 "scan_top_kernel", "scan_down_kernel",
                 "bin_scatter_kernel<RadixBins>", "key_runs_kernel"]
CUDA_KERNELS = {
    "B": ["hash_prep_kernel<F, MODE>", *RADIX_KERNELS,
          "hash_piece_kernel<F, MODE, LANES>",
          "hash_sum_kernel<F, MODE, LANES>"],
    "K3": [*RADIX_KERNELS, "row_sum_kernel"],
    "K4": ["bin_count_kernel<K4Bins>", "scan_reduce_kernel", "scan_top_kernel",
           "scan_down_kernel", "bin_scatter_kernel<K4Bins>",
           "packed_accumulate_kernel<64/128>", "packed_noscat_kernel"],
}


def envelope_rows(env):
    """The kernels line's rows of K1-K4 from run_envelope's result."""
    rows = []
    for key, label, lib in (
            ("K1", "env_row_gather (K1)", "index_select"),
            ("K2", "env_elem_gather (K2)", "torch.gather"),
            ("K3", "env_row_scatter_add (K3)", "index_add_"),
            ("K4", "env_packed_hash_scatter (K4)",
             "index_add_ of the precomputed contributions: the scatter "
             "alone")):
        st = env["checks"][key]
        rows.append(kernel_row(
            label, "jnerf_tpu_torch/csrc/envelope.cu",
            ", ".join(ENVELOPE_SITES[key]), env["totals"][key], st,
            st["shape"], max_abs_err=st["err"], library=lib,
            device_ms=st["device_ms"],
            on_path="the ported archive probes (phase 20)",
            probe_launches={name: c[key] for name, c in
                            env["launches"].items() if c[key]},
            **({"cuda_kernels": CUDA_KERNELS[key]} if key in CUDA_KERNELS
               else {})))
    return rows


def run_envelope(torch):
    """Phase 20: each archived envelope probe's port through its main in
    this process, the envelope counters set to 0 just before it and read
    just after; raises if a probe failed, printed a false correctness line
    or a non-positive time, or ran without its kernels.  Then
    check_envelope.  Returns the launches, seconds and checks."""
    import importlib

    from jnerf_tpu_torch.ops import envelope
    from jnerf_tpu_torch.tools.archive import common

    t_phase = phase_start(torch)
    counters = dict(envelope.KERNELS)
    out = {"launches": {}, "seconds": {}}
    for name, (argv, needs) in ENVELOPE_PROBES.items():
        mod = importlib.import_module(f"jnerf_tpu_torch.tools.archive.{name}")
        reset_counts(counters)
        t0 = time.perf_counter()
        lines = mod.main(argv)
        torch.cuda.synchronize()
        out["seconds"][name] = time.perf_counter() - t0
        counts = out["launches"][name] = read_counts(counters)
        if any(counts[k] == 0 for k in needs):
            raise SystemExit(f"{name}: {needs} did not all run: {counts}")
        for ln in lines:
            if ln.get("ok") is False or ("ms" in ln and not positive(ln["ms"])):
                raise SystemExit(f"{name}: {ln}")
        print(f"{name}: {out['seconds'][name]:.3f} s, launches {counts}",
              flush=True)
    out["totals"] = {k: sum(c[k] for c in out["launches"].values())
                     for k in counters}
    out["checks"] = check_envelope(torch, envelope, common)
    secs, peak = phase_end(torch, "envelope probes", t_phase)
    out.update(phase_s=secs, peak_mib=peak)
    return out


# Phase 21: the JAX package's training is bitwise reproducible from a seed
# (docs/DESIGN.md:104-108); since kernel B sums in a fixed order (PR 16),
# so is the port's.  Two runs from one seed in one process must end in the
# same bits.  The xor run covers kernel B's other mode.
REPEAT_XOR_STEPS = 32


def training_state(torch, runner):
    """Every tensor a training run carries forward, on the host: the
    parameters, Adam's count and moments, the EMA's shadow and steps, the
    occupancy grid's state, the batch shape and the generator's state."""
    st = {f"param {i}": p.detach().cpu() for i, p in enumerate(runner.params)}
    opt = runner.optimizer
    for i, p in enumerate(runner.params):
        for k, v in opt.state.get(p, {}).items():
            st[f"adam {k} {i}"] = v.cpu()
    st["adam count"] = torch.tensor(opt.count)
    if runner.ema_state is not None:
        for i, v in enumerate(runner.ema_state["shadow"]):
            st[f"ema {i}"] = v.cpu()
        st["ema steps"] = torch.tensor(runner.ema_state["steps"])
    for k, v in runner.sampler.state.items():
        st[f"grid {k}"] = v.cpu() if torch.is_tensor(v) else torch.tensor(v)
    st["batch shape"] = torch.tensor([runner.sampler.n_rays_per_batch,
                                      runner.sampler.n_samples_per_ray])
    st["generator"] = runner.generator.get_state()
    return st


def same_bits(torch, a, b) -> bool:
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype.is_floating_point:  # -0.0 against 0.0 and NaNs count too
        return torch.equal(a.reshape(-1).view(torch.uint8),
                           b.reshape(-1).view(torch.uint8))
    return torch.equal(a, b)


def xor_cfg(ngp_synthetic_cfg):
    cfg = ngp_synthetic_cfg(hash_levels=16, hash_features=2)
    cfg.hash_indexing = "xor"
    return cfg


def train_logged(torch, runner, steps, graph=True):
    """Train steps [0, steps) through graph windows (``train_range``) or
    eager ones (``train_range_eager``); returns every step's main loss,
    read from each window's loss buffer, on the host."""
    losses = []
    train = runner.train_range if graph else runner.train_range_eager
    train(0, steps, tick=lambda *a: losses.append(
        runner.window_losses.clone()))
    torch.cuda.synchronize()
    return torch.cat(losses).cpu()


def run_repeat(torch, Runner, ngp_synthetic_cfg, hash_nbr, hash_xor):
    """Phase 21: the headline for HEADLINE_STEPS steps and the xor hash
    (f2l16) for REPEAT_XOR_STEPS, each twice from one seed through graph
    windows; raises unless both runs of each end in equal bits
    (training_state and every step's loss) with kernel B launched once a
    step.  Returns the launches."""
    t_phase = phase_start(torch)
    out = {}
    for name, make_cfg, steps, kernel in (
            ("headline f8l4+m17f2k19", lambda: headline_cfg(
                ngp_synthetic_cfg, False), HEADLINE_STEPS, hash_nbr.grad_table),
            ("xor f2l16", lambda: xor_cfg(ngp_synthetic_cfg), REPEAT_XOR_STEPS,
             hash_xor.grad_table_xor)):
        runs = []
        for _ in range(2):
            make_cfg()
            runner = Runner(device="cuda")
            kernel.launches = 0
            losses = train_logged(torch, runner, steps)
            if not runner.windows.cache:
                raise SystemExit(f"repeat [{name}]: no window ran as a graph")
            runs.append((losses, training_state(torch, runner),
                         kernel.launches))
            del runner
        (l1, s1, n1), (l2, s2, n2) = runs
        differ = [k for k in s1 if not same_bits(torch, s1[k], s2[k])]
        if not same_bits(torch, l1, l2):
            differ.append("losses")
        print(f"repeat [{name}]: {steps} steps twice from seed 42; "
              f"{len(s1)} state tensors and {l1.numel()} losses compared, "
              f"{len(differ)} differ {differ[:8]}; final loss "
              f"{float(l1[-1]):.8f} / {float(l2[-1]):.8f}; kernel B launches "
              f"{n1} / {n2}", flush=True)
        if differ or n1 != steps or n2 != steps or len(s1) != len(s2):
            raise SystemExit(f"repeat [{name}]: the two runs differ "
                             f"({differ}) or kernel B ran {n1} / {n2} times")
        out[name] = n1 + n2
    secs, peak = phase_end(torch, "repeat", t_phase)
    return dict(launches=out, phase_s=secs, peak_mib=peak)


# Phase 22: graph windows against eager ones from one seed (the headline
# for 4 windows, the xor hash and the fused-MLP headline for 2: a shape's
# first window is its warm-up, the second its capture and first replay),
# then tools/window_time.py on the headline, cut from its defaults (768
# steps, then 8 windows timed and 8 profiled) to fit the phase's minute:
# with 512 and 8 the phase took 79.7 s on an H100.
WINDOW_RUNS = (("headline f8l4+m17f2k19", 4), ("xor f2l16", 2),
               ("fused headline", 2))
WINDOW_TIME_ARGS = ["--steps", "256", "--windows", "4"]
# The CUDA kernel (a substring of the profiler's name) that each counted
# wrapper launches once a call.
PROFILED_KERNELS = {"F": "hash_fwd_kernel", "F xor": "hash_fwd_kernel",
                    "B": "hash_prep_kernel", "B xor": "hash_prep_kernel",
                    "F-MLP": "mlp_fwd_kernel", "B-MLP": "mlp_bwd_kernel"}


def profiled_kernels(torch, fn):
    """{kernel name: launches} of the CUDA kernels that ``fn`` runs, from
    torch.profiler (kernels inside a graph replay included)."""
    from collections import Counter

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    return Counter(e.name for e in prof.events()
                   if e.device_type == cuda and not e.is_user_annotation)


def run_window_graphs(torch, Runner, ngp_synthetic_cfg, counters):
    """Phase 22: each of WINDOW_RUNS trained from one seed through graph
    windows and through eager ones; raises unless both end in equal bits
    (training_state, every step's loss) with equal launch counts, and one
    more graph window's launches, counted by the wrappers, equal the
    profiler's kernel list.  Then window_time's eager-against-graph
    reading.  Returns the launches and the reading."""
    from jnerf_tpu_torch.tools import window_time

    t_phase = phase_start(torch)
    makes = {"headline f8l4+m17f2k19": lambda: headline_cfg(
                 ngp_synthetic_cfg, False),
             "xor f2l16": lambda: xor_cfg(ngp_synthetic_cfg),
             "fused headline": lambda: headline_cfg(ngp_synthetic_cfg, True)}
    launches = {}
    for name, windows in WINDOW_RUNS:
        steps = 16 * windows
        runs = []
        for graph in (True, False):
            makes[name]()
            runner = Runner(device="cuda")
            reset_counts(counters)
            losses = train_logged(torch, runner, steps, graph)
            runs.append((runner, losses, training_state(torch, runner),
                         read_counts(counters)))
        (g_runner, g_loss, g_state, g_counts), (_, e_loss, e_state,
                                                e_counts) = runs
        differ = [k for k in e_state
                  if not same_bits(torch, g_state[k], e_state[k])]
        if not same_bits(torch, g_loss, e_loss):
            differ.append("losses")
        # One more window on the graph runner (its refresh, then a replay).
        reset_counts(counters)
        names = profiled_kernels(
            torch, lambda: g_runner.train_range(steps, steps + 16))
        window = read_counts(counters)
        want, prof = {}, {}
        for k, pat in PROFILED_KERNELS.items():
            want[pat] = want.get(pat, 0) + window[k]
            prof[pat] = sum(n for kn, n in names.items() if pat in kn)
        graphs = len(g_runner.windows.cache)
        b = "B xor" if name.startswith("xor") else "B"
        print(f"graph windows [{name}]: {steps} steps each way from seed 42; "
              f"{len(e_state)} state tensors and {e_loss.numel()} losses "
              f"compared, {len(differ)} differ {differ[:8]}; final loss "
              f"{float(g_loss[-1]):.8f} / {float(e_loss[-1]):.8f}; launches "
              f"graph {g_counts}, eager {e_counts}; {graphs} graphs; one "
              f"more window: counters {want}, profiler {prof}", flush=True)
        if differ or g_counts != e_counts or graphs < 1 or want != prof \
                or g_counts[b] != steps or window[b] != 16 \
                or (name.startswith("fused") and window["B-MLP"] != 16):
            raise SystemExit(f"graph windows [{name}]: the paths differ "
                             f"({differ}), launches {g_counts} / {e_counts}, "
                             f"{graphs} graphs, or the counters {want} miss "
                             f"the profiler's {prof}")
        launches[name] = g_counts
        del runs, g_runner
    timing = window_time.main(WINDOW_TIME_ARGS)
    for path in ("eager", "graph"):
        line = timing[path]
        if not all(positive(line[k]) for k in ("host_ms", "kernel_ms",
                                                "busy", "launches",
                                                "peak_mib")):
            raise SystemExit(f"window_time [{path}]: {line}")
    if timing["graph"]["graphs"] < 1 \
            or timing["graph"]["loss"] != timing["eager"]["loss"]:
        raise SystemExit(f"window_time: no graph, or the paths' losses "
                         f"differ: {timing}")
    secs, peak = phase_end(torch, "graph windows", t_phase)
    return dict(launches=launches, timing=timing, phase_s=secs,
                peak_mib=peak)


# Phase 23: the families' windows.  NeuS (neus_womask.py), Mip-NeRF
# (mip_base.py) and Plenoxels (svox2_base.py, dense at 256^3, then sparse
# at 512^3 after the upsample) at full width on the scenes of phases 12-14,
# each trained for FAMILY_WINDOWS windows a grid (the first a key's
# warm-up, the second its capture and replay) through graphs twice and
# through the eager loop once, from one seed: the three runs must end in
# the same bits (every parameter, optimizer state and count, the grid's
# buffers, the generator and every step's loss) with the same launch
# counts.  Then one more window of the graph run and of the eager run
# each on the host clock (sync to sync) and one under torch.profiler:
# host and kernel ms a step, the busy share and peak memory of each path.
# pixelNeRF at the script's widths runs PIX_REPEAT_VIEWS training views
# (a few steps) twice with equal bits.  torch.use_deterministic_algorithms
# (warn_only) is switched on for one more eager window of each family and
# one pixelNeRF step and off again: the ops it names are printed.  Kernel V
# is held to its plain version on CPU copies bit for bit (and to a second
# launch, and inside guard zones) on one step's inputs of phase 14's dense
# and sparse grids, and timed beside it and index_add_.
FAMILY_WINDOWS = 2
PIX_REPEAT_VIEWS = 2  # 2 x 100^2 rays: 9 steps of 2048 rays
VOXEL_GUARD = 4096
# Kernel V's stages, each opened by the first CUDA kernel (a substring of
# the profiler's name) of its own; the scans and the memset that follow a
# stage's kernel count to it.
VOXEL_STAGES = (("compaction", ("voxel_live_kernel", "voxel_compact_kernel")),
                ("sort", ("bin_count_live_kernel", "bin_scatter_live_kernel")),
                ("row starts", ("key_runs_kernel", "emset")),
                ("sum", ("voxel_weights_kernel", "voxel_tile_kernel")))
VOXEL_SPLIT_REPS = 3


def voxel_work(n, corners, n_rows, channels, kept, live, read,
               samples) -> dict:
    """Kernel V: the g's [n, channels] f32 read for every sample (they
    decide which samples are ``live``), idx and w for the live samples
    alone, the whole gradients [n_rows, channels] f32 written; a multiply
    and an add a kept item and channel.  Item path: a live sample's
    ``corners`` f32 weights, and the int64 rows of the ``read`` items of
    live samples whose weight is not 0.  Sample path: a live sample's
    int64 base row, and the weights of the ``read`` live samples whose
    base row is on the grid."""
    idx_w = (8 * live + 4 * corners * read if samples
             else 4 * corners * live + 8 * read)
    nbytes = 4 * n * channels + 4 * n_rows * channels + idx_w
    return work(nbytes, 2 * kept * channels, F32_FLOP_PER_S)


def capture_voxel_inputs(torch, runner, n_rays):
    """One MSE backward of ``runner``'s grid on ``n_rays`` rays of its
    training pool in its current order (no update, the batch cursor
    untouched), with kernel V's inputs recorded: (idx, w, g's, n_rows,
    offsets), the tensors on the CPU."""
    from jnerf_tpu_torch.ops import voxel_grid

    ds = runner.dataset["train"]
    sel = ds._perm[:n_rays]  # rays from every image, as a batch draws them
    ro, rd, rgb = (torch.from_numpy(a[sel]).cuda()
                   for a in (ds._origins, ds._dirs, ds._rgbs))
    seen = []
    orig = voxel_grid.corner_grad

    def corner_grad(idx, w, grads, n_rows, offsets=None):
        seen.append((idx.cpu(), w.cpu(), [g.cpu() for g in grads], n_rows,
                     offsets))
        return orig(idx, w, grads, n_rows, offsets)

    # The launch bumps this wrapper's count, not the path's.
    corner_grad.launches = 0
    voxel_grid.corner_grad = corner_grad
    try:
        rgb_out = runner.grid.volume_render(ro, rd, **runner.render_kwargs())
        torch.mean((rgb_out - rgb) ** 2).backward()
    finally:
        voxel_grid.corner_grad = orig
    for p in runner.grid.tables().values():
        p.grad = None
    (got,) = seen
    return got


def voxel_split(torch, fn, reps=VOXEL_SPLIT_REPS):
    """Kernel V's device ms a launch by stage (VOXEL_STAGES), from
    voxel_time.kernel_times over ``reps`` launches of ``fn``: the CUDA
    kernels in the order they ran, each counted to the stage last opened.
    The profiler's times are approximate: they need not add up to the
    CUDA events' time of a launch."""
    from jnerf_tpu_torch.tools.voxel_time import kernel_times

    split, stage = {name: 0.0 for name, _ in VOXEL_STAGES}, None
    for kernel, ms in kernel_times(torch, fn, reps):
        for name, marks in VOXEL_STAGES:
            if any(m in kernel for m in marks):
                stage = name
        if stage is not None:
            split[stage] += ms
    return split


def voxel_tiles_over(torch, start, offsets, n_rows, tile, room):
    """(tiles, tiles whose entries pass a window's ``room``) of kernel V's
    sum, from its key starts: a warp's tile of rows [r0, r1) holds the
    entries of keys [r0 - off, r1 - off) for each offset; one over its
    room takes more than one window."""
    p = start.long()
    r0 = torch.arange(0, n_rows, tile)
    r1 = torch.clamp(r0 + tile, max=n_rows)
    entries = sum(p[torch.clamp(r1 - o, 0, n_rows)]
                  - p[torch.clamp(r0 - o, 0, n_rows)]
                  for o in (offsets or (0,)))
    return r0.numel(), int((entries > room).sum())


def check_voxel_kernel(torch, name, inputs):
    """Kernel V on one step's inputs: bit for bit its plain version on CPU
    copies and a second launch, its plan the plain plan, a launch inside
    guard zones writing nothing outside them; timed beside the plain
    version on the card, index_add_ of the materialized products (the
    scatter alone) and the whole index_add_ path (the keep mask, the
    compaction, the products and index_add_), with its bound, its
    compaction, sort and row starts alone (CUDA events) and its device
    time split by stage (the profiler's, approximate)."""
    from jnerf_tpu_torch.ops import voxel_grid

    idx_c, w_c, g_c, n_rows, offs = inputs
    idx, w = idx_c.cuda(), w_c.cuda()
    grads = [g.cuda() for g in g_c]
    n, K = w.shape
    C = sum(g.shape[1] for g in grads)
    rows_c = voxel_grid.corner_rows(idx_c, n_rows, offs)
    want = voxel_grid.corner_grad_plain(rows_c, w_c, g_c, n_rows)
    got = voxel_grid.corner_grad(idx, w, grads, n_rows, offs)
    again = voxel_grid.corner_grad(idx, w, grads, n_rows, offs)
    voxel_grid.corner_grad.launches -= 2  # checks, not the path
    torch.cuda.synchronize()
    same = all(same_bits(torch, a.cpu(), b) for a, b in zip(got, want))
    repeat = all(same_bits(torch, a, b) for a, b in zip(got, again))
    err = max(float((a.cpu() - b).abs().max()) for a, b in zip(got, want))
    start, order = voxel_grid.corner_grad_plan(idx, w, grads, n_rows, offs)
    p_start, p_order = voxel_grid.corner_grad_plan_plain(idx_c, w_c, g_c,
                                                         n_rows, offs)
    plan_ok = torch.equal(start.cpu(), p_start) and torch.equal(order.cpu(),
                                                               p_order)
    kept = int(voxel_grid._live_items(rows_c, w_c, g_c, n_rows).sum())
    entries = int(p_start[-1])
    live_c = voxel_grid._live_samples(g_c, n, "cpu")
    live = int(live_c.sum())
    # The idx and w that the function must read (voxel_work).
    read = entries if offs is not None else int(
        ((w_c != 0) & live_c[:, None]).sum())
    layout = voxel_grid.grad_layout(n, K, n_rows, offs is not None)
    tiles, over = voxel_tiles_over(torch, p_start, offs, n_rows,
                                   *layout[3:5])
    del want, again, start, order, p_start, p_order, rows_c, live_c
    bufs = []

    def guarded(size, dtype):
        buf = torch.full((size + 2 * VOXEL_GUARD,), -7, dtype=dtype,
                         device="cuda")
        bufs.append(buf)
        return buf[VOXEL_GUARD:VOXEL_GUARD + size]

    work_g = guarded(layout[0], torch.int32)
    outs_g = [guarded(n_rows * g.shape[1], torch.float32) for g in grads]
    voxel_grid._launch_grad(idx, w, grads, n_rows, outs_g, work_g, False,
                            offs)
    torch.cuda.synchronize()
    guards_ok = all(bool((b[:VOXEL_GUARD] == -7).all()
                         and (b[-VOXEL_GUARD:] == -7).all()) for b in bufs)
    guarded_same = all(same_bits(torch, o.view(a.shape), a)
                       for o, a in zip(outs_g, got))
    del bufs, work_g, outs_g, got
    # index_add_ of the products, materialized once outside the timing
    # (from the corner rows, on the sample path too).
    rows_d = voxel_grid.corner_rows(idx, n_rows, offs)
    keep = voxel_grid._live_items(rows_d, w, grads, n_rows)
    items = torch.nonzero(keep).squeeze(1)
    rows = rows_d.reshape(-1)[items]
    vals = w.reshape(-1)[items, None] * torch.cat(grads, 1)[items // K]
    del keep, items

    def library():
        torch.zeros((n_rows, C), device="cuda").index_add_(0, rows, vals)

    def library_path():
        keep = voxel_grid._live_items(rows_d, w, grads, n_rows)
        items = torch.nonzero(keep).squeeze(1)
        vals = w.reshape(-1)[items, None] * torch.cat(grads, 1)[items // K]
        torch.zeros((n_rows, C), device="cuda").index_add_(
            0, rows_d.reshape(-1)[items], vals)

    def kernel():
        voxel_grid.corner_grad(idx, w, grads, n_rows, offs)

    work_p = torch.empty(layout[0], dtype=torch.int32, device="cuda")
    no_outs = [torch.empty(0, device="cuda") for _ in grads]

    def plan():  # the compaction, the sort and the row starts
        voxel_grid._launch_grad(idx, w, grads, n_rows, no_outs, work_p,
                                True, offs)

    ms, plain_ms, four = time_pair(
        kernel, lambda: voxel_grid.corner_grad_plain(rows_d, w, grads,
                                                     n_rows))
    library_ms = cuda_ms(library, iters=10)
    del rows, vals
    library_path_ms = cuda_ms(library_path, iters=10)
    plan_ms = cuda_ms(plan, iters=10)
    del work_p, rows_d
    split = voxel_split(torch, kernel)
    voxel_grid.corner_grad.launches = 0  # timing, not the path
    stats = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                 library_path_ms=library_path_ms, plan_ms=plan_ms,
                 split_ms_profiler=split, err=err, n=n, n_rows=n_rows,
                 kept=kept, live=live, entries=entries,
                 path="item" if offs is None else "sample", tiles=tiles,
                 tiles_over_window=over,
                 **voxel_work(n, K, n_rows, C, kept, live, read,
                              offs is not None))
    print(f"kernel V [{name}]: {n} samples x {K} corners into {n_rows} rows "
          f"x {C} channels, {live} samples live, {kept} items kept, the "
          f"{stats['path']} path sorting {entries} entries; {over} of "
          f"{tiles} warp tiles over a window; bit for bit the plain version "
          f"on CPU copies {same} (max |diff| {err:.3e}), a second launch "
          f"{repeat}, the plan {plan_ok}, inside guard zones "
          f"{guards_ok and guarded_same}; {ms:.4f} ms (plain "
          f"{plain_ms:.4f}, index_add_ of the materialized products alone "
          f"{library_ms:.4f}, the index_add_ path with the keep mask, "
          f"compaction and products {library_path_ms:.4f}, bound "
          f"{stats['bound_ms']:.4f} by {stats['bound_by']} "
          f"({stats['bytes']} bytes); runs {[round(x, 4) for x in four]}); "
          f"the compaction, sort and row starts alone {plan_ms:.4f} ms (CUDA "
          f"events); device ms a launch by stage (profiler, approximate, "
          f"{VOXEL_SPLIT_REPS} launches): "
          + ", ".join(f"{k} {v:.4f}" for k, v in split.items())
          + f", total {sum(split.values()):.4f} against {ms:.4f} by CUDA "
          f"events; on {card_line()}", flush=True)
    if not (same and repeat and plan_ok and guards_ok and guarded_same):
        raise SystemExit(f"kernel V [{name}] disagrees with its plain "
                         f"version, a second launch, its plan or its "
                         f"buffers")
    return stats


def family_state(torch, runner):
    """Every tensor a family's run carries forward, on the host: the
    parameters (the grid's tables and buffers), the optimizer's state and
    counts, the step and the generator's state."""
    if hasattr(runner, "grid"):
        named = dict(runner.grid.tables())
        named.update({f"buffer {k}": v for k, v in runner.grid.named_buffers()})
        named.update({f"opt {k}": v for k, v in runner.opt_state.items()})
        counts = [runner.gstep]
    else:
        named = {f"param {i}": p for i, p in enumerate(runner.params)}
        for i, p in enumerate(runner.params):
            for k, v in runner.optimizer.state.get(p, {}).items():
                named[f"adam {k} {i}"] = v
        counts = [runner.optimizer.count,
                  getattr(runner, "iter_step", getattr(runner, "start", 0))]
    st = {k: v.detach().cpu() for k, v in named.items()}
    st["counts"] = torch.tensor(counts)
    st["generator"] = runner.generator.get_state()
    return st


def log_windows(runner, losses):
    """Record each window's losses (``train_window``'s output) in
    ``losses``."""
    orig = runner.train_window

    def train_window(n, graph=None):
        out = orig(n, graph)
        losses.append(out.clone())
        return out

    runner.train_window = train_window


def lower_density_thresh(torch, runner):
    """density_thresh as phase 14 sets it: the config's unless no cell of
    the dense grid reaches it, else the grid's 99th-percentile density;
    returns the value."""
    dens = runner.grid.density.detach().reshape(-1)
    if float(dens.max()) <= runner.grid.density_thresh:
        runner.grid.density_thresh = float(
            torch.topk(dens, dens.numel() // 100).values[-1])
    return runner.grid.density_thresh


def family_specs(torch, tmp, neus_scene, scene):
    """{name: (make() -> runner, train(runner, graph), more(runner, graph),
    steps a run)} of phase 23's three families at full width."""
    from jnerf_tpu_torch.runner import MipRunner, NeuSRunner, Svox2Runner
    from jnerf_tpu_torch.utils.config import init_cfg

    steps = 16 * FAMILY_WINDOWS
    neus_cfg = write_cfg(os.path.join(tmp, "cfg_neus_w.py"),
                         "neus/configs/neus_womask.py", f"""\
        dataset = dict(dataset_dir={neus_scene!r})
        base_exp_dir = {os.path.join(tmp, "neus_w")!r}
        end_iter = {steps}
        report_freq = 16
        save_freq = 1000000
        val_freq = 1000000
        val_mesh_freq = 1000000
    """)
    mip_cfg = write_cfg(os.path.join(tmp, "cfg_mip_w.py"),
                        "mipnerf/configs/mip_base.py", f"""\
        dataset_dir = {scene!r}
        dataset = dict(train=dict(root_dir=dataset_dir),
                       val=dict(root_dir=dataset_dir),
                       test=dict(root_dir=dataset_dir))
        log_dir = {os.path.join(tmp, "logs_mip_w")!r}
        tot_train_steps = {steps}
    """)
    svox_cfg = write_cfg(os.path.join(tmp, "cfg_svox2_w.py"),
                         "svox2/configs/svox2_base.py", f"""\
        dataset_dir = {scene!r}
        dataset = dict(train=dict(root=dataset_dir, split='train'),
                       test=dict(root=dataset_dir, split='test'))
        log_dir = {os.path.join(tmp, "logs_svox2_w")!r}
        upsamp_every = {steps}
        lr_sigma_delay_steps = 0
        lr_sigma_delay_mult = 1.0
    """)

    def make(cls, cfg):
        def build():
            init_cfg(cfg)
            return cls(device="cuda")
        return build

    def neus_more(r, graph):
        r.train_window(16, graph)
        r.iter_step += 16

    def mip_more(r, graph):
        n = 16
        r.train_window(n, graph)
        r.start += n

    def svox_train(r, graph):
        r.train(steps, graph=graph)
        lower_density_thresh(torch, r)
        r.train(steps, graph=graph)  # the upsample, then sparse windows

    def svox_more(r, graph):
        r.train_window(16, graph)
        r.gstep += 16

    return {
        "NeuS": (make(NeuSRunner, neus_cfg),
                 lambda r, graph: r.train(graph=graph), neus_more, steps),
        "Mip-NeRF": (make(MipRunner, mip_cfg),
                     lambda r, graph: r.train(graph=graph), mip_more, steps),
        "Plenoxels": (make(Svox2Runner, svox_cfg), svox_train, svox_more,
                      2 * steps),
    }


def deterministic_probe(torch, fn):
    """The warnings of torch.use_deterministic_algorithms(True,
    warn_only=True) while ``fn`` runs (switched off after)."""
    import warnings

    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            fn()
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
    return sorted({str(w.message).split("\n")[0][:160] for w in seen})


def check_probe(torch):
    """The deterministic-mode probe must name a known nondeterministic op
    (``put_`` without accumulate on the card, which has no deterministic
    variant), or its silence on the families says nothing.  Ops that have
    one (index_add_, index_put_ with accumulate, scatter_add_) switch to it
    under the mode without a word: the repeats are the check for those."""
    t = torch.zeros(8, device="cuda")
    idx = torch.zeros(4, dtype=torch.int64, device="cuda")
    vals = torch.arange(4, dtype=torch.float32, device="cuda")
    named = deterministic_probe(torch, lambda: t.put_(idx, vals))
    if not named:
        raise SystemExit("the deterministic-mode probe names nothing for "
                         "put_ on the card")
    return named


def time_window(torch, fn):
    """(host ms, kernel ms, kernel launches) of one window ``fn``: the
    host clock from a synchronize to a synchronize, then the same window
    again under the profiler for the kernels."""
    from jnerf_tpu_torch.tools.tool_util import kernel_time

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host = (time.perf_counter() - t0) * 1e3
    kms, nk = kernel_time(fn, 1, torch.device("cuda"))
    return host, kms, nk


def run_family_windows(torch, counters, tmp, neus_scene, scene, voxel_inputs):
    """Phase 23 (see above).  Returns each family's launches and timing,
    the pixelNeRF repeat, the probe's findings and kernel V's stats."""
    import gc

    t_phase = phase_start(torch)
    out = {"families": {}, "probe": {}}
    print(f"deterministic-mode probe on put_: {check_probe(torch)}",
          flush=True)
    for name, (make, train, more, steps) in family_specs(
            torch, tmp, neus_scene, scene).items():
        runs = []
        for path in ("graph", "graph again", "eager"):
            graph = path != "eager"
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            runner = make()
            losses = []
            log_windows(runner, losses)
            reset_counts(counters)
            train(runner, graph)
            torch.cuda.synchronize()
            trained = torch.cat(losses).cpu()
            state = family_state(torch, runner)
            counts = read_counts(counters)
            timing = None
            if path != "graph again":
                n_ms = 16
                host, kms, nk = time_window(torch, lambda: more(runner, graph))
                timing = dict(host_ms=host / n_ms, kernel_ms=kms / n_ms,
                              busy=kms / host, launches=nk / n_ms)
                if not graph:
                    out["probe"][name] = deterministic_probe(
                        torch, lambda: more(runner, False))
            peak = torch.cuda.max_memory_allocated() / 2**20
            graphs = len(runner.windows.cache)
            runs.append(dict(losses=trained, state=state,
                             counts=counts, timing=timing, peak_mib=peak,
                             graphs=graphs))
            del runner, losses
        g, g2, e = runs
        differ = {}
        for label, other in (("graph again", g2), ("eager", e)):
            d = [k for k in g["state"]
                 if k not in other["state"]
                 or not same_bits(torch, g["state"][k], other["state"][k])]
            if not same_bits(torch, g["losses"], other["losses"]):
                d.append("losses")
            if g["counts"] != other["counts"]:
                d.append("launches")
            differ[label] = d
        line = {p: dict(r["timing"], peak_mib=r["peak_mib"])
                for p, r in (("graph", g), ("eager", e))}
        print(f"family windows [{name}]: {g['losses'].shape[0]} steps a run "
              f"from one seed, {len(g['state'])} state tensors and the "
              f"losses compared; graph vs graph differ "
              f"{differ['graph again'][:8]}, graph vs eager differ "
              f"{differ['eager'][:8]}; {g['graphs']} graphs; launches "
              f"{g['counts']}; final loss "
              f"{g['losses'].reshape(steps, -1)[-1, 0]:.8f}; "
              + "; ".join(
                  f"{p}: {t['host_ms']:.4f} ms host a step "
                  f"({1e3 / t['host_ms']:.3f} steps/s), kernels "
                  f"{t['kernel_ms']:.4f} ms ({t['launches']:.1f} launches), "
                  f"busy {t['busy']:.4f}, peak {t['peak_mib']:.1f} MiB"
                  for p, t in line.items())
              + f"; deterministic-mode probe: {out['probe'][name]}; on "
              f"{card_line()}", flush=True)
        if differ["graph again"] or differ["eager"] or g["graphs"] < 1 \
                or g["losses"].shape[0] != steps \
                or (name == "Plenoxels" and g["counts"]["V"] != steps):
            raise SystemExit(f"family windows [{name}]: the runs differ "
                             f"({differ}), {g['graphs']} graphs, "
                             f"{g['losses'].shape[0]} steps, launches "
                             f"{g['counts']}")
        out["families"][name] = dict(launches=g["counts"], **line)
        del runs, g, g2, e
    out["pixelnerf"] = pixelnerf_repeat(torch)
    out["voxel"] = {k: check_voxel_kernel(torch, k, v)
                    for k, v in voxel_inputs.items()}
    secs, peak = phase_end(torch, "family windows", t_phase)
    out.update(phase_s=secs, peak_mib=peak)
    return out


def pixelnerf_repeat(torch):
    """pixelNeRF at the script's widths on its analytic scene's first
    3 + PIX_REPEAT_VIEWS views, trained twice from one seed: every step's
    loss and every parameter must be equal bit for bit."""
    from jnerf_tpu_torch.projects.pixelnerf import main as pix

    images, poses, focal = pix.make_synthetic()
    keep = 3 + PIX_REPEAT_VIEWS
    runs = []
    for _ in range(2):
        model = pix.build_model("cuda")
        hist = pix.train(model, images[:keep], poses[:keep], focal, epochs=1)
        runs.append((torch.tensor(hist["step_loss"]),
                     {k: v.detach().cpu() for k, v in
                      model.state_dict().items()}))
        del model
    (l1, s1), (l2, s2) = runs
    differ = [k for k in s1 if not same_bits(torch, s1[k], s2[k])]
    if not same_bits(torch, l1, l2):
        differ.append("losses")
    probe = deterministic_probe(torch, lambda: pix.train(
        pix.build_model("cuda"), images[:keep], poses[:keep], focal,
        epochs=1))
    print(f"pixelNeRF repeat: {l1.numel()} steps twice from one seed, "
          f"{len(s1)} tensors and the losses compared, {len(differ)} differ "
          f"{differ[:8]}; deterministic-mode probe: {probe}", flush=True)
    if differ or l1.numel() < 2:
        raise SystemExit(f"pixelNeRF repeat: the runs differ ({differ})")
    return dict(steps=l1.numel(), probe=probe)


def build_kernels(torch, cuda_lib):
    """Phase 2: one nvcc per source and the g++ builds of the host-side
    cores (marching tetrahedra, the JPEG codec, the MPEG-4 encoder),
    started together."""
    from concurrent.futures import ThreadPoolExecutor

    from jnerf_tpu_torch import native

    t0 = time.perf_counter()
    names = ("hash_encode", "fused_mlp", "envelope", "voxel_grid")
    preludes = (cuda_lib.hash_prelude(), "", "", "")
    hosts = ("marching_tets", "jpeg", "mpeg4")
    with ThreadPoolExecutor(len(names) + len(hosts)) as pool:
        host = [pool.submit(native.build, h) for h in hosts]
        libs = list(pool.map(cuda_lib.build, names, preludes))
        host_libs = [h.result() for h in host]
    cuda_lib.hash_encode_lib()
    cuda_lib.fused_mlp_lib()
    cuda_lib.envelope_lib()
    cuda_lib.voxel_grid_lib()
    native.marching_lib()
    print(f"built {', '.join(lib.name for lib in libs)} and "
          f"{', '.join(os.path.basename(h) for h in host_libs)} in "
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
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        kernels = later_phases(torch, Runner, ngp_synthetic_cfg, run_net,
                               hash_nbr, hash_xor, hash_grid, fused_mlp,
                               mse2psnr, tmp, hs, mlp, launches,
                               fused_launches, mlp_chunk, n_chunk,
                               quality_launches)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"chip_smoke.py: all phases passed in "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def later_phases(torch, Runner, ngp_synthetic_cfg, run_net, hash_nbr,
                 hash_xor, hash_grid, fused_mlp, mse2psnr, tmp, hs, mlp,
                 launches, fused_launches, mlp_chunk, n_chunk,
                 quality_launches):
    """Phases 8-22 (the CLI, the xor kernels, the probe refresh, the mesh
    tool, vanilla NeRF, NeuS, Mip-NeRF, Plenoxels, pixelNeRF,
    Recursive-NeRF, data parallelism, the real-capture configs, the
    measuring tools, the envelope probes, the repeats and the graph
    windows) in ``tmp``; returns the kernels line."""
    from jnerf_tpu_torch.tools import extract_mesh

    cli, xor_runner, scene = run_cli(torch, run_net, hash_nbr, hash_xor,
                                     fused_mlp, tmp)
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
    counters = launch_counters(hash_nbr, hash_xor, fused_mlp)
    probe = run_probe(torch, Runner, ngp_synthetic_cfg, counters, mse2psnr)
    mesh = run_mesh_tool(torch, extract_mesh, counters,
                         cli["linear_rows"]["cfg"])
    run_vanilla_nerf(torch, run_net, counters, mse2psnr, scene,
                     cli["linear_rows"]["bg_psnr"], tmp)
    neus = run_neus(torch, run_net, counters, tmp)
    run_mip(torch, run_net, counters, scene, tmp)
    svox = run_svox2(torch, run_net, counters, scene, tmp)
    run_pixelnerf(torch, counters, tmp)
    run_recursive_nerf(torch, counters, tmp)
    par = run_parallel(torch)
    rank_launches = {k: [{"refresh": r["refresh"][k], "step": r["step"][k]}
                         for r in par["launches"]] for k in ("F", "B")}
    fwd_keys = ("ms", "plain_ms", "bound_ms", "f32_ms")
    cap, cap_hs = run_captures(torch, run_net, hash_nbr, counters, tmp)
    tools = run_tools(torch, counters)
    env = run_envelope(torch)
    repeat = run_repeat(torch, Runner, ngp_synthetic_cfg, hash_nbr, hash_xor)
    windows = run_window_graphs(torch, Runner, ngp_synthetic_cfg, counters)
    families = run_family_windows(torch, counters, tmp, neus["scene"], scene,
                                  svox.pop("voxel"))
    window_launches = {k: {name: c[k] for name, c in
                           windows["launches"].items()}
                       for k in ("F", "B", "F xor", "B xor", "F-MLP",
                                 "B-MLP")}
    tool_launches = {k: {name: c[k] for name, c in tools["launches"].items()}
                     for k in ("F", "B")}
    capture_launches = {k: {f"{name} {task}": cap[name][task]["launches"][k]
                            for name, tasks in (("fox", ("train", "test")),
                                                ("llff", ("train", "test",
                                                          "render")))
                            for task in tasks} for k in ("F", "B")}
    cap_rows = {k: {f"{name} field: two steps' {cap_hs[name]['n']} kept "
                    f"samples, f2l16 aabb {aabb} "
                    f"({n_ent} entries)": {m: cap_hs[name][k][m]
                                           for m in keys}
                    for name, aabb, n_ent in (("fox", 4, FOX_N_ENTRIES),
                                              ("llff", 64, LLFF_N_ENTRIES))}
                for k, keys in (("fwd", fwd_keys),
                                ("bwd", ("ms", "plain_ms", "bound_ms",
                                         "library_ms")))}

    head = "step f8l4@2^19"
    others = ("uniform f8l4@2^19", "uniform f2l16@2^18", "step f2l16@2^18")
    fwd_others = others + ("render chunk f8l4@2^19", "render chunk f2l16@2^18")
    src = "jnerf_tpu_torch/csrc/fused_mlp.cu"
    no_lib = "no single PyTorch call computes it"
    kernels = [
        kernel_row(
            "hash_encode_fwd (kernel F)", "jnerf_tpu_torch/csrc/hash_encode.cu",
            "jnerf_tpu/ops/hash_nbr.py:261", launches["fwd"],
            hs[head]["fwd"],
            f"one headline step's {N_SAMPLES} kept samples, f8l4@2^19, bf16 "
            "output (the path's dtype; f32_ms: the f32 output)",
            max_abs_err=max(h["fwd"]["err"] for h in (*hs.values(),
                                                       *cap_hs.values())),
            library=no_lib + " (a gather of bf16-rounded rows, each "
            "product rounded to bf16, summed in f32)",
            capture_path_launches=capture_launches["F"],
            tools_path_launches=tool_launches["F"],
            window_path_launches=window_launches["F"],
            **cap_rows["fwd"],
            fused_path_launches=fused_launches["hash_fwd"],
            quality_path_launches=quality_launches["fwd"],
            cli_path_launches=cli["linear_rows"]["train_launches"]["F"],
            probe_path_launches=probe["launches"]["F"],
            probe_refresh_launches=probe["refresh_launches"],
            mesh_tool_launches=mesh["launches"],
            parallel_rank_launches=rank_launches["F"],
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
            max_abs_err=max([hs[k]["bwd"]["err"] for k in (head,) + others]
                            + [h["bwd"]["err"] for h in cap_hs.values()]),
            library="index_put_(accumulate=True) of the precomputed weighted "
            "contributions: the scatter alone",
            cuda_kernels=CUDA_KERNELS["B"],
            repeat_path_launches=repeat["launches"],
            window_path_launches=window_launches["B"],
            capture_path_launches=capture_launches["B"],
            tools_path_launches=tool_launches["B"],
            **cap_rows["bwd"],
            fused_path_launches=fused_launches["hash_bwd"],
            quality_path_launches=quality_launches["bwd"],
            cli_path_launches=cli["linear_rows"]["train_launches"]["B"],
            probe_path_launches=probe["launches"]["B"],
            parallel_rank_launches=rank_launches["B"],
            **{k: {m: hs[k]["bwd"][m] for m in ("ms", "plain_ms", "bound_ms",
                                                "library_ms")}
               for k in others}),
        kernel_row(
            "fused_mlp_fwd (F-MLP)", src, "jnerf_tpu/ops/fused_mlp.py:113",
            fused_launches["fwd"], dict(mlp["fwd"][N_SAMPLES], library_ms=None),
            f"N={N_SAMPLES} random rows",
            max_abs_err=max(mlp["fwd"]["err"], mlp_chunk["err"]),
            library=no_lib, window_path_launches=window_launches["F-MLP"],
            **{f"N={N_RENDER} random rows": {
                m: mlp["fwd"][N_RENDER][m]
                for m in ("ms", "plain_ms", "bound_ms")},
               f"render chunk N={n_chunk}": dict(
                   {m: mlp_chunk[m] for m in ("ms", "plain_ms", "bound_ms")},
                   launches=fused_launches["render_fwd"])}),
        kernel_row(
            "fused_mlp_bwd (B-MLP)", src, "jnerf_tpu/ops/fused_mlp.py:123",
            fused_launches["bwd"], dict(mlp["bwd"][N_SAMPLES], library_ms=None),
            f"N={N_SAMPLES}", max_abs_err=mlp["bwd"]["err"], library=no_lib,
            window_path_launches=window_launches["B-MLP"]),
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
            window_path_launches=window_launches["F xor"],
            uniform={m: xs["uniform"]["fwd"][m]
                     for m in ("ms", "plain_ms", "bound_ms")}),
        kernel_row(
            "hash_encode_xor_bwd (kernel B, xor mode)",
            "jnerf_tpu_torch/csrc/hash_encode.cu",
            "jnerf_tpu/ops/hash_grid.py:206",
            cli["xor"]["train_launches"]["B xor"], xs["trained field"]["bwd"],
            "the same samples and table, bf16 products summed in f32",
            max_abs_err=max(x["bwd"]["err"] for x in xs.values()),
            cuda_kernels=CUDA_KERNELS["B"],
            window_path_launches=window_launches["B xor"],
            library="index_put_(accumulate=True) of the precomputed "
            "contributions: the scatter alone",
            uniform={m: xs["uniform"]["bwd"][m]
                     for m in ("ms", "plain_ms", "bound_ms", "library_ms")}),
    ]
    vox = families["voxel"]
    kernels.append(kernel_row(
        "voxel_grad (kernel V)", "jnerf_tpu_torch/csrc/voxel_grid.cu",
        "jnerf_tpu/ops/voxel_grid.py:100", svox["launches"],
        vox["dense 256^3"],
        f"one phase-14 step's inputs on the trained 256^3 dense grid: "
        f"{vox['dense 256^3']['n']} samples x 8 corners into "
        f"{vox['dense 256^3']['n_rows']} rows x 28 channels, "
        f"{vox['dense 256^3']['kept']} items kept",
        also_replaces=["jnerf_tpu/ops/voxel_grid.py:255"],
        max_abs_err=max(v["err"] for v in vox.values()),
        library="index_add_ of the materialized [kept, 28] products: the "
        "scatter alone (library_path_ms: with the keep mask, the compaction "
        "and the products timed too); plan_ms: the compaction, the sort "
        "and the row starts alone (CUDA events); split_ms_profiler: the "
        "device ms by stage from torch.profiler, approximate (it need not "
        "add up to ms)",
        library_path_ms=vox["dense 256^3"]["library_path_ms"],
        plan_ms=vox["dense 256^3"]["plan_ms"],
        split_ms_profiler=vox["dense 256^3"]["split_ms_profiler"],
        path=vox["dense 256^3"]["path"],
        cuda_kernels=["voxel_live_kernel", "scan_reduce_kernel",
                      "scan_top_kernel", "scan_down_kernel",
                      "voxel_compact_kernel",
                      "bin_count_live_kernel<RadixBins>",
                      "bin_scatter_live_kernel<RadixBins>", "key_runs_kernel",
                      "voxel_weights_kernel", "voxel_tile_kernel"],
        window_path_launches=families["families"]["Plenoxels"]["launches"][
            "V"],
        **{"sparse 512^3": {m: vox["sparse 512^3"][m] for m in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "library_path_ms", "plan_ms", "split_ms_profiler", "path", "n",
            "n_rows", "live", "kept")}}))
    kernels += envelope_rows(env)
    for k in kernels:
        k["max_abs_err"] = float(k["max_abs_err"])
    return kernels


if __name__ == "__main__":
    sys.exit(main())

"""One run of one benchmark cell of the PyTorch + CUDA port.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the cards the cell asks
for.  The run loads the program, makes the weights from the seed on the
card (a render cell also the occupancy of the scene's solids), hands them
to the program, trains or renders through its entry points (set-up), then
measures for ``--seconds`` (``--trace 0``: the cell's end-to-end metrics)
or traces a stretch of the same work under the profiler (``--trace 1``:
its per-layer metrics).  After the window it frees the program, runs the
plain reference (`reference.py`) over what the timed path produced and
prints each number compared beside its limit, on standard error and as
the last key of the result.  The last line of standard output is the
result, one JSON object.  A run without the cards, or whose process holds
JAX or the JAX package after the window, exits with 2 and prints no
result; a training run whose window did not run the batch shape that the
check compared exits with 3.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
CACHE = REPO / "build" / "benchmark"
# Every cache of a run stays at a fixed path inside the checkout (the
# program's nvcc builds go to its own build/jnerf_tpu_torch).
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(CACHE / "inductor")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import cells, check, reference, scene, trace, work  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "jnerf_tpu")


def derived_seeds(seed: int) -> dict:
    """Independent seeds for the weights, the program's draws, the render
    jitter and the check's sample, all from ``--seed``."""
    s = np.random.SeedSequence(int(seed)).generate_state(4, dtype=np.uint64)
    return dict(zip(("weights", "draws", "jitter", "sample"),
                    (int(x) >> 1 for x in s)))


def make_params(leaves, seed: int, device) -> dict:
    """Weights ``leaves`` [(name, shape, bound)] from ``seed``: one uniform
    draw on the device for all leaves, each leaf scaled to U(-bound,
    bound)."""
    gen = torch.Generator(device).manual_seed(seed)
    sizes = [math.prod(shape) for _, shape, _ in leaves]
    flat = torch.rand(sum(sizes), generator=gen, device=device)
    out, at = {}, 0
    for (name, shape, bound), n in zip(leaves, sizes):
        out[name] = (flat[at:at + n] * (2 * bound) - bound).reshape(shape)
        at += n
    return out


class ShapeMoved(RuntimeError):
    """The training batch's shape in the window is not the checked one."""


def p95(values) -> float:
    """The 95th percentile of all values (exclusive method)."""
    return statistics.quantiles(values, n=20)[18]


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


# ------------------------------------------------------------------ kinds
def run_train(cell, seed, seconds, traced, device, ctx, plant=None,
              control=False):
    """Set-up (the checked first steps, the warm-up), the window, then the
    check.  ``plant(runner)`` breaks the program before its first step;
    ``control`` judges the reference at the precision below the
    configuration's in the program's place."""
    from benchmark import program

    cfg, traffic = cell.config["cfg"], cell.traffic
    field = cell.reference.build(cfg, 1.0)
    sd = derived_seeds(seed)
    scene_dir = scene.ensure_scene(str(CACHE), cell.config["scene"], device)
    n_check, warmup = int(traffic["check_steps"]), int(traffic["warmup_steps"])

    def setup_and_window():
        runner = program.build_runner(cfg, scene_dir, sd["draws"], device)
        if plant is not None:
            plant(runner)
        params0 = make_params(field.leaves, sd["weights"], device)
        program.set_weights(runner, params0)
        runner.generator.manual_seed(sd["draws"])
        checked = program.batch_shape(runner)
        judged = program.first_steps(runner, params0, n_check,
                                     cfg["optim"]["betas"][0])
        del params0
        runner.train_range(n_check, warmup)
        program.sync(device)
        ctx["setup_s"] = time.perf_counter() - T_START
        ctx["peak_setup"] = _peak(device)
        if traced:
            win, tr = trace.traced(lambda: program.train_window(
                runner, warmup, seconds, int(traffic["trace_windows"])),
                device)
            ctx.update(trace=tr, bits=runner.sampler.state["bitfield"].clone(),
                       demand=[int(d) for d in win[3]])
        else:
            win = program.train_window(runner, warmup, seconds)
        steps, win_s, losses, _, freq, shapes = win
        if shapes != {checked}:
            raise ShapeMoved(f"batch shape (rays, samples a ray) checked "
                             f"{checked}, in the window {sorted(shapes)}")
        ctx.update(steps=steps, window_s=win_s, steps_per_window=freq,
                   shape=checked, peak=_peak(device))
        bad = int((~torch.isfinite(losses)).sum())
        return judged, checked[0], bad

    judged, n_rays, bad = setup_and_window()
    program.release()
    ctx.update(kind="train", cfg=cfg, field=field, scene_dir=scene_dir,
               seeds=sd, attempted=ctx["steps"], failed=bad)
    ctx["metrics"] = {
        "train_steps_per_s": ctx["steps"] / ctx["window_s"],
        "peak_mem_gib": ctx["peak"] / 2 ** 30,
        "setup_s": ctx["setup_s"]}

    reference.no_tf32()
    params0 = make_params(field.leaves, sd["weights"], device)
    ref_scene = reference.Scene(scene_dir, device)
    ctx["ref_scene"] = ref_scene

    def ref_steps(lower):
        return reference.train_steps(cfg, field, params0, ref_scene,
                                     sd["draws"], n_check,
                                     reference.quant_for(cfg, lower), n_rays)

    losses, grads, params = ref_steps(False)
    if control:
        judged = check.judged_of(*ref_steps(True), params0)
    print(f"note: main loss a step, judged {judged['losses']}, reference "
          f"{losses}; peak after set-up {ctx['peak_setup']} B, after the "
          f"window {ctx['peak']} B", file=sys.stderr)
    return check.train_numbers(judged, losses, grads, params, params0)


def run_render(cell, seed, seconds, traced, device, ctx, plant=None,
               control=False):
    """Set-up (the drawn field, the scene's occupancy, one warm-up view),
    the window, then the check of a sample of its views.  ``plant`` and
    ``control`` as in `run_train`."""
    from benchmark import program

    cfg, traffic = cell.config["cfg"], cell.traffic
    field = cell.reference.build(cfg, 1.0)
    sd = derived_seeds(seed)
    scene_dir = scene.ensure_scene(str(CACHE), cell.config["scene"], device)
    angle, poses, _ = scene.load_split(scene_dir, "test")
    geom = reference.geom_of(cfg)
    bits = reference.solid_bitfield(geom, *scene.solids(cell.config["scene"]),
                                    device)
    gen = torch.Generator(device).manual_seed(sd["jitter"])
    u_table = torch.rand((len(poses), reference.RENDER_CHUNK), generator=gen,
                         device=device)

    def setup_and_window():
        runner = program.build_runner(cfg, scene_dir, sd["draws"], device)
        if plant is not None:
            plant(runner)
        program.set_weights(runner, make_params(field.render_leaves,
                                                sd["weights"], device))
        program.set_occupancy(runner, bits)
        runner.render_img_with_pose(poses[0], u=u_table[0])
        program.sync(device)
        ctx["setup_s"] = time.perf_counter() - T_START
        ctx["hw"] = (runner.H, runner.W)
        if traced:
            (lat, imgs, win_s), tr = trace.traced(lambda: program.render_window(
                runner, poses, u_table, seconds, int(traffic["trace_views"])),
                device)
            ctx["trace"] = tr
        else:
            lat, imgs, win_s = program.render_window(runner, poses, u_table,
                                                     seconds)
        ctx.update(views=len(lat), window_s=win_s, latencies=lat,
                   peak=_peak(device))
        rng = np.random.default_rng(sd["sample"])
        pick = sorted(rng.choice(len(imgs), min(int(traffic["check_views"]),
                                                len(imgs)), replace=False))
        bad = sum(not np.isfinite(im).all() for im in imgs)
        return [(int(k), imgs[int(k)]) for k in pick], bad

    judged, bad = setup_and_window()
    program.release()
    H, W = ctx["hw"]
    ctx.update(kind="render", cfg=cfg, field=field, attempted=ctx["views"],
               failed=bad, rays_per_view=H * W)
    ctx["metrics"] = {
        "render_rays_per_s": ctx["views"] * H * W / ctx["window_s"],
        "render_image_ms_p95": p95(ctx["latencies"]) * 1e3
        if len(ctx["latencies"]) > 1 else float("nan"),
        "peak_mem_gib": ctx["peak"] / 2 ** 30,
        "setup_s": ctx["setup_s"]}

    reference.no_tf32()
    params = make_params(field.render_leaves, sd["weights"], device)
    focal = reference.focal_of(W, angle)

    def views(lower):
        q = reference.quant_for(cfg, lower)
        return [reference.render_view(cfg, field, params, bits,
                                      poses[k % len(poses)], H, W, focal,
                                      u_table[k % len(poses)], q)
                for k, _ in judged]

    ref_imgs = views(False)
    judged_imgs = views(True) if control else [img for _, img in judged]
    return check.render_numbers(judged_imgs, ref_imgs)


KINDS = {"train": run_train, "render": run_render}


def _peak(device) -> int:
    if torch.device(device).type != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated(device))


# ------------------------------------------------------------------- a run
def run_cell(cell, seed: int, seconds: float, traced: bool, device,
             plant=None, control=False) -> dict:
    """One run of ``cell``; returns the result object (without printing).
    ``plant`` and ``control`` serve the check's readings (`readings.py`)."""
    ctx = {"device": device}
    numbers = KINDS[cell.traffic["kind"]](cell, seed, seconds, traced,
                                          device, ctx, plant, control)
    correct, shown = check.verdict(numbers, cell.limits)
    others = {k: v for k, v in numbers.items() if k not in cell.limits}
    if others:
        print(f"note: not compared {others}", file=sys.stderr)
    if traced:
        metrics = {}
        for entry, reader in cell.per_layer:
            value = reader.read(ctx)
            if value is not None:
                metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    else:
        metrics = {m["name"]: {"value": ctx["metrics"][m["name"]],
                               "unit": m["unit"]} for m in cell.end_to_end}
    dev = torch.device(device)
    result = {
        "correct": bool(correct and ctx["failed"] == 0),
        "attempted": int(ctx["attempted"]),
        "failed": int(ctx["failed"]),
        "metrics": metrics,
        "device": {
            "platform": "gpu" if dev.type == "cuda" else "cpu",
            "kind": torch.cuda.get_device_name(0) if dev.type == "cuda"
            else "cpu",
            "count": cell.chips,
            "memory_peak_bytes": ctx["peak"]},
    }
    if traced:
        tr = ctx["trace"]
        result["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = tr.breakdown()
    result["check"] = shown
    return result


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    cell = cells.load(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {args.workload} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " available", file=sys.stderr)
        return 2
    try:
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                          "cuda")
    except ShapeMoved as e:
        print(f"benchmark: {e}; the window did not run the checked shape",
              file=sys.stderr)
        return 3
    found = forbidden_modules()
    if found:
        print(f"benchmark: the process holds {found} after the window",
              file=sys.stderr)
        return 2
    print(f"card: {work.card('cuda')}", file=sys.stderr)
    for k, v in result["check"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The upper readings of the check's limits, at a cell's own size.

    python3 -m benchmark.readings --workload <cell> --seeds 1,2,3 --mode control|half_batch [--seconds 2]

Each seed is one run of the cell (`run.run_cell`, a short window), with
one change:

- ``control``: the plain reference put in the program's place, computed
  in the precision below the configuration's (float8 e4m3 where the
  configuration states bfloat16), is what the check judges;
- ``half_batch`` (training): the program with a planted fault, its loss
  the mean over the first half of the batch's rays, the rest left out.

One line a seed: each number compared beside the cell's limit.  The lower
readings are the ``check`` of the benchmark's own runs.  The benchmark's
runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from benchmark import cells, run


def plant_half_batch(runner):
    """The loss over the first half of the rays, the rest left out."""
    loss = runner.loss_func

    def half(x, target):
        k = x.shape[0] // 2
        return loss(x[:k], target[:k])

    runner.loss_func = half


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--mode", choices=("control", "half_batch"), required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("readings: needs a CUDA device", file=sys.stderr)
        return 2
    cell = cells.load(args.workload)
    if args.mode == "half_batch" and cell.traffic["kind"] != "train":
        print("readings: half_batch plants a training fault", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        res = run.run_cell(cell, seed, args.seconds, False, "cuda",
                           plant=plant_half_batch
                           if args.mode == "half_batch" else None,
                           control=args.mode == "control")
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "mode": args.mode, "correct": res["correct"],
                          "check": res["check"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

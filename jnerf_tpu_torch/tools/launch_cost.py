"""Host cost of an envelope kernel's launch at probe_round2's lane gather
(K2, ``take_along_axis`` on axis 1 of an [8192, 128] f32 array, int32
indices in [0, 128)), beside ``torch.gather`` on the same inputs.

    python3 -m jnerf_tpu_torch.tools.launch_cost [--calls 10000] [--out PATH]

It times ``elem_gather`` and ``torch.gather`` whole: host µs a call over
``--calls`` calls (no synchronize inside the loop), wall ms a call between
CUDA events over back-to-back calls (gather, K2, K2, gather) and device ms
a call (the profiler's sum of kernel times); and, each alone, the steps
of the launch path (``cuda_lib.Launch``) that it cannot drop: the ctypes
call with its launch, ``torch.empty_like``, the ``Launch`` call and
``elem_gather`` with no launch (N = 0).  Runs on the card only.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

SHAPE = (8192, 128)


def floor_steps(src, idx, calls):
    """{step: host µs a call} of each step of the lean launch path alone."""
    from jnerf_tpu_torch.ops import cuda_lib
    from jnerf_tpu_torch.ops.envelope import elem_gather
    from jnerf_tpu_torch.tools.tool_util import host_us

    out = torch.empty(SHAPE, dtype=torch.float32, device=src.device)
    args = (src.data_ptr(), idx.data_ptr(), out.data_ptr())
    fn = cuda_lib.envelope_lib().env_elem_gather
    stream = torch.cuda.current_stream(src.device).cuda_stream
    launch = cuda_lib.Launch(cuda_lib.envelope_lib, "env_elem_gather")
    table = {
        "ctypes call with its launch":
            lambda: fn(*args, idx.numel(), 2, 128, *SHAPE, stream),
        "torch.empty_like(idx, dtype)":
            lambda: torch.empty_like(idx, dtype=torch.float32),
        "cuda_lib.Launch call, N = 0 (no launch)":
            lambda: launch(src.get_device(), *args, 0, 2, 128, *SHAPE),
        "elem_gather whole, N = 0 (no launch)":
            lambda: elem_gather(src, idx[:, :0], "axis1"),
    }
    return {name: host_us(f, calls) for name, f in table.items()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--calls", type=int, default=10000)
    ap.add_argument("--out", help="write the JSON result here too")
    args = ap.parse_args(argv)
    from jnerf_tpu_torch.ops.envelope import elem_gather
    from jnerf_tpu_torch.tools.tool_util import (card, device_for, host_us,
                                                 kernel_time, timed,
                                                 write_atomic)

    dev = device_for(False, "launch_cost")
    print(f"card: {card(dev)}", flush=True)
    rng = np.random.default_rng(0)
    src = torch.from_numpy(rng.normal(size=SHAPE).astype(np.float32)).to(dev)
    idx = torch.from_numpy(rng.integers(0, SHAPE[1], SHAPE).astype(np.int32)
                           ).to(dev)
    idx64 = idx.long()
    if not torch.equal(elem_gather(src, idx, "axis1"),
                       torch.gather(src, 1, idx64)):
        raise SystemExit("elem_gather differs from torch.gather")
    res = {"card": card(dev), "shape": list(SHAPE), "calls": args.calls,
           "steps_us": floor_steps(src, idx, args.calls)}
    for name, us in res["steps_us"].items():
        print(f"  {name}: {us:.3f} us a call", flush=True)

    def k2():
        return elem_gather(src, idx, "axis1")

    def lib():
        return torch.gather(src, 1, idx64)

    res["host_us"] = {"elem_gather": host_us(k2, args.calls),
                      "torch.gather": host_us(lib, args.calls)}
    four = [timed(f, 200, dev)[1] for f in (lib, k2, k2, lib)]
    res["wall_ms"] = {"elem_gather": (four[1] + four[2]) / 2,
                      "torch.gather": (four[0] + four[3]) / 2, "four": four}
    res["device_ms"] = {"elem_gather": kernel_time(k2, 50, dev)[0],
                        "torch.gather": kernel_time(lib, 50, dev)[0]}
    for key in ("host_us", "wall_ms", "device_ms"):
        print(f"{key}: " + ", ".join(f"{k} {v:.4f}" for k, v in
                                     res[key].items() if k != "four"),
              flush=True)
    if args.out:
        write_atomic(args.out, json.dumps(res, indent=1) + "\n")
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()

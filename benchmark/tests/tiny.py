"""A tiny copy of the benchmark's cells for CPU tests: the same readers,
reference fields, limits and BENCHMARK.json, with the configurations'
scenes, batches, grids and hash tables shrunk and the traffic shortened."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from benchmark import cells

SRC = cells.HERE
SHORT = {"warmup_steps": 32, "trace_windows": 2, "check_views": 2,
         "trace_views": 2}


def layout(dst: Path) -> Path:
    for d in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(SRC / d, dst / d)
    path = dst / "configs" / "ngp_base.json"
    c = json.loads(path.read_text())
    c["scene"].update(n_train=4, n_test=3, H=24, W=24)
    c["cfg"].update(target_batch_size=4096, grid_size=32, n_rays_per_batch=128,
                    compacted_batch=4096)
    c["cfg"]["encoder"]["pos_encoder"]["log2_hashmap_size"] = 14
    path.write_text(json.dumps(c))
    for path in (dst / "traffic").glob("*.json"):
        t = json.loads(path.read_text())
        t.update({k: v for k, v in SHORT.items() if k in t})
        path.write_text(json.dumps(t))
    return dst

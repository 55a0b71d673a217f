"""How the two mesh tools' vertex colours part when their marching paths
list the triangles in different orders, on the CPU.

    JAX_PLATFORMS=cpu python tests/torch_mesh_order_probe.py [--seeds 1,2,3]

For each training seed, the tiny NGP field of
`tests/test_torch_marching.py::test_ngp_mesh_tool_matches_jax` is trained
64 steps by the port and saved; both mesh tools then run on it at 48^3,
the port's with the JAX tool's colour jitter, twice: (a) the JAX tool
on its numpy marching path, as when its in-place g++ build is missing or
unreadable, against the port's g++ core; (b) both tools on their numpy
paths, as the test runs them.  Prints, per seed and case, the largest
8-bit colour difference and how many vertices differ by more than one
level.  The numbers that `ROADMAP.md` §3 cites for the test's repair come
from this script.
"""

import argparse
import functools
import importlib.util
import os
import sys
import tempfile
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

import jnerf_tpu.native as jax_native  # noqa: E402
import jnerf_tpu.utils.config as jax_config  # noqa: E402
from jnerf_tpu.utils.bench_cfg import ngp_synthetic_cfg as jax_cfg  # noqa: E402
from jnerf_tpu_torch.ops import marching as tmarch  # noqa: E402
from jnerf_tpu_torch.runner import Runner  # noqa: E402
from jnerf_tpu_torch.tools import extract_mesh  # noqa: E402
from jnerf_tpu_torch.utils.bench_cfg import ngp_synthetic_cfg as port_cfg  # noqa: E402
from torch_parity import TINY_EXTRA, TINY_NGP, read_ply, t  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


def colours(seed: int, tmp: Path, jax_numpy: bool, port_numpy: bool):
    """(port, JAX) vertex colours [V, 3] of one seed's field."""
    cfgs = []
    for make in (jax_cfg, port_cfg):
        cfg = make(**TINY_NGP)
        cfg.update(TINY_EXTRA, seed=seed, log_dir=str(tmp / "logs"))
        cfgs.append(cfg)
    jcfg, tcfg = cfgs
    ckpt = tmp / "params.pkl"
    if not ckpt.exists():
        runner = Runner(device="cpu")
        runner.train_range(0, 64)
        runner.save_ckpt(str(ckpt))
    tag = f"{int(jax_numpy)}{int(port_numpy)}"
    jcfg.update(ckpt_path=str(ckpt), log_dir=str(tmp / f"jax_{tag}"))
    tcfg.update(ckpt_path=str(ckpt), log_dir=str(tmp / f"port_{tag}"))
    spec = importlib.util.spec_from_file_location(
        "jax_extract_mesh", REPO / "tools" / "extract_mesh.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    available, march = jax_native.available, extract_mesh.marching_tetrahedra
    extract, argv, init = extract_mesh.extract_mesh, sys.argv, jax_config.init_cfg
    u = t(jax.random.uniform(jax.random.PRNGKey(0), (Runner.render_chunk_rays,)))
    try:
        if jax_numpy:
            jax_native.available = lambda: False
        if port_numpy:
            extract_mesh.marching_tetrahedra = functools.partial(
                tmarch.marching_tetrahedra, use_native=False)
        sys.argv = ["extract_mesh.py", "--resolution", "48"]
        jax_config.init_cfg = lambda path: None
        tool.mesh()
        extract_mesh.extract_mesh = lambda runner, res: extract(runner, res,
                                                                u=u)
        path = extract_mesh.mesh(["--resolution", "48", "--device", "cpu"])[1]
    finally:
        jax_native.available, extract_mesh.marching_tetrahedra = available, march
        extract_mesh.extract_mesh = extract
        sys.argv, jax_config.init_cfg = argv, init
        for cfg in cfgs:
            cfg.clear()
    got = read_ply(path)[0]
    want = read_ply(Path(str(path).replace(f"port_{tag}", f"jax_{tag}")))[0]
    return got["rgb"].astype(int), want["rgb"].astype(int)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", default="1,2,3,4,5,6")
    args = ap.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        tmp = Path(tempfile.mkdtemp(prefix=f"mesh_order_{seed}_"))
        for case, jax_numpy, port_numpy in (
                ("JAX numpy vs port g++", True, False),
                ("both numpy", True, True)):
            got, want = colours(seed, tmp, jax_numpy, port_numpy)
            diff = np.abs(got - want).max(axis=1) if len(got) == len(want) \
                else None
            if diff is None:
                print(f"seed {seed}, {case}: vertex counts differ "
                      f"({len(got)} vs {len(want)})", flush=True)
                continue
            print(f"seed {seed}, {case}: {len(got)} vertices, largest colour "
                  f"difference {int(diff.max())} levels, "
                  f"{int((diff > 1).sum())} over 1", flush=True)


if __name__ == "__main__":
    main()

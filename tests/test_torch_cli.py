"""The port's CLI (`python -m jnerf_tpu_torch.tools.run_net`): its flags,
its runner choice against the JAX CLI's, and the train, test and render
tasks on a blender-format scene on the CPU; and what the user's path
imports."""

import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_parity import clear_cfgs, write_blender_cfg  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture()
def one_thread():
    """torch on one CPU thread for the test: the suite runs several test
    processes at once, and the CPU bf16 matmuls of a run slow down many
    times over when each process starts a thread per core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_run_net():
    """tools/run_net.py of the JAX package, imported from its path."""
    spec = importlib.util.spec_from_file_location(
        "jax_run_net", os.path.join(REPO, "tools", "run_net.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_help_lists_the_jax_flags_and_device(capsys):
    from jnerf_tpu_torch.tools import run_net

    with pytest.raises(SystemExit) as exit_info:
        run_net.main(["--help"])
    assert exit_info.value.code == 0
    out = capsys.readouterr().out
    for flag in ("--config-file", "--task", "--save_dir", "--type",
                 "--mcube_threshold", "--runner", "--device"):
        assert flag in out
    assert run_net.parse_args([]).device == "cuda"


def test_runner_choice_matches_the_jax_cli():
    """select_runner_name picks what tools/run_net.py picks."""
    from jnerf_tpu_torch.tools.run_net import select_runner_name
    from jnerf_tpu_torch.utils.config import Config

    ref = _jax_run_net().select_runner_name
    cases = [({}, "novel_view"), ({}, "mesh"),
             ({"sampler": {"type": "MipSampler"}}, "novel_view"),
             ({"model": {"type": "SparseGrid"}}, "novel_view"),
             ({"runner": "NeuSRunner"}, "novel_view"),
             ({"sampler": {"type": "DensityGridSampler"},
               "model": {"type": "NGPNetworks"}}, "novel_view")]
    for keys, kind in cases:
        cfg = Config._wrap(keys)
        assert select_runner_name(cfg, kind) == ref(cfg, kind)


def test_unported_tasks_and_missing_card_exit(tmp_path, synthetic_scene,
                                              clear_cfgs):
    """The NeuS, Mip-NeRF and Plenoxels runners and validate_mesh exit with
    a message; --device cuda without a card exits rather than falling back
    to the CPU."""
    from jnerf_tpu_torch.tools import run_net

    path = write_blender_cfg(tmp_path, synthetic_scene)
    for extra in (["--runner", "NeuSRunner"], ["--runner", "MipRunner"],
                  ["--runner", "Svox2Runner"], ["--task", "validate_mesh"],
                  ["--type", "mesh"]):
        with pytest.raises(SystemExit, match="not ported"):
            run_net.main(["--config-file", path, "--device", "cpu"] + extra)
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="CUDA is not available"):
            run_net.main(["--config-file", path])


def test_train_test_render_on_cpu(tmp_path, clear_cfgs, monkeypatch, capsys,
                                  one_thread):
    """On a 16 x 16 blender-format scene that the port writes: --task train
    for 20 steps (Runner.val_freq lowered to 16): plain lines with the
    throughput, a validation render at 16, params.pkl, the test set's
    renders and targets and TOTAL TEST PSNR; --task test from the
    checkpoint reads the same field (a fresh jitter draw: within 0.5 dB);
    --task render writes the mp4 of the spherical path (2 poses)."""
    from jnerf_tpu_torch.dataset import camera_path
    from jnerf_tpu_torch.dataset.dataset_util import read_image
    from jnerf_tpu_torch.dataset.synthetic import make_synthetic_scene
    from jnerf_tpu_torch.runner import Runner
    from jnerf_tpu_torch.tools import run_net

    monkeypatch.setattr(Runner, "val_freq", 16)
    monkeypatch.setattr(Runner, "render_chunk_rays", 256)
    scene = make_synthetic_scene(str(tmp_path / "scene"), n_train=4, n_val=1,
                                 n_test=2, H=16, W=16)
    path = write_blender_cfg(tmp_path, scene, steps=20)
    argv = ["--config-file", path, "--device", "cpu"]
    runner, psnr = run_net.main(argv + ["--task", "train"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "device: cpu (the kernels' plain PyTorch twins)"
    steps = [x for x in lines if x.startswith("STEP=")]
    assert len(steps) == 2 and "VAL PSNR=" in steps[0] and "it/s" in steps[1]
    assert lines[-1] == f"TOTAL TEST PSNR===={psnr}" and np.isfinite(psnr)
    out = tmp_path / "logs" / "lego"
    assert {p.name for p in out.iterdir()} == {"img16.png", "target16.png",
                                               "params.pkl", "test"}
    names = sorted(p.name for p in (out / "test").iterdir())
    assert names == ["lego_gt_0.png", "lego_gt_1.png", "lego_r_0.png",
                     "lego_r_1.png"]
    for name in names:
        assert read_image(str(out / "test" / name)).shape == (16, 16, 3)
    assert runner.optimizer.count == 20

    again, psnr2 = run_net.main(argv + ["--task", "test"])
    assert again.start == 20 and abs(psnr2 - psnr) <= 0.5
    assert "Loading ckpt from" in capsys.readouterr().out

    monkeypatch.setattr(camera_path, "path_spherical", lambda nframe=2: [
        camera_path.pose_spherical(a, -30, 4) for a in (0, 180)])
    _, mp4 = run_net.main(argv + ["--task", "render"])
    assert mp4 == str(out / "demo.mp4") and os.path.getsize(mp4) > 500


def test_user_path_imports_no_jax_or_imaging_library(tmp_path):
    """Importing the CLI, loading a NerfDataset and Runner.train() through a
    validation render, the checkpoint and the test set (PNGs written) pull
    in none of JAX, the JAX package, optax, yaml, PIL, imageio, cv2 or tqdm
    (a fresh interpreter, beyond what torch itself imports): the machine
    with the card has none of them."""
    scene = str(tmp_path / "scene")
    cfg = write_blender_cfg(tmp_path, scene, steps=20)
    code = f"""
import sys
import numpy, torch
torch.set_num_threads(1)
before = set(sys.modules)
import jnerf_tpu_torch.tools.run_net as run_net
from jnerf_tpu_torch.dataset import NerfDataset
from jnerf_tpu_torch.dataset.synthetic import make_synthetic_scene
from jnerf_tpu_torch.runner import Runner
from jnerf_tpu_torch.utils.config import init_cfg
make_synthetic_scene({scene!r}, n_train=3, n_val=1, n_test=1, H=8, W=8)
assert NerfDataset({scene!r}, batch_size=8).n_images == 4
init_cfg({cfg!r})
Runner.val_freq, Runner.render_chunk_rays = 16, 64
Runner(device="cpu").train()
new = {{m.split(".")[0] for m in set(sys.modules) - before}}
print(sorted(new & {{"jax", "jaxlib", "jnerf_tpu", "optax", "yaml", "PIL",
                    "cv2", "imageio", "tqdm"}}))
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert (tmp_path / "logs" / "lego" / "img16.png").is_file()
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_metrics(tmp_path):
    """ThroughputMeter counts rays and samples over its window, StepTimer
    names phases (a CPU tensor needs no synchronize), trace writes a
    torch.profiler Chrome trace, get_log writes its file; the summaries
    read as the JAX package's."""
    import json
    import time

    from jnerf_tpu.utils import metrics as jm
    from jnerf_tpu_torch.utils import metrics as tm

    meters = [tm.ThroughputMeter(window=4), jm.ThroughputMeter(window=4)]
    for meter in meters:
        for _ in range(6):
            meter.tick(n_rays=100, n_samples=1000)
            time.sleep(0.002)
    assert len(meters[0].times) == 4 and sum(meters[0].rays) == 400
    assert meters[0].summary().count("|") == meters[1].summary().count("|")
    assert 0 < meters[0].iters_per_s < 500
    timer = tm.StepTimer()
    with timer.phase("step", sync_value=torch.zeros(2)):
        pass
    assert timer.counts["step"] == 1 and timer.summary().startswith("step: ")
    with tm.trace(str(tmp_path / "trace")):
        torch.ones(8).sum()
    with open(tmp_path / "trace" / "trace.json") as f:
        assert json.load(f)["traceEvents"]
    tm.get_log(str(tmp_path / "log.txt")).info("hello")
    assert "hello" in (tmp_path / "log.txt").read_text()

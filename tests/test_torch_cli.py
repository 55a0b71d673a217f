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

from torch_parity import (  # noqa: F401
    clear_cfgs, write_blender_cfg, write_mip_cfg, write_neus_cfg,
    write_svox2_cfg,
)

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
    """A task the chosen runner lacks exits with the JAX CLI's message
    (validate_mesh on the NGP Runner, render on MipRunner, test and render
    on Svox2Runner), and so does an unknown runner; --device cuda without
    a card exits rather than falling back to the CPU."""
    from jnerf_tpu_torch.tools import run_net

    path = write_blender_cfg(tmp_path, synthetic_scene)
    cpu = ["--config-file", path, "--device", "cpu"]
    with pytest.raises(SystemExit, match="Runner does not implement task "
                       "'validate_mesh'"):
        run_net.main(cpu + ["--task", "validate_mesh"])
    with pytest.raises(SystemExit, match="unknown runner 'NoRunner'"):
        run_net.main(cpu + ["--runner", "NoRunner"])
    mip = write_mip_cfg(tmp_path / "mip", synthetic_scene)
    with pytest.raises(SystemExit, match="MipRunner does not implement task "
                       "'render'"):
        run_net.main(["--config-file", mip, "--device", "cpu", "--task",
                      "render"])
    svox = write_svox2_cfg(tmp_path / "svox", synthetic_scene)
    for task in ("test", "render"):
        with pytest.raises(SystemExit, match=f"Svox2Runner does not "
                           f"implement task '{task}'"):
            run_net.main(["--config-file", svox, "--device", "cpu", "--task",
                          task])
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="CUDA is not available"):
            run_net.main(["--config-file", path])


def test_mip_and_svox2_through_the_cli_on_cpu(tmp_path, synthetic_scene,
                                              clear_cfgs, capsys,
                                              monkeypatch, one_thread):
    """A MipSampler config selects MipRunner: --task train (6 steps,
    _VAL_FREQ lowered to 4: one validation line and img4.png) writes
    params.pkl, and --task test from it reads the PSNR that the trained
    runner's own test() reads; --runner MipRunner on the same file picks
    the same runner.  A SparseGrid config selects Svox2Runner: --task
    train runs its n_iters, crossing an upsample into the sparse grid, and
    writes no file."""
    from jnerf_tpu_torch.runner import MipRunner, Svox2Runner
    from jnerf_tpu_torch.tools import run_net

    monkeypatch.setattr(MipRunner, "_VAL_FREQ", 4)
    mip = write_mip_cfg(tmp_path / "mip", synthetic_scene, tot_train_steps=6,
                        num_samples=8, net_width=32, net_width_condition=16)
    argv = ["--config-file", mip, "--device", "cpu"]
    runner, loss = run_net.main(argv + ["--task", "train"])
    assert isinstance(runner, MipRunner) and np.isfinite(loss)
    assert runner.start == 6 and runner.optimizer.count == 6
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "device: cpu (the kernels' plain PyTorch twins)"
    assert [x.split(" |")[0] for x in lines if x.startswith("STEP=")] == [
        "STEP=4"]
    out = tmp_path / "mip" / "logs" / "mip_smoke"
    assert {p.name for p in out.iterdir()} == {"img4.png", "params.pkl"}
    psnr = runner.test()
    again, psnr2 = run_net.main(argv + ["--task", "test", "--runner",
                                        "MipRunner"])
    assert again.start == 6 and psnr2 == pytest.approx(psnr, abs=1e-4)

    svox = write_svox2_cfg(tmp_path / "svox", synthetic_scene, n_iters=6,
                           upsamp_every=4, sparse_cell_threshold=30000,
                           density_thresh=0.09, sparse_dilate=1)
    runner, mse = run_net.main(["--config-file", svox, "--device", "cpu"])
    assert isinstance(runner, Svox2Runner) and runner.gstep == 6
    assert runner.grid.sparse and runner.grid.spec.reso == (48, 48, 48)
    assert np.isfinite(mse) and "sparse grid: " in capsys.readouterr().out
    assert not any((tmp_path / "svox" / "logs" / "svox2_smoke").iterdir())


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


def test_neus_train_and_validate_mesh_on_cpu(tmp_path, clear_cfgs,
                                            monkeypatch, capsys, one_thread):
    """--type mesh selects NeuSRunner: --task train on a tiny NeuS config
    over a DTU-format scene the port writes (6 steps, a checkpoint at 4 and
    6, report lines), then --task validate_mesh resumes from the latest
    checkpoint and writes the world-space mesh.  The CLI asks for
    resolution 512 and the --mcube_threshold, as tools/run_net.py does;
    the test runs the extraction at 24 so that the CPU takes seconds."""
    from jnerf_tpu_torch.dataset.synthetic import make_synthetic_neus_scene
    from jnerf_tpu_torch.runner import NeuSRunner
    from jnerf_tpu_torch.tools import run_net

    scene = make_synthetic_neus_scene(str(tmp_path / "scan"), n_images=3,
                                      H=16, W=20)
    path = write_neus_cfg(tmp_path, scene, end_iter=6, save_freq=2)
    argv = ["--config-file", path, "--device", "cpu", "--type", "mesh"]
    runner, _ = run_net.main(argv + ["--task", "train"])
    assert isinstance(runner, NeuSRunner) and runner.iter_step == 6
    out = capsys.readouterr().out
    assert "iter:       6 loss = " in out
    ckpts = sorted(os.listdir(tmp_path / "exp" / "checkpoints"))
    assert ckpts == ["ckpt_000002.pkl", "ckpt_000004.pkl", "ckpt_000006.pkl"]

    asked = {}
    orig = NeuSRunner.validate_mesh

    def validate_mesh(self, world_space=False, resolution=64, threshold=0.0):
        asked.update(world_space=world_space, resolution=resolution,
                     threshold=threshold)
        return orig(self, world_space, 24, threshold)

    monkeypatch.setattr(NeuSRunner, "validate_mesh", validate_mesh)
    again, ply = run_net.main(argv + ["--task", "validate_mesh",
                                      "--mcube_threshold", "0.01"])
    assert asked == dict(world_space=True, resolution=512, threshold=0.01)
    assert again.iter_step == 6 and "Find checkpoint: ckpt_000006.pkl" in \
        capsys.readouterr().out
    assert ply == str(tmp_path / "exp" / "meshes_24" / "00000006.ply")
    with open(ply, "rb") as f:
        head = f.read(120)
    assert head.startswith(b"ply\nformat binary_little_endian") \
        and b"element vertex 0" not in head


def test_user_path_imports_no_jax_or_imaging_library(tmp_path):
    """Importing the CLI, loading a NerfDataset and Runner.train() through a
    validation render, the checkpoint and the test set (PNGs written),
    Runner.render (the mp4, on three poses), writing a fox-layout JPEG
    capture and loading it in NerfDataset, the
    NGP mesh tool on that checkpoint, NeuSRunner.train() through a
    validation image (PNGs, the JET depth) and a validation mesh,
    MipRunner.train() through a validation image and its checkpoint,
    Svox2Runner.train() across an upsample into the sparse grid, then its
    .npz, and importing the data-parallel package and its dry run (whose
    spawned ranks import the same), pull in none of JAX, the JAX package,
    optax, yaml, PIL, imageio, cv2 or tqdm (a fresh interpreter, beyond
    what torch itself imports): the machine with the card has none of
    them."""
    scene = str(tmp_path / "scene")
    cfg = write_blender_cfg(tmp_path, scene, steps=20)
    fox = str(tmp_path / "fox")
    neus_scene = str(tmp_path / "scan")
    neus_cfg = write_neus_cfg(tmp_path / "neus", neus_scene, end_iter=3,
                              val_freq=3, val_mesh_freq=3)
    mip_cfg = write_mip_cfg(tmp_path / "mip", scene, tot_train_steps=3,
                            num_samples=8, net_width=32,
                            net_width_condition=16)
    svox_cfg = write_svox2_cfg(tmp_path / "svox", scene, model=dict(
        reso=8, radius=1.4), reso_list=[[8] * 3, [16] * 3], upsamp_every=2,
        n_iters=3, sparse_cell_threshold=1000, density_thresh=0.09,
        batch_size=64, render_n_samples=32)
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
runner = Runner(device="cpu")
runner.train()
from jnerf_tpu_torch.dataset import camera_path
camera_path.path_spherical = lambda: [camera_path.pose_spherical(a, -30, 4)
                                      for a in (0, 120, 240)]
runner.render(load_ckpt=False)
from jnerf_tpu_torch.dataset.synthetic import make_fox_capture
make_fox_capture({fox!r}, n_train=3, n_test=1, H=8, W=12)
assert NerfDataset({fox!r}, batch_size=8).image_data.shape == (3 * 96, 4)
from jnerf_tpu_torch.tools import extract_mesh
extract_mesh.mesh(["--config-file", {cfg!r}, "--resolution", "16",
                   "--device", "cpu"])
from jnerf_tpu_torch.dataset.synthetic import make_synthetic_neus_scene
from jnerf_tpu_torch.runner import NeuSRunner
make_synthetic_neus_scene({neus_scene!r}, n_images=2, H=8, W=12)
init_cfg({neus_cfg!r})
NeuSRunner(device="cpu").train()
from jnerf_tpu_torch.runner import MipRunner, Svox2Runner
MipRunner._VAL_FREQ = 2
init_cfg({mip_cfg!r})
MipRunner(device="cpu").train()
init_cfg({svox_cfg!r})
svox = Svox2Runner(device="cpu")
svox.train()
assert svox.grid.sparse
svox.save()
import jnerf_tpu_torch.parallel, jnerf_tpu_torch.parallel.dryrun
new = {{m.split(".")[0] for m in set(sys.modules) - before}}
print(sorted(new & {{"jax", "jaxlib", "jnerf_tpu", "optax", "yaml", "PIL",
                    "cv2", "imageio", "tqdm"}}))
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert (tmp_path / "logs" / "lego" / "img16.png").is_file()
    assert (tmp_path / "logs" / "lego" / "mesh-color.ply").is_file()
    assert (tmp_path / "logs" / "lego" / "demo.mp4").stat().st_size > 500
    assert len(os.listdir(tmp_path / "fox" / "images")) == 4
    neus = tmp_path / "neus" / "exp"
    assert len(os.listdir(neus / "depths")) == 1
    assert (neus / "meshes_64" / "00000003.ply").is_file()
    mip = tmp_path / "mip" / "logs" / "mip_smoke"
    assert {p.name for p in mip.iterdir()} == {"img2.png", "params.pkl"}
    assert (tmp_path / "svox" / "logs" / "svox2_smoke" / "grid.npz").is_file()
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_project_scripts_import_no_jax_or_imaging_library(tmp_path):
    """Both mini-project scripts, each through its main() with --device cpu
    (full-width model, the analytic scene, the pickle; no training step)
    and through its training functions at a tiny size (every stage
    transition of Recursive-NeRF included), pull in none of JAX, the JAX
    package, optax, yaml, PIL, imageio, cv2 or tqdm in a fresh
    interpreter."""
    code = f"""
import sys
import torch
torch.set_num_threads(1)
before = set(sys.modules)
from jnerf_tpu_torch.projects.pixelnerf import main as pix
from jnerf_tpu_torch.projects.recursive_nerf import main as rec
pix.main(["--synthetic", "--epochs", "0", "--device", "cpu",
          "--out", {str(tmp_path / "pix")!r}])
images, poses, focal = pix.make_synthetic(4, 16, 16)
pix.train(pix.build_model("cpu", net_width=16), images, poses, focal,
          epochs=1, batch=256, n_samples=4)
rec.main(["--synthetic", "--n-iters", "0", "--step1", "0", "--step2", "0",
          "--step3", "0", "--device", "cpu",
          "--out", {str(tmp_path / "rec")!r}])
hist = rec.train(rec.build_model("cpu", width=16), images[:2], poses[:2],
                 focal, n_iters=4, step1=1, step2=2, step3=3, n_rand=16,
                 n_samples=4)
assert hist["transitions"] == [1, 2, 3]
new = {{m.split(".")[0] for m in set(sys.modules) - before}}
print(sorted(new & {{"jax", "jaxlib", "jnerf_tpu", "optax", "yaml", "PIL",
                    "cv2", "imageio", "tqdm"}}))
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert (tmp_path / "pix" / "pixelnerf.pkl").is_file()
    assert (tmp_path / "rec" / "recursive_nerf.pkl").is_file()
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

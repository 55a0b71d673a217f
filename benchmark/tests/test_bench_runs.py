"""Whole runs of each cell at a tiny size on the CPU: the program against
the plain reference under the cells' own limits, the check's control and
planted faults coming out not correct, and a run's process holding no JAX.
The card's own run of each cell is marked ``cuda``."""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import cells, readings, run

sys.path.insert(0, str(cells.HERE / "tests"))
import tiny  # noqa: E402

SEED = 4_100_000_017


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.layout(tmp_path_factory.mktemp("bench"))


@pytest.fixture(autouse=True)
def cache(tmp_path_factory, monkeypatch):
    monkeypatch.setattr(run, "CACHE", tmp_path_factory.getbasetemp() / "c")


@pytest.mark.parametrize("name", ["ngp_base.train", "ngp_base.render"])
def test_program_matches_reference(root, name):
    cell = cells.load(name, root=root)
    res = run.run_cell(cell, SEED, 0.5, False, "cpu")
    assert res["correct"], res["check"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert {m["name"] for m in cell.end_to_end} == set(res["metrics"])
    assert list(res)[-1] == "check"


def test_traced_run_reports_per_layer_metrics(root):
    cell = cells.load("ngp_base.train", root=root)
    res = run.run_cell(cell, SEED + 1, 0.5, True, "cpu")
    assert res["correct"], res["check"]
    # No device ran: idle is the whole window; no kernel, no roofline.
    assert res["metrics"]["idle_share.train"]["value"] == 100.0
    assert "hash_fwd_roofline.train" not in res["metrics"]
    assert res["metrics"]["kept_samples_per_step.train"]["value"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def test_unchanged_state_is_not_correct(root, monkeypatch):
    from jnerf_tpu_torch.optims import AdamOptimizer

    def no_update(self, closure=None, row=None):
        self.count += 1

    monkeypatch.setattr(AdamOptimizer, "step", no_update)
    res = run.run_cell(cells.load("ngp_base.train", root=root), SEED, 0.2, False,
                       "cpu")
    assert not res["correct"]
    assert res["check"]["change_gap"]["value"] == pytest.approx(1.0)


def test_half_batch_is_not_correct(root, monkeypatch):
    from jnerf_tpu_torch.models.losses import HuberLoss

    whole = HuberLoss.__call__

    def half(self, x, target):
        k = x.shape[0] // 2
        return whole(self, x[:k], target[:k])

    monkeypatch.setattr(HuberLoss, "__call__", half)
    res = run.run_cell(cells.load("ngp_base.train", root=root), SEED, 0.2,
                       False, "cpu")
    assert not res["correct"], res["check"]


def test_planted_half_batch_of_the_readings_is_not_correct(root):
    res = run.run_cell(cells.load("ngp_base.train", root=root), SEED, 0.2,
                       False, "cpu", plant=readings.plant_half_batch)
    assert not res["correct"], res["check"]


def test_moved_shape_fails_the_run(root, monkeypatch):
    from benchmark import program

    window = program.train_window

    def moving(runner, *a, **k):
        # Windows that march one sample a step until the controller moves.
        while not runner.sampler.update_batch_rays(1.0):
            pass
        return window(runner, *a, **k)

    monkeypatch.setattr(program, "train_window", moving)
    with pytest.raises(run.ShapeMoved):
        run.run_cell(cells.load("ngp_base.train", root=root), SEED, 0.2,
                     False, "cpu")


def test_altered_answer_is_not_correct(root, monkeypatch):
    from jnerf_tpu_torch.runner import Runner

    render = Runner.render_img_with_pose

    def altered(self, pose, u=None):
        img = np.array(render(self, pose, u=u))
        img[:4, :4] += 0.25
        return img

    monkeypatch.setattr(Runner, "render_img_with_pose", altered)
    res = run.run_cell(cells.load("ngp_base.render", root=root), SEED, 0.5, False,
                       "cpu")
    assert not res["correct"], res["check"]


@pytest.mark.parametrize("name", ["ngp_base.train", "ngp_base.render"])
def test_control_is_not_correct(root, name):
    res = run.run_cell(cells.load(name, root=root), SEED, 0.2, False, "cpu",
                       control=True)
    assert not res["correct"], res["check"]


def test_a_run_loads_no_jax(root, tmp_path):
    code = (
        "import json, sys\n"
        "from pathlib import Path\n"
        "sys.path.insert(0, sys.argv[1])\n"
        "from benchmark import cells, run\n"
        "run.CACHE = Path(sys.argv[3])\n"
        "cell = cells.load('ngp_base.render', root=Path(sys.argv[2]))\n"
        "run.run_cell(cell, 7, 0.2, False, 'cpu')\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run(
        [sys.executable, "-c", code, str(cells.HERE / "tests"), str(root),
         str(tmp_path)], capture_output=True, text=True, cwd=cells.REPO,
        timeout=600, check=True)
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "jnerf_tpu_torch" in loaded
    assert not loaded & set(run.FORBIDDEN), loaded & set(run.FORBIDDEN)


def test_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", "ngp_base.train",
         "--seed", "1", "--seconds", "1"], capture_output=True, text=True,
        cwd=cells.REPO, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ngp_base.train", "ngp_base.render"])
def test_cell_on_the_card(card, name):
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", name, "--seed",
         str(SEED), "--seconds", "2", "--trace", "0"], capture_output=True,
        text=True, cwd=cells.REPO, timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"

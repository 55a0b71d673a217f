"""The port's quality tool (`python3 -m jnerf_tpu_torch.tools.ceiling_run`)
on the CPU at a tiny size: its JSON, its checkpoint, its file names, and
its refusal to run on a missing card."""

import json
import math
import pickle

import pytest
import torch


def test_two_eval_cpu_run(tmp_path, monkeypatch):
    """32 steps of the tiny f8l4 config on the 16x16 hard scene at ssaa 2,
    an eval every 16: two trajectory points with finite PSNR over the 4
    val views, the ceiling the best of them, and the field saved under
    work_dirs/ of the working directory."""
    from jnerf_tpu_torch.tools import ceiling_run
    from jnerf_tpu_torch.utils import bench_cfg

    real = bench_cfg.ngp_synthetic_cfg

    def tiny(**kw):
        kw.update(n_images=4, n_rays_per_batch=256, target_batch_size=1 << 12,
                  grid_size=32, nerf_steps=128, log2_hashmap_size=13)
        return real(**kw)

    monkeypatch.setattr(bench_cfg, "ngp_synthetic_cfg", tiny)
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "q.json"
    ceiling_run.main(["--device", "cpu", "--steps", "32", "--eval-every", "16",
                      "--image-size", "16", "--encoder", "f8l4",
                      "--scene", "hard", "--compact", "--compact-m", "10",
                      "--fast-cap", "4096", "--seed", "7", "--out", str(out)])
    res = json.loads(out.read_text())
    assert {"psnr_ceiling", "psnr_final", "per_view_psnr", "iters", "encoder",
            "fast_cap", "git_rev", "compact", "scene", "use_pallas_mlp",
            "seed", "trajectory", "setup_s", "train_steps_per_s",
            "elapsed_s", "backend", "card", "ckpt"} == set(res)
    assert res["backend"] == "cpu" and res["card"] == "cpu"
    assert res["scene"] == "synthetic-hard-16-ssaa2"
    assert res["compact"] == "m=2^10,f=2" and res["seed"] == 7
    assert [t["iters"] for t in res["trajectory"]] == [16, 32]
    assert all(len(t["per_view_psnr"]) == 4 and math.isfinite(t["psnr"])
               for t in res["trajectory"])
    assert res["psnr_ceiling"] == max(t["psnr"] for t in res["trajectory"])
    assert res["per_view_psnr"] == res["trajectory"][-1]["per_view_psnr"]
    with open(tmp_path / res["ckpt"], "rb") as f:
        assert pickle.load(f)["global_step"] == 32
    assert res["ckpt"] == "work_dirs/torch/q/params.pkl"


def test_default_names():
    """The headline's runs are named after its config, scene, MLP path
    and seed, under logs/torch/."""
    from jnerf_tpu_torch.tools import ceiling_run

    head = ["--encoder", "f8l4", "--scene", "hard", "--fast-cap", "524288",
            "--compact", "--compact-m", "17"]
    args = ceiling_run.parse_args(head)
    assert ceiling_run.config_name(args) == "f8l4_m17f2k19_hard_plain_s42"
    args = ceiling_run.parse_args(head + ["--pallas-mlp", "--seed", "43"])
    assert ceiling_run.config_name(args) == "f8l4_m17f2k19_hard_fused_s43"
    assert args.device == "cuda" and args.steps == 40_000


def test_refuses_missing_cuda():
    """Without a card the tool exits before building anything, unless
    given --device cpu; it never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is present here")
    from jnerf_tpu_torch.tools import ceiling_run

    with pytest.raises(SystemExit, match="needs an NVIDIA GPU"):
        ceiling_run.main(["--steps", "16"])


def test_bf16_rays_probe(tmp_path, monkeypatch):
    """The probe's rays differ from the port's only by the bf16 rounding of
    the product's operands (a direction error under 2^-7, and not none),
    it writes the quality tool's JSON under a name of its own, and it puts
    the port's ray functions back when it is done."""
    from jnerf_tpu_torch.dataset import dataset, procedural
    from jnerf_tpu_torch.dataset.camera_path import pose_spherical
    from jnerf_tpu_torch.runner import runner
    from jnerf_tpu_torch.tools import bf16_rays_probe as probe
    from jnerf_tpu_torch.tools import ceiling_run

    pose = torch.from_numpy(dataset.matrix_nerf2ngp(
        pose_spherical(30.0, -30.0, 4.0), 0.33, [0.5, 0.5, 0.5]))
    fl, pp = torch.tensor([40.0, 42.0]), torch.tensor([0.45, 0.55])
    _, want = dataset.rays_for_image(pose, fl, pp, 24, 16)
    _, got = probe.rays_for_image(pose, fl, pp, 24, 16)
    err = float((got - want).abs().max())
    assert 0 < err < 2 ** -7
    idx = torch.arange(0, 2 * 24 * 16, 7)
    args = (torch.stack([pose, pose]), torch.stack([fl, fl]),
            torch.stack([pp, pp]), 24, 16)
    _, _, want = dataset.rays_from_pixels(idx, *args)
    _, _, got = probe.rays_from_pixels(idx, *args)
    assert 0 < float((got - want).abs().max()) < 2 ** -7

    seen = {}
    monkeypatch.setattr(ceiling_run, "main", lambda argv: seen.update(
        argv=argv, rays=(runner.rays_from_pixels, procedural.rays_for_image)))
    monkeypatch.setattr(ceiling_run, "REPO", tmp_path)
    probe.main(["--encoder", "f8l4", "--scene", "hard", "--seed", "43"])
    assert seen["argv"][-2:] == [
        "--out", str(tmp_path / "logs" / "torch"
                     / "ceiling_f8l4_hard_plain_s43_bf16rays.json")]
    assert seen["rays"] == (probe.rays_from_pixels, probe.rays_for_image)
    assert runner.rays_from_pixels is dataset.rays_from_pixels
    assert procedural.rays_for_image is dataset.rays_for_image

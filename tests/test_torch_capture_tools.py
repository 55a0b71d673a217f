"""The port's tools over real captures on the CPU at a tiny size:
`tools/fox_run.py` (its result keys against the JAX tool's) and
`tools/capture_probe.py`."""

import json
import shutil

import numpy as np

from test_torch_capture import REPO, fox_capture, one_thread  # noqa: F401
from torch_parity import clear_cfgs  # noqa: F401


def test_fox_run_keys_match_the_jax_tool(tmp_path, fox_capture, monkeypatch,
                                         clear_cfgs, one_thread):
    """jnerf_tpu_torch.tools.fox_run in both modes, for a few steps with
    --eval-scale 4 on the tiny capture as the checkout's data/fox (the
    config shrunk after loading, as the test of ceiling_run shrinks its
    config): the result keys of tools/fox_run.py, finite PSNRs over the 2
    test views, one JSON line."""
    import ast

    from jnerf_tpu_torch.runner import Runner
    from jnerf_tpu_torch.tools import fox_run
    from jnerf_tpu_torch.utils import config

    monkeypatch.setattr(Runner, "render_chunk_rays", 64)
    root = tmp_path / "checkout"
    shutil.copytree(REPO / "projects" / "ngp" / "configs",
                    root / "projects" / "ngp" / "configs")
    shutil.copytree(fox_capture, root / "data" / "fox")
    monkeypatch.setattr(fox_run, "REPO", str(root))
    monkeypatch.chdir(tmp_path)
    real = config.init_cfg

    def tiny(path):
        real(path)
        config.get_cfg().update(
            n_rays_per_batch=256, target_batch_size=1 << 12, grid_size=32,
            nerf_steps=128, log_dir=str(tmp_path / "logs"))
        config.get_cfg().encoder.pos_encoder.update(log2_hashmap_size=11)

    monkeypatch.setattr(config, "init_cfg", tiny)
    # The JAX tool's result keys, read from its source (it needs data/fox).
    src = (REPO / "tools" / "fox_run.py").read_text()
    keys = {"ceiling": set(), "budget": set(), "common": set()}
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Dict) and node.keys and all(
                isinstance(k, ast.Constant) for k in node.keys):
            found = {k.value for k in node.keys}
            if "psnr_ceiling" in found:
                keys["ceiling"] = found
            elif "psnr_at_budget" in found:
                keys["budget"] = found
            elif "git_rev" in found:
                keys["common"] = found
    assert all(keys.values())
    out = tmp_path / "c.json"
    res = fox_run.main(["--device", "cpu", "--steps", "4", "--eval-every", "2",
                        "--eval-scale", "4", "--compact-m", "10",
                        "--out", str(out)])
    assert set(res) == keys["ceiling"] | keys["common"]
    assert json.loads(out.read_text()) == res
    assert [t["iters"] for t in res["trajectory"]] == [2, 4]
    assert len(res["per_view_psnr"]) == 2 and np.isfinite(res["psnr_final"])
    assert res["backend"] == "cpu" and res["compact"] == "m=2^10,f=2"
    res = fox_run.main(["--device", "cpu", "--mode", "budget", "--budget-s",
                        "0", "--warmup-steps", "2", "--eval-scale", "4",
                        "--out", str(tmp_path / "b.json")])
    assert set(res) == keys["budget"] | keys["common"]
    assert res["iters"] == 0 and np.isfinite(res["psnr_at_budget"])


def test_capture_probe_runs(monkeypatch, clear_cfgs, one_thread):
    """tools/capture_probe.py at a tiny size on the CPU (the configs shrunk
    after loading): one result for each of its four capture layouts, the
    fox captures at 1/48 and the LLFF ones at 1/48 of their sizes."""
    from jnerf_tpu_torch.runner import Runner
    from jnerf_tpu_torch.tools import capture_probe
    from jnerf_tpu_torch.utils import config

    real = config.init_cfg

    def tiny(path):
        real(path)
        config.get_cfg().update(n_rays_per_batch=256,
                                target_batch_size=1 << 12, grid_size=32,
                                nerf_steps=128)
        config.get_cfg().encoder.pos_encoder.update(
            n_levels=4, n_features_per_level=8, log2_hashmap_size=11)

    monkeypatch.setattr(config, "init_cfg", tiny)
    monkeypatch.setattr(Runner, "render_chunk_rays", 256)
    res = capture_probe.main(["--device", "cpu", "--scale", "48",
                              "--fox-steps", "2", "--llff-steps", "2"])
    assert [r["variant"] for r in res] == ["fox near", "fox far",
                                           "llff ellipse", "llff grid"]
    assert [r["size"] for r in res] == [[10, 5]] * 2 + [[10, 7]] * 2
    assert all(np.isfinite(r["test_psnr"]) and len(r["train_view_psnr"]) == 2
               for r in res)

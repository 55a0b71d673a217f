"""The real-capture path on the CPU against the JAX package: a fox-layout
JPEG capture in NerfDataset, an LLFF capture whose JPEG sources are
minified, training steps of ngp_fox.py (aabb_scale 4: three cascades,
cone-angle steps) on the same params, grid and draws, and the CLI's
render task.  The tools over captures: tests/test_torch_capture_tools.py."""

import os
import shutil
import textwrap
from pathlib import Path

import cv2
import jax
import numpy as np
import pytest

from torch_parity import (  # noqa: F401
    assert_one_step_matches, clear_cfgs, n, port_grid_state,
)

REPO = Path(__file__).resolve().parents[1]
NGP_FOX = str(REPO / "projects" / "ngp" / "configs" / "ngp_fox.py")


@pytest.fixture()
def one_thread():
    """torch on one CPU thread for the test: the suite runs several test
    processes at once, and a thread per core each slows all of them."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def fox_capture(tmp_path_factory):
    from jnerf_tpu_torch.dataset.synthetic import make_fox_capture

    root = tmp_path_factory.mktemp("fox") / "fox"
    return make_fox_capture(str(root), n_train=6, n_test=2, H=24, W=40)


def write_fox_cfg(tmp_path, scene, steps=4):
    """ngp_fox.py over ``scene``, shrunk as tests/torch_parity.py shrinks
    ngp_base.py (4 levels of 8 features, 2^11-entry tables, 256 rays, a
    32^3 grid, compaction to 1024 samples), with the linear_nbr hash."""
    path = Path(tmp_path) / "cfg_fox.py"
    path.write_text(textwrap.dedent(f"""\
        _base_ = {NGP_FOX!r}
        dataset_dir = {str(scene)!r}
        dataset = dict(train=dict(root_dir=dataset_dir, batch_size=256),
                       val=dict(root_dir=dataset_dir, batch_size=256),
                       test=dict(root_dir=dataset_dir, batch_size=256))
        log_dir = {str(Path(tmp_path) / "logs")!r}
        tot_train_steps = {steps}
        hash_indexing = "linear_nbr"
        encoder = dict(pos_encoder=dict(type="HashEncoder", n_levels=4,
                                        n_features_per_level=8,
                                        log2_hashmap_size=11))
        n_rays_per_batch = 256
        target_batch_size = 1 << 12
        compacted_batch = 1024
        march_budget_factor = 2
        grid_size = 32
        nerf_steps = 128
        seed = 0
    """))
    return str(path)


@pytest.mark.parametrize("mode", ["train", "test"])
def test_fox_capture_loads_as_in_jax(fox_capture, mode):
    """The JPEG photographs, poses, intrinsics (fl_x/fl_y, cx/cy), the
    distortion metadata, aabb_scale 4 and the rays equal the JAX loader's
    (images bit for bit: the same decoder output)."""
    from jnerf_tpu.dataset.dataset import NerfDataset as JaxNerfDataset
    from jnerf_tpu_torch.dataset import NerfDataset

    port = NerfDataset(fox_capture, batch_size=64, mode=mode)
    ref = JaxNerfDataset(fox_capture, batch_size=64, mode=mode)
    assert (port.n_images, port.H, port.W) == (ref.n_images, 24, 40)
    assert port.n_images == {"train": 6, "test": 2}[mode]
    assert port.aabb_scale == ref.aabb_scale == 4
    assert port.aabb_range == ref.aabb_range
    np.testing.assert_array_equal(n(port.image_data), n(ref.image_data))
    assert float(n(port.image_data)[:, 3].min()) == 1.0  # opaque
    np.testing.assert_array_equal(n(port.transforms_gpu), n(ref.transforms_gpu))
    np.testing.assert_array_equal(n(port.focal_lengths), n(ref.focal_lengths))
    np.testing.assert_array_equal(n(port.principal_points),
                                  n(ref.principal_points))
    np.testing.assert_array_equal(port.metadata, ref.metadata)
    assert port.metadata[0, 0] == np.float32(0.0125)
    for i in range(port.n_images):
        for a, b in zip(port.generate_rays_total_test(i),
                        ref.generate_rays_total_test(i)):
            np.testing.assert_allclose(n(a), n(b), rtol=1e-6, atol=1e-7)


def test_llff_jpeg_sources_minify_as_in_jax(tmp_path):
    """An LLFF capture with JPEG sources (IMG_*.JPG): both packages write
    images_2/ with the same PNG names and, decoded, the same pixels (the
    JAX package through cv2: imread, INTER_AREA, imwrite), and load the
    same images, poses and focal."""
    from jnerf_tpu.dataset.llff_dataset import LLFFDataset as JaxLLFF
    from jnerf_tpu_torch.dataset import LLFFDataset
    from jnerf_tpu_torch.dataset.dataset_util import read_image_u8
    from jnerf_tpu_torch.dataset.synthetic import make_llff_capture

    port_root = make_llff_capture(str(tmp_path / "port"), n_views=6, H=48,
                                  W=64)
    jax_root = str(tmp_path / "jax")
    shutil.copytree(port_root, jax_root)
    for mode in ("train", "test"):
        port = LLFFDataset(port_root, batch_size=32, mode=mode, factor=2,
                           llffhold=3, aabb_scale=64)
        ref = JaxLLFF(jax_root, batch_size=32, mode=mode, factor=2,
                      llffhold=3, aabb_scale=64)
        assert (port.n_images, port.H, port.W) == (ref.n_images, 24, 32)
        np.testing.assert_array_equal(n(port.image_data), n(ref.image_data))
        np.testing.assert_allclose(n(port.transforms_gpu),
                                   n(ref.transforms_gpu), rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(n(port.focal_lengths),
                                      n(ref.focal_lengths))
    names = sorted(os.listdir(os.path.join(port_root, "images_2")))
    assert names == sorted(os.listdir(os.path.join(jax_root, "images_2")))
    assert names == [f"IMG_{i:04d}.png" for i in range(6)]
    for name in names:
        got = read_image_u8(os.path.join(port_root, "images_2", name))
        want = cv2.imread(os.path.join(jax_root, "images_2", name),
                          cv2.IMREAD_UNCHANGED)[..., ::-1]
        np.testing.assert_array_equal(got, want)


def test_fox_steps_match_jax(tmp_path, fox_capture, clear_cfgs, one_thread):
    """ngp_fox.py (aabb_scale 4 from the json: three cascades; const_dt
    False: cone-angle steps) at the tiny widths: the port's Runner and the
    JAX package's, built from one config file, take training steps on the
    same params, grid state and draws, after a grid refresh and after
    another, at tests/test_torch_step.py's tolerances."""
    from jnerf_tpu.runner import Runner as JaxRunner
    from jnerf_tpu.utils.config import init_cfg as jax_init
    from jnerf_tpu_torch.runner import Runner
    from jnerf_tpu_torch.utils.config import init_cfg
    from jnerf_tpu_torch.utils.convert import jax_params_to_state_dict

    path = write_fox_cfg(tmp_path, fox_capture)
    jax_init(path)
    init_cfg(path)
    jr = JaxRunner()
    tr = Runner(device="cpu")
    assert repr(tr.sampler.grid_config) == repr(jr.sampler.grid_config)
    assert tr.sampler.grid_config.max_cascade + 1 == 3
    assert not tr.sampler.const_dt and tr.sampler.march_config.cone_angle > 0
    tr.model.load_state_dict(
        jax_params_to_state_dict(jax.tree.map(np.asarray, jr.params)))
    for i, key in enumerate((1, 2)):
        jr._update_grid(i, jax.random.PRNGKey(key))
        tr.sampler.load_state_dict(port_grid_state(jr.sampler.state))
        tr.model.zero_grad(set_to_none=True)
        assert_one_step_matches(jr, tr, key=jax.random.PRNGKey(10 + key),
                                min_valid=64)


def test_render_task_writes_80_frames(tmp_path, clear_cfgs, monkeypatch,
                                      one_thread):
    """run_net --task train then --task render --device cpu on a 12 x 8
    fox-layout capture: demo.mp4 reads back in cv2 as the spherical path's
    80 frames at 12 x 8, 28 fps."""
    from jnerf_tpu_torch.dataset.synthetic import make_fox_capture
    from jnerf_tpu_torch.runner import Runner
    from jnerf_tpu_torch.tools import run_net

    scene = make_fox_capture(str(tmp_path / "fox"), n_train=4, n_test=2, H=8,
                             W=12)
    monkeypatch.setattr(Runner, "render_chunk_rays", 96)
    path = write_fox_cfg(tmp_path, scene, steps=2)
    argv = ["--config-file", path, "--device", "cpu"]
    run_net.main(argv + ["--task", "train"])
    _, mp4 = run_net.main(argv + ["--task", "render"])
    assert mp4 == str(tmp_path / "logs" / "fox" / "demo.mp4")
    cap = cv2.VideoCapture(mp4)
    info = (cap.get(cv2.CAP_PROP_FRAME_COUNT), cap.get(cv2.CAP_PROP_FRAME_WIDTH),
            cap.get(cv2.CAP_PROP_FRAME_HEIGHT), cap.get(cv2.CAP_PROP_FPS))
    frames = 0
    while cap.read()[0]:
        frames += 1
    assert info == (80, 12, 8, 28) and frames == 80

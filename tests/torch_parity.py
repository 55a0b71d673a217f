"""Shared helpers for the PyTorch port's parity tests (tests/test_torch_*.py).

Each parity test makes its inputs with numpy from a seed, runs them
through the JAX package (on the CPU) and through the port (on the CPU,
where every kernel wrapper takes its plain PyTorch twin), and compares the
results at a tolerance it states.
"""

from __future__ import annotations

import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

NGP_BASE = str(Path(__file__).resolve().parents[1]
               / "projects" / "ngp" / "configs" / "ngp_base.py")
NEUS_WOMASK = str(Path(__file__).resolve().parents[1]
                  / "projects" / "neus" / "configs" / "neus_womask.py")
NEUS_RAYS = 64  # rays of a NeuS batch at the tests' size

# A tiny NGP slice: 4 levels of 8 features over 2^13-entry tables, a 32^3
# occupancy grid, 256 rays; compaction on, as in the bench headline.
TINY_NGP = dict(n_images=4, H=32, W=32, n_rays_per_batch=256,
                target_batch_size=1 << 12, grid_size=32, nerf_steps=128,
                hash_levels=4, hash_features=8, log2_hashmap_size=13)
TINY_EXTRA = dict(compacted_batch=1024, march_budget_factor=2,
                  hash_indexing="linear_nbr")


def t(x, dtype=None) -> torch.Tensor:
    """numpy (or JAX) array -> CPU tensor."""
    out = torch.from_numpy(np.array(x))
    return out if dtype is None else out.to(dtype)


def j(x) -> jnp.ndarray:
    """numpy array or tensor -> JAX array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return jnp.asarray(np.asarray(x))


def n(x) -> np.ndarray:
    """tensor or JAX array -> numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@pytest.fixture()
def both_cfgs(tmp_path):
    """Install the same tiny NGP config in both packages' global config
    singletons; both are cleared again after the test."""
    from jnerf_tpu.utils.bench_cfg import ngp_synthetic_cfg as jax_cfg
    from jnerf_tpu_torch.utils.bench_cfg import ngp_synthetic_cfg as port_cfg

    cfgs = []
    for make in (jax_cfg, port_cfg):
        cfg = make(**TINY_NGP)
        cfg.update(TINY_EXTRA)
        cfg.log_dir = str(tmp_path / "logs")
        cfgs.append(cfg)
    yield tuple(cfgs)
    for cfg in cfgs:
        cfg.clear()


def jax_key_draws(key, n_rays: int, n_pixels: int):
    """The draws one JAX train step makes from its key
    (`jnerf_tpu/runner/runner.py:157-166` and the march start jitter of
    `ops/ray_march.py:215`), as numpy: (idx, u, bg)."""
    k_pix, k_march, k_bg = jax.random.split(key, 3)
    idx = jax.random.randint(k_pix, (n_rays,), 0, n_pixels)
    u = jax.random.uniform(k_march, (n_rays,))
    bg = jax.random.uniform(k_bg, (n_rays, 3))
    return n(idx), n(u), n(bg)


def jax_sweep_jitter(key, n_casc: int, n_sweep: int) -> np.ndarray:
    """The jitter the JAX sweep refresh draws from its key
    (`density_grid_sampler.py:338-346`), as [n_casc, 3, n_sweep]."""
    keys = jax.random.split(key, 3 * n_casc)
    return np.stack([
        np.stack([n(jax.random.uniform(keys[3 * c + d], (n_sweep,)))
                  for d in range(3)])
        for c in range(n_casc)])


def port_grid_state(jax_state) -> dict:
    """A JAX sampler state -> the port's (numpy in between)."""
    return {
        "density_grid": n(jax_state["density_grid"]),
        "bitfield": n(jax_state["bitfield"]),
        "mean": n(jax_state["mean"]),
        "ema_step": int(n(jax_state["ema_step"])),
    }


def grad_capture():
    """An optax transform that applies no update and keeps the gradients
    it was given in its state, so the JAX step's gradients can be read."""
    return optax.GradientTransformation(
        init=lambda p: {"g": jax.tree.map(jnp.zeros_like, p)},
        update=lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), {"g": g}),
    )


def write_blender_cfg(tmp_path, scene, indexing="linear_rows", steps=40):
    """A user's config file over a blender-format scene: ngp_base.py with
    the data, logs, steps and hash indexing overridden, shrunk to a tiny
    NGP (4 levels of 8 features, 2^11-entry tables, 256 rays, a 32^3
    grid, compaction to 1024 samples; with F = 8 the JAX package's linear
    mode takes its Pallas backward, in interpret mode on the CPU, whose
    table gradient the port's kernel B computes)."""
    path = Path(tmp_path) / f"cfg_{indexing}.py"
    path.write_text(textwrap.dedent(f"""\
        _base_ = {NGP_BASE!r}
        dataset_dir = {str(scene)!r}
        dataset = dict(train=dict(root_dir=dataset_dir, batch_size=256),
                       val=dict(root_dir=dataset_dir, batch_size=256),
                       test=dict(root_dir=dataset_dir, batch_size=256))
        log_dir = {str(Path(tmp_path) / "logs")!r}
        tot_train_steps = {steps}
        hash_indexing = {indexing!r}
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


@pytest.fixture()
def clear_cfgs():
    """Clear both packages' global config singletons after the test."""
    from jnerf_tpu.utils.config import get_cfg as jax_cfg
    from jnerf_tpu_torch.utils.config import get_cfg as port_cfg

    yield
    jax_cfg().clear()
    port_cfg().clear()


def assert_one_step_matches(jr, tr, key=None, min_valid=1):
    """One training step of the JAX runner ``jr`` and of the port's ``tr``
    (the port's params and grid state already converted from ``jr``'s) on
    the same draws from the JAX step's key: the loss at rtol 1e-3 and, per
    gradient tensor, max |diff| <= 2e-2 and mean |diff| <= 1e-3 of its
    largest entry (bf16 MLP chains whose f32 sums run in another order; see
    tests/test_torch_step.py).  The march must keep at least ``min_valid``
    samples.  Returns (n_rays, n_samples)."""
    from jnerf_tpu_torch.utils.convert import (
        jax_params_to_state_dict, state_dict_to_jax_params,
    )

    jr.tx, jr.ema = grad_capture(), None
    n_rays, n_samples = jr.sampler.n_rays_per_batch, jr.sampler.n_samples_per_ray
    assert (n_rays, n_samples) == (tr.sampler.n_rays_per_batch,
                                   tr.sampler.n_samples_per_ray)
    step = jax.jit(jr._step_fn_body(n_rays, n_samples))
    key = jax.random.PRNGKey(7) if key is None else key
    _, opt_state, _, _, jloss = step(jr.params, jr.tx.init(jr.params), None,
                                     jr.sampler.state, jr._train_data(), key)

    ds = tr.dataset["train"]
    idx, u, bg = jax_key_draws(key, n_rays, ds.n_images * ds.H * ds.W)
    total, main, samples = tr.forward_loss(n_rays, n_samples,
                                           idx=t(idx, torch.int64), bg=t(bg),
                                           u=t(u))
    assert int(samples.valid.sum()) >= min_valid
    np.testing.assert_allclose(float(main.detach()), float(jloss), rtol=1e-3)
    total.backward()
    jgrads = state_dict_to_jax_params(
        jax_params_to_state_dict(jax.tree.map(np.asarray, opt_state["g"])))
    grads = state_dict_to_jax_params(
        {name: p.grad for name, p in tr.model.named_parameters()})
    for (path, got), ref in zip(jax.tree_util.tree_leaves_with_path(grads),
                                jax.tree.leaves(jgrads)):
        scale = float(np.abs(ref).max())
        assert scale > 0, path
        diff = np.abs(got - ref)
        name = jax.tree_util.keystr(path)
        assert diff.max() <= 2e-2 * scale, (name, diff.max() / scale)
        assert diff.mean() <= 1e-3 * scale, (name, diff.mean() / scale)
    return n_rays, n_samples


def write_neus_cfg(tmp_path, scene, end_iter=4, **extra):
    """A user's NeuS config: neus_womask.py over a DTU-format ``scene``,
    shrunk to an SDF of 3 layers of 64 (skip at 2), a colour MLP of 2 x 32,
    a 3 x 32 background NeRF (skip at 1) and batches of NEUS_RAYS rays of
    16 + 16 + 4 samples; ``extra`` keys are appended."""
    Path(tmp_path).mkdir(parents=True, exist_ok=True)
    path = Path(tmp_path) / "neus_cfg.py"
    lines = "".join(f"{k} = {v!r}\n" for k, v in extra.items())
    path.write_text(textwrap.dedent(f"""\
        _base_ = {NEUS_WOMASK!r}
        dataset = dict(dataset_dir={str(scene)!r})
        base_exp_dir = {str(Path(tmp_path) / "exp")!r}
        end_iter = {end_iter}
        batch_size = {NEUS_RAYS}
        warm_up_end = 2
        anneal_end = 8
        val_freq = 100000
        val_mesh_freq = 100000
        save_freq = 100000
        report_freq = 2
        validate_resolution_level = 4
        seed = 0
        model = dict(
            nerf_network=dict(D=3, W=32, skips=[1]),
            sdf_network=dict(d_out=65, d_hidden=64, n_layers=3, skip_in=[2]),
            rendering_network=dict(d_feature=64, d_hidden=32, n_layers=2))
        render = dict(n_samples=16, n_importance=16, n_outside=4,
                      up_sample_steps=2, perturb=1.0, _cover_=True,
                      type="NeuSRenderer")
    """) + lines)
    return str(path)


def read_ply(path):
    """A binary PLY of `ops.marching.write_ply` -> (vertex records with
    "xyz" f32 [3] and, if coloured, "rgb" uint8 [3]; faces [F, 3] int32)."""
    data = Path(path).read_bytes()
    head, body = data.split(b"end_header\n", 1)
    nv = int(head.split(b"element vertex ")[1].split(b"\n")[0])
    nf = int(head.split(b"element face ")[1].split(b"\n")[0])
    color = b"property uchar red" in head
    rec = np.dtype([("xyz", np.float32, 3)]
                   + ([("rgb", np.uint8, 3)] if color else []))
    verts = np.frombuffer(body[:rec.itemsize * nv], rec)
    faces = np.frombuffer(body[rec.itemsize * nv:],
                          [("n", np.uint8), ("idx", np.int32, 3)])
    assert len(faces) == nf and (faces["n"] == 3).all()
    return verts, faces["idx"]


MIP_BASE = str(Path(__file__).resolve().parents[1]
               / "projects" / "mipnerf" / "configs" / "mip_base.py")
SVOX2_BASE = str(Path(__file__).resolve().parents[1]
                 / "projects" / "svox2" / "configs" / "svox2_base.py")


def write_mip_cfg(tmp_path, scene, **extra):
    """A user's Mip-NeRF config: mip_base.py over a blender-format
    ``scene``, shrunk as the JAX package's smoke test shrinks it (256 rays,
    32 samples a level, a 4 x 64 trunk, a 32-wide colour branch, the
    schedule over 60 steps with a 10-step delay); ``extra`` keys are
    appended."""
    Path(tmp_path).mkdir(parents=True, exist_ok=True)
    path = Path(tmp_path) / "mip_cfg.py"
    lines = "".join(f"{k} = {v!r}\n" for k, v in extra.items())
    path.write_text(textwrap.dedent(f"""\
        _base_ = {MIP_BASE!r}
        exp_name = "mip_smoke"
        log_dir = {str(Path(tmp_path) / "logs")!r}
        dataset_dir = {str(scene)!r}
        dataset = dict(
            train=dict(root_dir=dataset_dir, batch_size=256),
            val=dict(root_dir=dataset_dir, batch_size=256),
            test=dict(root_dir=dataset_dir, batch_size=256),
        )
        tot_train_steps = 60
        num_samples = 32
        net_depth = 4
        net_width = 64
        net_width_condition = 32
        linearlog = dict(max_steps=60, lr_delay_steps=10)
        seed = 0
    """) + lines)
    return str(path)


def write_svox2_cfg(tmp_path, scene, **extra):
    """A user's Plenoxels config: svox2_base.py over a blender-format
    ``scene`` at reso 24 (radius 1.4, basis 9), 512 rays a step, 96
    samples a ray; ``extra`` keys are appended."""
    Path(tmp_path).mkdir(parents=True, exist_ok=True)
    path = Path(tmp_path) / "svox2_cfg.py"
    lines = "".join(f"{k} = {v!r}\n" for k, v in extra.items())
    path.write_text(textwrap.dedent(f"""\
        _base_ = {SVOX2_BASE!r}
        exp_name = "svox2_smoke"
        log_dir = {str(Path(tmp_path) / "logs")!r}
        dataset_dir = {str(scene)!r}
        dataset = dict(
            train=dict(root=dataset_dir, split='train'),
            test=dict(root=dataset_dir, split='test'),
        )
        model = dict(reso=24, radius=1.4)
        reso_list = [[24] * 3, [48] * 3]
        batch_size = 512
        n_iters = 8
        render_n_samples = 96
        seed = 0
    """) + lines)
    return str(path)


# ------------------------------------------------- the repo's measuring tools
REPO = Path(__file__).resolve().parents[1]


def jax_tool_dict_keys(rel, marker):
    """The string keys of the first dict literal (breadth first) in the
    JAX tool ``rel`` (a path from the repository's root) that has the key
    ``marker``: the keys of a line the tool prints, read from its source
    so that the tool need not run."""
    import ast

    for node in ast.walk(ast.parse((REPO / rel).read_text())):
        if isinstance(node, ast.Dict):
            keys = {k.value for k in node.keys if isinstance(k, ast.Constant)}
            if marker in keys:
                return keys
    raise AssertionError(f"no dict with {marker!r} in {rel}")


def shrink_bench_cfg(monkeypatch):
    """Make every config the tools build through
    ``bench_cfg.ngp_synthetic_cfg`` tiny (4 images of 16^2, 256 rays, a
    32^3 grid, 2^13-entry tables), so that they train on the CPU in
    seconds; the tools' own overrides (variants, compaction, hash shapes)
    still apply."""
    from jnerf_tpu_torch.utils import bench_cfg

    real = bench_cfg.ngp_synthetic_cfg

    def tiny(**kw):
        kw.update(n_images=4, H=16, W=16, n_rays_per_batch=256,
                  target_batch_size=1 << 12, grid_size=32, nerf_steps=128,
                  log2_hashmap_size=13)
        return real(**kw)

    monkeypatch.setattr(bench_cfg, "ngp_synthetic_cfg", tiny)


@pytest.fixture(autouse=True)
def two_threads():
    """Two torch threads a test (autouse where imported): the suite runs
    in several processes at once, and eight spinning threads in each slow
    every one of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tiny_cfg(monkeypatch):
    """``shrink_bench_cfg`` for one test, and the global config cleared
    after it."""
    shrink_bench_cfg(monkeypatch)
    yield
    from jnerf_tpu_torch.utils.config import get_cfg

    get_cfg().clear()


def files_under(*roots):
    """Every path under the given directories."""
    return {p for root in roots for p in Path(root).rglob("*")}

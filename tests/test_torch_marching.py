"""Mesh extraction in the port (`ops.marching`, `native`, the NGP mesh tool
`tools.extract_mesh`) against the JAX package's on the CPU."""

import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import both_cfgs, n, read_ply, t  # noqa: F401

from jnerf_tpu.ops import marching as jmarch
from jnerf_tpu_torch import native
from jnerf_tpu_torch.ops import marching as tmarch

REPO = Path(__file__).resolve().parents[1]


def _fields():
    g = np.mgrid[0:20, 0:22, 0:18].astype(np.float32)
    sphere = 7.0 - np.sqrt(((g - 9.5) ** 2).sum(axis=0))
    rand = np.random.default_rng(0).normal(size=(12, 10, 14)).astype(np.float32)
    return {"sphere": (sphere, 0.0), "random": (rand, 0.3)}


@pytest.mark.parametrize("name", ["sphere", "random"])
def test_numpy_marching_equals_jax(name):
    """The port's numpy path gives the JAX package's numpy path's vertices
    and triangles exactly, in the same order."""
    field, thr = _fields()[name]
    v, tri = tmarch.marching_tetrahedra(field, thr, use_native=False)
    jv, jtri = jmarch.marching_tetrahedra(field, thr, use_native=False)
    assert len(tri) > 100
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(tri, jtri)


@pytest.mark.parametrize("name", ["sphere", "random"])
def test_native_equals_numpy(name):
    """The C++ core (built with g++ here) and the numpy path give the same
    vertex set and the same triangles, listed in another order; a field
    without a crossing gives an empty mesh."""
    field, thr = _fields()[name]
    v, tri = tmarch.marching_tetrahedra(field, thr, use_native=True)
    pv, ptri = tmarch.marching_tetrahedra(field, thr, use_native=False)
    assert len(v) == len(pv) and len(tri) == len(ptri)
    np.testing.assert_array_equal(np.unique(np.round(v, 4), axis=0),
                                  np.unique(np.round(pv, 4), axis=0))
    rows = lambda vv, tt: np.sort(np.sort(  # noqa: E731
        np.round(vv, 4)[tt].reshape(len(tt), 9).round(4), axis=0), axis=0)
    np.testing.assert_array_equal(rows(v, tri), rows(pv, ptri))
    for const in (0.0, 1.0):
        v, tri = native.marching_tets_native(
            np.full((6, 6, 6), const, np.float32), 0.5)
        assert v.shape == (0, 3) and tri.shape == (0, 3)


def test_failed_native_build_raises(tmp_path, monkeypatch):
    """use_native=True never falls back to numpy: a source that does not
    compile raises."""
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "marching_tets.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(native, "CSRC_DIR", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    native.marching_lib.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            tmarch.marching_tetrahedra(np.zeros((4, 4, 4), np.float32), 0.5)
    finally:
        native.marching_lib.cache_clear()


def test_largest_component_and_ply_match_jax(tmp_path):
    """largest_component keeps the JAX package's vertices and triangles;
    write_ply writes the JAX package's bytes, with and without colours."""
    field = np.zeros((16, 16, 16), np.float32)
    field[2:10, 2:10, 2:10] = 1.0
    field[12:14, 12:14, 12:14] = 1.0
    v, tri = tmarch.marching_tetrahedra(field, 0.5, use_native=False)
    lv, ltri = tmarch.largest_component(v, tri)
    jv, jtri = jmarch.largest_component(v, tri)
    assert len(ltri) < len(tri) and lv[:, 0].max() < 11
    np.testing.assert_array_equal(lv, jv)
    np.testing.assert_array_equal(ltri, jtri)
    colors = np.random.default_rng(0).uniform(-0.1, 1.1, (len(lv), 3))
    for c in (None, colors):
        a = tmarch.write_ply(str(tmp_path / "a.ply"), lv, ltri, c)
        b = jmarch.write_ply(str(tmp_path / "b.ply"), lv, ltri, c)
        assert Path(a).read_bytes() == Path(b).read_bytes()


def test_extract_geometry_matches_jax():
    """The field evaluated over a box on the CPU device (points built from
    numpy's f32 linspace in both, the query taking tensors) and the mesh
    from it: the same field values and the same mesh."""
    bmin, bmax = [-0.6, -0.5, -0.7], [0.6, 0.7, 0.5]

    def jq(p):
        return 0.4 - jnp.linalg.norm(p, axis=-1)

    def tq(p):
        assert isinstance(p, torch.Tensor) and p.device.type == "cpu"
        return 0.4 - torch.linalg.norm(p, dim=-1)

    u = tmarch.extract_fields(bmin, bmax, 30, tq, device="cpu")
    ju = jmarch.extract_fields(bmin, bmax, 30, jq)
    np.testing.assert_allclose(u, ju, rtol=0, atol=1e-7)
    v, tri = tmarch.extract_geometry(bmin, bmax, 30, 0.0, tq, device="cpu",
                                     use_native=False)
    r = np.linalg.norm(v, axis=-1)
    assert len(tri) > 100 and abs(r.mean() - 0.4) < 0.02


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_extract_mesh", REPO / "tools" / "extract_mesh.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_ngp_mesh_tool_matches_jax(both_cfgs, tmp_path, monkeypatch):
    """A tiny NGP field trained 64 steps by the port and saved; the port's
    mesh tool (``mesh(["--resolution", "48", "--device", "cpu"])``) and
    tools/extract_mesh.py each load the checkpoint and write
    mesh-origin.ply and mesh-color.ply, the port's colours rendered with
    the JAX tool's jitter.  sigma is the raw density truncated to an
    integer, which the two packages' bf16 density chains reach on the same
    side here: the same vertices within 1e-6 and the same triangles, in
    the same order.  The colours come out of the render's f32 compositing
    of bf16 network outputs: each within one 8-bit level, and 99% equal.

    Both tools march on their numpy paths, which list the triangles in one
    order.  The JAX package builds its g++ core in place on first use and
    falls back to numpy when that build is missing or unreadable (several
    test processes share the checkout); its triangles then come in another
    order than the port's core lists them, the vertex normals sum in
    another order and differ in the last bits, and a colour ray that
    grazes the surface takes other samples (tens of 8-bit levels)."""
    import functools

    from jnerf_tpu_torch.runner import Runner
    from jnerf_tpu_torch.tools import extract_mesh

    monkeypatch.setattr("jnerf_tpu.native.available", lambda: False)
    monkeypatch.setattr(extract_mesh, "marching_tetrahedra", functools.partial(
        tmarch.marching_tetrahedra, use_native=False))

    jcfg, tcfg = both_cfgs
    tr = Runner(device="cpu")
    tr.train_range(0, 64)
    ckpt = str(tmp_path / "params.pkl")
    tr.save_ckpt(ckpt)
    jcfg.update(ckpt_path=ckpt, log_dir=str(tmp_path / "jax_logs"))
    tcfg.update(ckpt_path=ckpt, log_dir=str(tmp_path / "port_logs"))

    tool = _jax_tool()
    monkeypatch.setattr(sys, "argv", ["extract_mesh.py", "--resolution", "48"])
    monkeypatch.setattr("jnerf_tpu.utils.config.init_cfg", lambda path: None)
    tool.mesh()
    u = t(jax.random.uniform(jax.random.PRNGKey(0), (Runner.render_chunk_rays,)))
    orig = extract_mesh.extract_mesh
    monkeypatch.setattr(extract_mesh, "extract_mesh",
                        lambda runner, res: orig(runner, res, u=u))
    paths = extract_mesh.mesh(["--resolution", "48", "--device", "cpu"])
    name = tr.exp_name
    for path, ply in zip(paths, ("mesh-origin.ply", "mesh-color.ply")):
        assert path == str(tmp_path / "port_logs" / name / ply)
        got, gtri = read_ply(path)
        want, wtri = read_ply(tmp_path / "jax_logs" / name / ply)
        assert len(want) > 200 and len(got) == len(want)
        np.testing.assert_array_equal(gtri, wtri)
        np.testing.assert_allclose(got["xyz"], want["xyz"], rtol=0, atol=1e-6)
        if "rgb" in got.dtype.names:
            diff = np.abs(got["rgb"].astype(int) - want["rgb"].astype(int))
            assert diff.max() <= 1 and np.mean(diff.max(axis=1) == 0) >= 0.99

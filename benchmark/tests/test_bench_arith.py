"""The benchmark's arithmetic: the device's busy union, the tail of the
render latencies, the FLOP counts of each configuration's layers, the
scene's occupancy and the render check's numbers."""

import statistics

import numpy as np
import pytest
import torch

from benchmark import cells, check, reference, run, scene, trace


def test_union_counts_overlapping_intervals_once():
    # [0, 10) and [5, 15) overlap; [20, 30) is apart; [25, 26) lies inside.
    ivs = [(5, 15), (0, 10), (20, 30), (25, 26)]
    assert trace.union_s(ivs, 0, 100) == pytest.approx(25e-6)
    # Clipped to the window [8, 22): [8, 15) and [20, 22).
    assert trace.union_s(ivs, 8, 22) == pytest.approx(9e-6)
    assert trace.gaps(ivs, 0, 40) == [(15, 20), (30, 40)]


def test_trace_busy_and_names():
    tr = trace.Trace([("a", 0, 10), ("b", 5, 15), ("a", 30, 40)],
                     [("host_step", 0, 50), ("sync", 16, 29)], (0, 50))
    assert tr.busy_s == pytest.approx(25e-6)
    assert tr.window_s == pytest.approx(50e-6)
    assert tr.op_seconds(lambda n: n == "a") == pytest.approx(20e-6)
    bd = tr.breakdown()
    assert bd["device_ops"][0] == ["a", pytest.approx(20e-6)]
    # The gap [15, 30) starts inside "host_step" only; [40, 50) too.
    assert dict(map(tuple, bd["idle_gaps"])) == {
        "host_step": pytest.approx(25e-6)}


def test_p95_is_over_all_views():
    lat = [float(i) for i in range(1, 201)]
    assert run.p95(lat) == statistics.quantiles(lat, n=20)[18]
    assert 190 < run.p95(lat) < 191
    # One slow view among 200 moves the 95th percentile by nothing.
    assert run.p95(lat[:-1] + [1e6]) == run.p95(lat)


def _field(name):
    c = cells._json(cells.HERE / "configs" / f"{name}.json")
    mod = cells._module(cells.HERE / "configs" / f"{name}.py", "f_" + name)
    return mod.build(c["cfg"], 1.0)


def test_ngp_flops_from_layer_shapes():
    f = _field("ngp_base")
    # density 32x64, 64x16; colour 32x64, 64x64, 64x3.
    fwd = 2 * (32 * 64 + 64 * 16 + 32 * 64 + 64 * 64 + 64 * 3)
    assert f.mlp_flops() == fwd == 18816
    # Weights' and inputs' gradients, less the view directions' 16 inputs.
    assert f.train_flops() == 3 * fwd - 2 * 16 * 64 == 54400


def test_hash_geometry_is_the_configurations():
    f = _field("ngp_base")
    sizes = [size for _, size, _, _ in f.grid.levels]
    assert len(sizes) == 16 and max(sizes) == 1 << 19
    assert f.grid.n_entries == sum(sizes)
    assert f.leaves[0] == ("pos_encoder.grid", (f.grid.n_entries, 2), 1e-4)
    # The rendered field differs from the initial one in the table alone.
    assert f.render_leaves[0] == ("pos_encoder.grid", (f.grid.n_entries, 2),
                                  16.0)
    assert f.render_leaves[1:] == f.leaves[1:]


def test_solid_bitfield_holds_the_scene():
    geom = reference.Geom(grid=32)
    centers, radii = scene.solids({"kind": "hard"})
    bits = reference.solid_bitfield(geom, centers, radii, "cpu")
    assert bits.shape == (5, 32, 32, 32) and not bits[2:].any()
    # Every sphere's centre lies in an occupied cell of the marched cascade.
    pts = reference.ngp_points(torch.as_tensor(centers)).float()
    assert reference.occupied(bits, *pts.T, geom).all()
    # The corners of the cube and a point off every solid are empty.
    far = torch.tensor([[0.02, 0.02, 0.02], [0.98, 0.98, 0.98]])
    assert not reference.occupied(bits, *far.T, geom).any()
    # About the solids' volume: the large sphere alone holds 2% of the cube.
    share = bits[0].float().mean().item()
    assert 0.02 < share < 0.15, share
    assert bits[1].sum() == bits[0].reshape(16, 2, 16, 2, 16, 2).any(
        5).any(3).any(1).sum()


def test_render_numbers_count_pixels_off():
    ref = np.zeros((8, 8, 3))
    prog = ref.copy()
    prog[0, :3, 1] = 0.2        # three pixels off in one channel
    prog[1, 0, :] = 0.05        # one pixel near, not off
    n = check.render_numbers([prog, ref], [ref, ref])
    assert n["pixels_off"] == 3
    assert n["pixel_gap"] == pytest.approx(0.2)
    assert n["view_rmse"] == pytest.approx(np.sqrt((3 * 0.04 + 3 * 0.0025)
                                                   / 192))

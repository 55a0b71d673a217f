"""Kernel V's plain version (`ops/voxel_grid.py::corner_grad_plain`, the
Plenoxels corner gather's table gradient summed in a fixed order) and
pixelNeRF's fixed-order resize backward, on the CPU.

- The plain version against the JAX package's VJP of `trilinear_sample`
  and `trilinear_sample_sparse`, at the tolerance `test_torch_svox2.py`
  states for the corner gather's gradients (atol 1e-5 of the largest
  entry: the same w * g summed into the same cells in another order).
- The plain version against the corner gather's earlier backward (one
  ``index_add_`` of every item of nonzero weight), bit for bit: on the CPU
  both add a row's items in item order from +0.0, and the items the plain
  version also leaves out (a sample whose gradient is 0 in every table)
  add only signed zeros.
- Its sort's plain version against numpy's stable argsort, on the item
  path and on the dense grid's sample path (live samples sorted by base
  row); its compaction's plain version against numpy's nonzero; the
  sample path's runs, merged as the kernel merges them and summed in that
  order, against the plain version bit for bit.
- pixelNeRF's `resize_bilinear` backward against ``jax.image.resize``'s
  VJP (atol 1e-5 of the largest entry: both are the same linear map,
  summed in other orders), and its forward equal to ``F.interpolate``.
- chip_smoke.py's bound of kernel V, by hand.
"""

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import chip_smoke
from torch_parity import j, n, t

from jnerf_tpu.ops import voxel_grid as jv
from jnerf_tpu_torch.ops import voxel_grid as tv

RESO = (6, 5, 7)
BASIS = 9  # svox2_base.py's: SH width 27


def _case(seed, n_samples=400, sparse=False, dead=0.25):
    """A grid, positions running past every border, cotangents with a
    ``dead`` share of samples at 0 in both tables; sparse: links of a
    random half mask."""
    rng = np.random.default_rng(seed)
    density = rng.uniform(0, 2, RESO).astype(np.float32)
    sh = rng.normal(size=RESO + (3 * BASIS,)).astype(np.float32)
    pos = rng.uniform(-0.7, np.array(RESO) - 0.3,
                      (n_samples, 3)).astype(np.float32)
    gs = rng.normal(size=(n_samples,)).astype(np.float32)
    gc = rng.normal(size=(n_samples, 3 * BASIS)).astype(np.float32)
    off = rng.uniform(size=n_samples) < dead
    gs[off], gc[off] = 0.0, 0.0
    gc[rng.uniform(size=n_samples) < 0.1] = 0.0  # density's alone
    case = dict(density=density, sh=sh, pos=pos, gs=gs, gc=gc)
    if sparse:
        mask = rng.uniform(size=RESO) < 0.5
        links, dd, sd, _ = jv.build_sparse(density, sh, mask)
        case.update(links=np.asarray(links), dd=np.asarray(dd),
                    sd=np.asarray(sd))
    return case


def _port_grads(case, sparse):
    spec = tv.VoxelGridSpec(RESO, BASIS)
    if sparse:
        a = t(case["dd"]).requires_grad_()
        b = t(case["sd"]).requires_grad_()
        sig, shc = tv.trilinear_sample_sparse(spec, t(case["links"]), a, b,
                                              t(case["pos"]))
    else:
        a = t(case["density"]).requires_grad_()
        b = t(case["sh"]).requires_grad_()
        sig, shc = tv.trilinear_sample(spec, a, b, t(case["pos"]))
    torch.autograd.backward([sig, shc], [t(case["gs"]), t(case["gc"])])
    return n(a.grad), n(b.grad)


def _assert_grad(got, ref, name):
    scale = float(np.abs(ref).max())
    assert scale > 0, name
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * scale,
                               err_msg=name)


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_plain_version_matches_the_jax_vjp(sparse, seed):
    """The tables' gradients through the port's corner gather (kernel V's
    plain version on the CPU) against jax.vjp of the JAX sample function
    with the same cotangents."""
    case = _case(seed, sparse=sparse)
    spec = jv.VoxelGridSpec(RESO, BASIS)
    if sparse:
        links = j(case["links"])
        fn = lambda x, y: jv.trilinear_sample_sparse(  # noqa: E731
            spec, links, x, y, j(case["pos"]))
        args = (j(case["dd"]), j(case["sd"]))
    else:
        fn = lambda x, y: jv.trilinear_sample(  # noqa: E731
            spec, x, y, j(case["pos"]))
        args = (j(case["density"]), j(case["sh"]))
    _, vjp = jax.vjp(fn, *args)
    ga, gb = vjp((j(case["gs"]), j(case["gc"])))
    got_a, got_b = _port_grads(case, sparse)
    _assert_grad(got_a, n(ga), "density")
    _assert_grad(got_b, n(gb), "sh")


def _index_add_path(idx, w, grads, n_rows):
    """The corner gather's backward before kernel V: every item of nonzero
    weight (sample-major, corner-minor) added with one index_add_."""
    live = torch.nonzero(w.reshape(-1)).squeeze(1)
    rows, w_live = idx.reshape(-1)[live], w.reshape(-1)[live, None]
    sample = live // idx.shape[1]
    return [g.new_zeros((n_rows, g.shape[1])).index_add_(
        0, rows, w_live * g[sample]) for g in grads]


def _items(case, sparse):
    """Kernel V's inputs for a case: (idx, w, [g_density, g_sh], n_rows),
    as the corner gather hands them over."""
    spec = tv.VoxelGridSpec(RESO, BASIS)
    idx, w = tv.corners(spec, t(case["pos"]))
    n_rows = spec.n_cells
    if sparse:
        lk = t(case["links"]).reshape(-1)[idx]
        w = torch.where(lk >= 0, w, torch.zeros_like(w))
        idx = torch.clamp(lk, min=0).to(torch.int64)
        n_rows = case["dd"].shape[0]
    return idx, w, [t(case["gs"])[:, None], t(case["gc"])], n_rows


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("seed,dead", [(0, 0.0), (1, 0.25), (2, 0.9)])
def test_plain_version_is_the_index_add_path_bit_for_bit(sparse, seed, dead):
    """On the CPU the plain version gives the earlier index_add_ path's
    bits: same order, and the samples it also leaves out add only +-0."""
    idx, w, grads, n_rows = _items(_case(seed, sparse=sparse, dead=dead),
                                   sparse)
    got = tv.corner_grad_plain(idx, w, grads, n_rows)
    want = _index_add_path(idx, w, grads, n_rows)
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_plain_version_leaves_out_zero_items():
    """Items of weight 0, of a sample whose g is 0 in every table, or of a
    row outside the table add nothing; the rest are summed from +0.0 in
    item order (a row of -0.0 contributions stays +0.0)."""
    idx = torch.tensor([[0, 1], [1, 2], [2, 7], [0, -1]])
    w = torch.tensor([[0.5, 0.0], [1.0, 2.0], [1.0, 1.0], [1.0, 1.0]])
    gd = torch.tensor([[2.0], [0.0], [0.0], [-0.0]])
    gs = torch.tensor([[1.0, -1.0], [3.0, -0.0], [0.0, 0.0], [-0.0, 0.0]])
    d, s = tv.corner_grad_plain(idx, w, [gd, gs], 3)
    assert d.tolist() == [[1.0], [0.0], [0.0]]
    assert s.tolist() == [[0.5, -0.5], [3.0, 0.0], [6.0, 0.0]]
    assert not torch.signbit(d[d == 0]).any()
    assert not torch.signbit(s[s == 0]).any()
    start, order = tv.corner_grad_plan_plain(idx, w, [gd, gs], 3)
    assert start.tolist() == [0, 1, 2, 3]
    assert order.tolist() == [0, 2, 3]


@pytest.mark.parametrize("sparse", [False, True])
def test_plan_is_a_stable_sort_by_row(sparse):
    """The plain plan: the kept items in a stable sort by row, and each
    row's first position."""
    idx, w, grads, n_rows = _items(_case(3, sparse=sparse), sparse)
    start, order = tv.corner_grad_plan_plain(idx, w, grads, n_rows)
    keep = n(tv._live_items(idx, w, grads, n_rows))
    rows = n(idx).reshape(-1)
    want = np.argsort(np.where(keep, rows, n_rows), kind="stable")
    want = want[:keep.sum()]
    np.testing.assert_array_equal(n(order), want)
    counts = np.bincount(rows[keep], minlength=n_rows)
    np.testing.assert_array_equal(n(start), np.concatenate(
        [[0], np.cumsum(counts)]))


def test_wrapper_takes_the_plain_version_on_the_cpu():
    """corner_grad on CPU tensors is the plain version, uncounted."""
    idx, w, grads, n_rows = _items(_case(4), False)
    before = tv.corner_grad.launches
    for a, b in zip(tv.corner_grad(idx, w, grads, n_rows),
                    tv.corner_grad_plain(idx, w, grads, n_rows)):
        assert torch.equal(a, b)
    assert tv.corner_grad.launches == before


@pytest.mark.parametrize("reso", [RESO, (2, 3, 4), (9, 9, 2)])
def test_corner_offsets_give_every_corner_row(reso):
    """corners() gives corner c of every position (those past the borders
    too) as row idx[:, 0] + corner_offsets[c]."""
    spec = tv.VoxelGridSpec(reso, BASIS)
    rng = np.random.default_rng(5)
    pos = t(rng.uniform(-1.5, np.array(reso) + 0.5, (300, 3))
            .astype(np.float32))
    idx, _ = tv.corners(spec, pos)
    offs = tv.corner_offsets(spec)
    assert offs[0] == 0
    assert torch.equal(idx, idx[:, :1] + torch.tensor(offs))


def _np_live(case):
    return (case["gs"] != 0) | (case["gc"] != 0).any(axis=1)


@pytest.mark.parametrize("sparse", [False, True])
def test_compaction_keeps_entries_in_entry_order(sparse):
    """The compaction's plain version: on the item path the kept items in
    item order keyed by row; on the sample path the live samples whose
    base row is on the grid, in sample order, keyed by base row."""
    case = _case(6, sparse=sparse)
    idx, w, grads, n_rows = _items(case, sparse)
    keys, pay = tv.corner_grad_entries_plain(idx, w, grads, n_rows)
    rows, live = n(idx), _np_live(case)
    keep = (n(w) != 0) & live[:, None] & (rows >= 0) & (rows < n_rows)
    want = np.flatnonzero(keep.reshape(-1))
    np.testing.assert_array_equal(n(pay), want)
    np.testing.assert_array_equal(n(keys), rows.reshape(-1)[want])
    if not sparse:
        spec = tv.VoxelGridSpec(RESO, BASIS)
        keys, pay = tv.corner_grad_entries_plain(
            idx[:, 0], w, grads, n_rows, tv.corner_offsets(spec))
        want = np.flatnonzero(live & (rows[:, 0] < n_rows))
        np.testing.assert_array_equal(n(pay), want)
        np.testing.assert_array_equal(n(keys), rows[want, 0])


@pytest.mark.parametrize("seed,dead", [(7, 0.25), (8, 1.0)])
def test_sample_plan_is_a_stable_sort_by_base_row(seed, dead):
    """The sample path's plain plan: the live samples in a stable sort by
    base row, and each base row's first position."""
    case = _case(seed, dead=dead)
    idx, w, grads, n_rows = _items(case, False)
    offs = tv.corner_offsets(tv.VoxelGridSpec(RESO, BASIS))
    start, order = tv.corner_grad_plan_plain(idx[:, 0], w, grads, n_rows,
                                             offs)
    base = n(idx)[:, 0]
    live = np.flatnonzero(_np_live(case))
    want = live[np.argsort(base[live], kind="stable")]
    np.testing.assert_array_equal(n(order), want)
    np.testing.assert_array_equal(n(start), np.concatenate(
        [[0], np.cumsum(np.bincount(base[live], minlength=n_rows))]))


def test_sample_runs_merge_into_item_order():
    """Kernel V's sample path on the CPU: row r's items are the runs of
    base rows r - off[c] of the sample plan, merged by (sample, corner)
    with weight-0 items skipped; that is the item plan's order for row r,
    and summing each channel from +0.0 in it (an f32 product, then an f32
    add) gives the plain version's bits."""
    case = _case(9)
    idx, w, grads, n_rows = _items(case, False)
    offs = tv.corner_offsets(tv.VoxelGridSpec(RESO, BASIS))
    start, order = (n(x) for x in tv.corner_grad_plan_plain(
        idx[:, 0], w, grads, n_rows, offs))
    i_start, i_order = (n(x) for x in tv.corner_grad_plan_plain(
        idx, w, grads, n_rows))
    wn, K = n(w), idx.shape[1]
    g = np.concatenate([n(x) for x in grads], axis=1)
    out = np.zeros((n_rows, g.shape[1]), np.float32)
    for r in range(n_rows):
        runs = []
        for c, o in enumerate(offs):
            b = r - o
            if 0 <= b < n_rows:
                runs.append([(int(s), c) for s in order[start[b]:
                                                         start[b + 1]]])
            else:
                runs.append([])
        merged = [None] * sum(map(len, runs))
        at = 0
        for c, run in enumerate(runs):
            for j, (s, _) in enumerate(run):
                rank = j + sum(sum(1 for s2, _ in runs[c2]
                                   if s2 < s or (s2 == s and c2 < c))
                               for c2 in range(len(runs)) if c2 != c)
                merged[rank] = (s, c)
            at += len(run)
        items = [s * K + c for s, c in merged if wn[s, c] != 0]
        np.testing.assert_array_equal(items, i_order[i_start[r]:
                                                     i_start[r + 1]])
        acc = np.zeros(g.shape[1], np.float32)
        for s, c in merged:
            if wn[s, c] != 0:
                acc = (acc + np.float32(wn[s, c]) * g[s]).astype(np.float32)
        out[r] = acc
    want = torch.cat(tv.corner_grad_plain(idx, w, grads, n_rows), 1)
    np.testing.assert_array_equal(out.view(np.int32), n(want).view(np.int32))


def test_wrapper_with_offsets_takes_the_plain_version_on_the_cpu():
    """corner_grad with the dense grid's offsets on CPU tensors is the
    plain version, uncounted; so is the dense corner gather's backward."""
    case = _case(10)
    idx, w, grads, n_rows = _items(case, False)
    offs = tv.corner_offsets(tv.VoxelGridSpec(RESO, BASIS))
    before = tv.corner_grad.launches
    for a, b in zip(tv.corner_grad(idx[:, 0], w, grads, n_rows, offs),
                    tv.corner_grad_plain(idx, w, grads, n_rows)):
        assert torch.equal(a, b)
    got = _port_grads(case, False)
    want = tv.corner_grad_plain(idx, w, grads, n_rows)
    np.testing.assert_array_equal(got[0].reshape(-1), n(want[0])[:, 0])
    np.testing.assert_array_equal(got[1].reshape(n_rows, -1), n(want[1]))
    assert tv.corner_grad.launches == before


def test_corner_rows_of_base_rows():
    """The sample path's corner rows: the base rows plus each offset
    (corners()'s rows from its corner 0), every row -1 for a sample whose
    base row lies off the grid; the item path's idx as it is."""
    idx, _, _, n_rows = _items(_case(11), False)
    offs = tv.corner_offsets(tv.VoxelGridSpec(RESO, BASIS))
    assert torch.equal(tv.corner_rows(idx[:, 0], n_rows, offs), idx)
    assert tv.corner_rows(idx, n_rows) is idx
    base = torch.tensor([-3, -1, 0, n_rows - 1, n_rows, n_rows + 9])
    rows = n(tv.corner_rows(base, n_rows, offs))
    np.testing.assert_array_equal(rows[[0, 1, 4, 5]], -1)
    np.testing.assert_array_equal(rows[[2, 3]],
                                  n(base)[[2, 3], None] + np.array(offs))


@pytest.mark.parametrize("src,dst", [(50, 50), (25, 50), (13, 50), (7, 50),
                                     (3, 11)])
def test_resize_backward_matches_the_jax_vjp(src, dst):
    """pixelNeRF's upsample: forward equal to F.interpolate bit for bit,
    backward against the VJP of jax.image.resize (NHWC, "bilinear")."""
    from jnerf_tpu_torch.models.networks.pixelnerf import resize_bilinear

    rng = np.random.default_rng(src)
    x = rng.normal(size=(2, 5, src, src + 1)).astype(np.float32)
    g = rng.normal(size=(2, 5, dst, dst + 2)).astype(np.float32)
    xt = t(x).requires_grad_()
    y = resize_bilinear(xt, (dst, dst + 2))
    assert torch.equal(y, F.interpolate(t(x), size=(dst, dst + 2),
                                        mode="bilinear", align_corners=False))
    y.backward(t(g))
    nhwc = np.transpose(x, (0, 2, 3, 1))
    _, vjp = jax.vjp(lambda a: jax.image.resize(
        a, (2, dst, dst + 2, 5), "bilinear"), j(nhwc))
    (gj,) = vjp(j(np.transpose(g, (0, 2, 3, 1))))
    _assert_grad(n(xt.grad), np.transpose(n(gj), (0, 3, 1, 2)), "dx")


def test_resize_backward_is_the_interpolation_adjoint():
    """The backward equals torch's own F.interpolate backward up to
    summation order (f64 reference)."""
    from jnerf_tpu_torch.models.networks.pixelnerf import resize_bilinear

    x = torch.randn((1, 3, 13, 9), dtype=torch.float64, requires_grad=True)
    g = torch.randn((1, 3, 50, 36), dtype=torch.float64)
    (ref,) = torch.autograd.grad(F.interpolate(
        x, size=(50, 36), mode="bilinear", align_corners=False), x, g)
    xf = x.detach().float().requires_grad_()
    resize_bilinear(xf, (50, 36)).backward(g.float())
    np.testing.assert_allclose(n(xf.grad), n(ref), rtol=0,
                               atol=1e-5 * float(ref.abs().max()))


def test_kernel_v_bound_by_hand():
    """chip_smoke.py's bound of kernel V on phase 14's dense shape: 5000
    rays x 887 samples, 2.1M of them live, the 28 f32 channels of g read
    for every sample, the whole [256^3, 28] gradient written; idx and w
    read for the live samples alone: on the item path each live sample's 8
    f32 weights and the int64 rows of its 16.95M items of weight not 0, on
    the sample path each live sample's int64 base row and the 8 weights of
    the 2.09M on the grid; a multiply and an add a kept item and
    channel."""
    n_s, rows, kept, live = 5000 * 887, 256 ** 3, 16_900_000, 2_100_000
    for samples, read, idx_w in (
            (False, 16_950_000, 4 * 8 * live + 8 * 16_950_000),
            (True, 2_090_000, 8 * live + 4 * 8 * 2_090_000)):
        w = chip_smoke.voxel_work(n_s, 8, rows, 28, kept, live, read,
                                  samples)
        assert w["bytes"] == 4 * 28 * n_s + 4 * 28 * rows + idx_w
        assert w["flops"] == 2 * 28 * kept
        assert w["bound_by"] == "bytes"
        assert w["bound_ms"] == pytest.approx(w["bytes"] / 3.35e12 * 1e3)


def test_voxel_time_refuses_without_a_card():
    """The kernel V timing tool needs the card: on the CPU it refuses."""
    from jnerf_tpu_torch.tools import voxel_time

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit, match="NVIDIA GPU"):
        voxel_time.main(["--inputs", "unused.pt"])

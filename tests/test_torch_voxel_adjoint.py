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
- Its sort's plain version against numpy's stable argsort.
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
    rays x 887 samples x 8 corners of int64 index and f32 weight, the 28
    f32 channels of g a sample, the whole [256^3, 28] gradient; a multiply
    and an add a kept item and channel."""
    n_s, rows, kept = 5000 * 887, 256 ** 3, 30_000_000
    w = chip_smoke.voxel_work(n_s, 8, rows, 28, kept)
    assert w["bytes"] == 8 * 8 * n_s + 4 * 8 * n_s + 4 * 28 * n_s \
        + 4 * 28 * rows
    assert w["flops"] == 2 * 28 * kept
    assert w["bound_by"] == "bytes"
    assert w["bound_ms"] == pytest.approx(w["bytes"] / 3.35e12 * 1e3)

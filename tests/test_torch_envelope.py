"""The envelope kernels' twins (`jnerf_tpu_torch/ops/envelope.py`) against
the archived TPU probes' own Pallas kernels, and the ported probes
(`jnerf_tpu_torch/tools/archive/`) on the CPU.

Each archived kernel body is loaded from its file by ``ast`` (the file is
neither edited nor run: `torch_parity.archived_kernels`) with its free
names bound at small sizes and run in Pallas interpret mode on the CPU.
Its inputs, made with numpy from a seed, go through the port's wrapper,
which on CPU tensors runs the kernel's plain twin.  Gathers must agree bit
for bit (a copy, or one rounding a product).  Scatters sum in f32 in
another order, so they are held within 1e-6 of the largest entry.  The
packed hash scatter is held within 1e-4 of it (``K4_RTOL``, see there).  The probes run with ``--cpu`` at tiny
sizes (module constants patched); their byte counts are checked by hand.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from jnerf_tpu.ops import hash_nbr as jax_hash_nbr
from jnerf_tpu.ops.hash_grid import HashGridSpec as JaxSpec
from jnerf_tpu_torch.ops import envelope as E
from jnerf_tpu_torch.ops.hash_grid import HashGridSpec
from jnerf_tpu_torch.tools.archive import common
from torch_parity import archived_kernels, t

ARCHIVE = "tools/archive"
SCATTER_RTOL = 1e-6  # of the largest entry: f32 sums in another order
# K4's contributions: XLA on the CPU fuses ``p * scale + 0.5`` in
# vals_phase into one fused multiply-add, where the TPU, kernel B and K4
# round the product first (`csrc/hash_encode.cu`'s note), so a fraction
# can move by an ulp of q (2^-13 at scale 2047) and a contribution by as
# much relative to it; the sums at 4 levels x 1024 samples stood 6.3e-6
# of the largest entry apart.  A wrong lane, slot, row or factor is off
# by the size of a contribution.
K4_RTOL = 1e-4


def _calls(calls):
    jax.effects_barrier()
    assert calls, "the archived kernel ran no pallas_call"
    return calls[0]


def _idx(n, hi, seed=0, shape=None):
    a = np.random.default_rng(seed).integers(0, hi, n).astype(np.int32)
    return a if shape is None else a.reshape(shape)


def _randn(*shape, seed=1):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _scatter_close(got, want, rtol=SCATTER_RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rtol * np.abs(want).max()


# ------------------------------------------------------------ K3 scatters
@pytest.mark.parametrize("mode", ["plain", "slab", "unroll16", "wide"])
def test_probe_rmw_make_kernel(mode):
    """probe_rmw.py:74 (make_kernel :32), run by its own ``run`` on the
    archive's ray-coherent rows: K3's twin, on the same rows (the port's
    stream is the archive's)."""
    ns, calls = archived_kernels(f"{ARCHIVE}/probe_rmw.py",
                                 ["make_kernel", "run"], N=2048, BLK=256,
                                 ROWS=64)
    ns["run"](mode)
    (rows2, vals), out = _calls(calls)
    rows = rows2.reshape(-1)
    np.testing.assert_array_equal(rows, common.clustered_rows(2048, 64))
    _scatter_close(E.row_scatter_add(t(rows), t(vals), 64), out)


def test_probe_scatter_mk_scatter():
    """probe_scatter.py:72 (mk_scatter :56) at 1024 rows into 64."""
    ns, calls = archived_kernels(f"{ARCHIVE}/probe_scatter.py", ["mk_scatter"])
    idx, vals = _idx(1024, 64, shape=(1, 1024)), _randn(1024, 128)
    out = np.asarray(ns["mk_scatter"](64, 256, 8)(jnp.asarray(idx),
                                                  jnp.asarray(vals)))
    _scatter_close(E.row_scatter_add(t(idx[0]), t(vals), 64), out)


@pytest.mark.parametrize("K", [2, 4])
def test_probe_scatter2_mk_scatter_k(K):
    """probe_scatter2.py:55 (mk_scatter_k :31): K interleaved
    accumulators summed at the end compute one scatter-add."""
    ns, _ = archived_kernels(f"{ARCHIVE}/probe_scatter2.py", ["mk_scatter_k"])
    idx, vals = _idx(1024, 64, shape=(1, 1024)), _randn(1024, 128)
    out = ns["mk_scatter_k"](64, 256, K)(jnp.asarray(idx), jnp.asarray(vals))
    _scatter_close(E.row_scatter_add(t(idx[0]), t(vals), 64), out)


@pytest.mark.parametrize("unroll", [1, 8])
def test_probe_loop_mk_scatter(unroll):
    """probe_loop.py:100 (mk_scatter :85)."""
    ns, _ = archived_kernels(f"{ARCHIVE}/probe_loop.py", ["mk_scatter"],
                             T=64, N=1024, BLK=256)
    idx, vals = _idx(1024, 64, shape=(1, 1024)), _randn(1024, 128)
    out = ns["mk_scatter"](unroll)(jnp.asarray(idx), jnp.asarray(vals))
    _scatter_close(E.row_scatter_add(t(idx[0]), t(vals), 64), out)


def test_probe_final_sec_pallas_scatter():
    """probe_final.py:77 (sec_pallas_scatter's k_fn :63 and scat)."""
    ns, _ = archived_kernels(f"{ARCHIVE}/probe_final.py", ["k_fn", "scat"],
                             NL=1024, TL=64, BLK=256, unroll=8)
    idx, vals = _idx(1024, 64, shape=(1, 1024)), _randn(1024, 128)
    out = ns["scat"](jnp.asarray(idx), jnp.asarray(vals))
    _scatter_close(E.row_scatter_add(t(idx[0]), t(vals), 64), out)


def test_probe_round2_k_scat():
    """probe_round2.py:212 (k_scat :198)."""
    vals = _randn(1024, 128)
    ns, _ = archived_kernels(f"{ARCHIVE}/probe_round2.py", ["k_scat", "scat"],
                             T=64, N=1024, BLK=256, vals=jnp.asarray(vals))
    idx = _idx(1024, 64, shape=(1, 1024))
    out = ns["scat"](jnp.asarray(idx))
    _scatter_close(E.row_scatter_add(t(idx[0]), t(vals), 64), out)


# ------------------------------------------------------------- K1 gathers
@pytest.mark.parametrize("unroll", [1, 4, 8, 16])
def test_probe_loop_mk_gather(unroll):
    """probe_loop.py:52 (mk_gather :41): K1's twin, bit for bit."""
    tbl = _randn(64, 128)
    ns, _ = archived_kernels(f"{ARCHIVE}/probe_loop.py", ["mk_gather"],
                             T=64, N=1024, BLK=256, tbl=jnp.asarray(tbl))
    idx = _idx(1024, 64, shape=(1, 1024))
    out = np.asarray(ns["mk_gather"](unroll)(jnp.asarray(idx)))
    np.testing.assert_array_equal(E.row_gather(t(tbl), t(idx[0])).numpy(), out)


def test_probe_round2_k_loop_and_k_fused():
    """probe_round2.py:138 (k_loop :130) and :177 (k_fused :167, the rows
    times w): K1 without and with w, bit for bit."""
    tbl, w = _randn(64, 128), _randn(1024, 128, seed=2)
    ns, _ = archived_kernels(
        f"{ARCHIVE}/probe_round2.py", ["k_loop", "gather_loop", "k_fused",
                                       "fused"],
        T=64, N=1024, BLK=256, tbl=jnp.asarray(tbl), w=jnp.asarray(w))
    idx = _idx(1024, 64, shape=(1, 1024))
    got = E.row_gather(t(tbl), t(idx[0]))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(ns["gather_loop"](jnp.asarray(idx))))
    got = E.row_gather(t(tbl), t(idx[0]), t(w))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(ns["fused"](jnp.asarray(idx))))


def _probe_kernel(rel, runner, kernel, out_shape, args):
    names = [runner, kernel]
    ns, calls = archived_kernels(rel, names)
    specs = [pl.BlockSpec(memory_space=pltpu.VMEM) for _ in args]
    jargs = tuple(jnp.asarray(a) for a in args)
    shape = jax.ShapeDtypeStruct(out_shape, jnp.float32)
    if runner == "probe_kernel":
        ns[runner]("test", ns[kernel], shape, specs, jargs)
    else:
        ns[runner]("test", ns[kernel], shape, jargs)
    return _calls(calls)[1]


@pytest.mark.parametrize("kernel", ["k_flat", "k_rows", "k_lane", "k_onehot"])
def test_probe_tpu_probe_kernel(kernel):
    """probe_tpu.py:72 (probe_kernel :70) over its four bodies: k_flat as
    K2 flat, k_rows as K1 lane sums broadcast to [8, B], k_lane as K2 on
    axis 1, k_onehot (a one-hot matmul of a 128-row table, indices up to
    256: past the table a zero row) as K1.  Gathers bit for bit; the lane
    sums within 1e-6 of the largest (XLA sums in its own order)."""
    B, rel = 256, f"{ARCHIVE}/probe_tpu.py"
    tbl = _randn(32, 128)
    if kernel == "k_flat":
        idx = _idx(8 * B, 32 * 128, shape=(8, B))
        out = _probe_kernel(rel, "probe_kernel", kernel, (8, B), (idx, tbl))
        np.testing.assert_array_equal(
            E.elem_gather(t(tbl), t(idx), "flat").numpy(), out)
    elif kernel == "k_rows":
        idx = _idx(8 * B, 32, shape=(8, B))
        out = _probe_kernel(rel, "probe_kernel", kernel, (8, B), (idx, tbl))
        got = E.row_gather(t(tbl), t(idx[0]), lane_sum=True).expand(8, -1)
        np.testing.assert_allclose(got.numpy(), out, rtol=0,
                                   atol=1e-6 * np.abs(out).max())
    elif kernel == "k_lane":
        vals, li = _randn(B, 128), _idx(B * 128, 128, shape=(B, 128))
        out = _probe_kernel(rel, "probe_kernel", kernel, (B, 128), (vals, li))
        np.testing.assert_array_equal(
            E.elem_gather(t(vals), t(li), "axis1").numpy(), out)
    else:
        small, idx = _randn(128, 128), _idx(B, 256, shape=(1, B))
        out = _probe_kernel(rel, "probe_kernel", kernel, (B, 128), (idx, small))
        got = E.row_gather(t(small), t(idx[0])).numpy()
        np.testing.assert_array_equal(got, out)
        assert not got[idx[0] >= 128].any()


@pytest.mark.parametrize("kernel,rows", [("k_tala0", 16), ("k_tala0", 64),
                                         ("k_tala1", None),
                                         ("k_rowtake", 64)])
def test_probe_tpu2_probe_pallas(kernel, rows):
    """probe_tpu2.py:93 (probe_pallas :91; the line ``:90`` is a comment)
    over k_tala0 (from a small and a larger table) and k_tala1 as K2, and
    k_rowtake as K1: bit for bit."""
    B, rel = 256, f"{ARCHIVE}/probe_tpu2.py"
    if kernel == "k_tala1":
        src, idx = _randn(B, 128), _idx(B * 128, 128, shape=(B, 128))
        out = _probe_kernel(rel, "probe_pallas", kernel, (B, 128), (src, idx))
        got = E.elem_gather(t(src), t(idx), "axis1")
    else:
        src, idx = _randn(rows, 128), _idx(B * 128, rows, shape=(B, 128))
        out = _probe_kernel(rel, "probe_pallas", kernel, (B, 128), (src, idx))
        got = (E.elem_gather(t(src), t(idx), "axis0") if kernel == "k_tala0"
               else E.row_gather(t(src), t(idx[:, 0].copy())))
    np.testing.assert_array_equal(got.numpy(), out)


def test_probe_round2_k_lane():
    """probe_round2.py:240 (k_lane :234): K2 on axis 1, bit for bit."""
    t4 = _randn(512, 128)
    ns, _ = archived_kernels(f"{ARCHIVE}/probe_round2.py", ["k_lane", "lane"],
                             M=512 * 128, t4=jnp.asarray(t4))
    i4 = _idx(512 * 128, 128, shape=(512, 128))
    out = np.asarray(ns["lane"](jnp.asarray(i4)))
    np.testing.assert_array_equal(
        E.elem_gather(t(t4), t(i4), "axis1").numpy(), out)


# -------------------------------------------------------------------- K4
BWD_SPEC = dict(n_levels=4, log2_hashmap_size=12, max_level_size=1 << 11)


@pytest.mark.parametrize("variant", ["v2d", "alt2", "novals", "noscat"])
def test_probe_bwd_var_make(variant):
    """probe_bwd_var.py:101 (make :66, vals_phase :40) at 4 levels of
    2^11 entries, N = 1024 in blocks of 256: the JAX package's entries
    (``_entry_indices``, as the file's module code builds rows3 / slots3)
    equal the port's own (``packed_rows_slots``), and K4's twin equals the
    kernel's accumulator within K4_RTOL of its largest entry."""
    n, blk = 1024, 256
    jspec, spec = JaxSpec(**BWD_SPEC), HashGridSpec(**BWD_SPEC)
    L, rows_n = spec.n_levels, max(spec.level_sizes) // 8
    rng = np.random.default_rng(0)
    pos = rng.uniform(size=(n, 3)).astype(np.float32)
    g = (rng.normal(size=(n, 2 * L)) * 0.01).astype(np.float32)
    e0, _ = jax_hash_nbr._entry_indices(jspec, jnp.asarray(pos))
    e0 = np.asarray(e0)
    nblk = n // blk
    rows3 = (e0 >> 3).T.astype(np.int32).reshape(L * nblk, 1, blk)
    slots3 = (e0 & 7).T.astype(np.int32).reshape(L * nblk, 1, blk)
    g_t = g.T.reshape(2, L, n).transpose(1, 0, 2)
    scales = np.asarray(spec.scales, np.float32)
    ns, _ = archived_kernels(f"{ARCHIVE}/probe_bwd_var.py",
                             ["vals_phase", "make"], BLK=blk, ROWS=rows_n, L=L,
                             NBLK=nblk)
    out = np.asarray(ns["make"](variant)(
        jnp.asarray(rows3), jnp.asarray(slots3), jnp.asarray(pos.T),
        jnp.asarray(g_t), jnp.asarray(scales.reshape(L, 1))))
    rows, slots = E.packed_rows_slots(spec, t(pos))
    np.testing.assert_array_equal(rows.numpy(), (e0 >> 3).T)
    np.testing.assert_array_equal(slots.numpy(), (e0 & 7).T)
    n_acc, mode = (2, "v2d") if variant == "alt2" else (1, variant)
    got = E.packed_hash_scatter(t(pos), t(g), rows, slots, scales, rows_n,
                                n_acc, mode, blk)
    _scatter_close(got, out, K4_RTOL)
    assert np.abs(out).max() > 0


# ------------------------------------------------------- wrappers' checks
def test_wrappers_refuse_what_the_kernels_cannot_take():
    """int32 indices only; K1 rows of a multiple of 16 bytes; K3 widths of
    a multiple of 4; K4's modes and shapes (checked before the CPU twin
    runs, so a CPU caller meets the card's rules)."""
    tbl, idx = torch.zeros(8, 8), torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError):
        E.row_gather(tbl, idx.long())
    with pytest.raises(ValueError, match="16-byte"):
        E.row_gather(torch.zeros(8, 6), idx)
    with pytest.raises(ValueError):
        E.row_gather(tbl.bfloat16(), idx, lane_sum=True)
    with pytest.raises(TypeError):
        E.elem_gather(tbl, idx.long(), "flat")
    with pytest.raises(ValueError):
        E.elem_gather(tbl, idx, "axis2")
    with pytest.raises(ValueError):
        E.row_scatter_add(idx, torch.zeros(4, 6), 8)
    rows = torch.zeros(2, 4, dtype=torch.int32)
    with pytest.raises(ValueError):
        E.packed_hash_scatter(torch.zeros(4, 3), torch.zeros(4, 4), rows,
                              rows, [1.0, 2.0], 8, n_acc=2, mode="noscat")


def test_out_of_table_indices_read_zero_and_add_nothing():
    """The twins' rule, which the kernels share: a gather gives 0 for an
    index outside its table, a scatter drops it."""
    tbl = torch.arange(32, dtype=torch.float32).reshape(8, 4) + 1
    idx = torch.tensor([0, -1, 7, 8], dtype=torch.int32)
    got = E.row_gather(tbl, idx)
    assert torch.equal(got[[1, 3]], torch.zeros(2, 4))
    assert torch.equal(got[[0, 2]], tbl[[0, 7]])
    assert torch.equal(E.elem_gather(tbl, idx, "flat"),
                       torch.tensor([1.0, 0.0, 8.0, 9.0]))
    out = E.row_scatter_add(idx, torch.ones(4, 4), 8)
    assert float(out.sum()) == 8.0


# ------------------------------------------------------------ byte counts
def test_gather_and_scatter_bytes_by_hand():
    """probe_loop's gather at N = 2^20 of 512-byte rows with 65,536
    distinct rows: indices 4 MiB + rows 32 MiB + output 512 MiB; its
    scatter, counted as kernel B's bound counts (inputs read once, the
    output written once): indices 4 MiB + values 512 MiB + the [65536,
    128] output 32 MiB."""
    n, t_rows = 1 << 20, 65536
    assert common.gather_bytes(n, 512, t_rows) == \
        4 * n + 512 * t_rows + 512 * n == 574_619_648
    assert common.scatter_bytes(n, 512, t_rows) == \
        4 * n + 512 * n + 512 * t_rows == 574_619_648
    assert common.scatter_bytes(n, 512, t_rows, val_row_bytes=256) == \
        4 * n + 256 * n + 512 * t_rows
    # gather*w reads w too; a lane sum writes 4 bytes a row.
    assert common.gather_bytes(n, 512, 10, w_row_bytes=512) - \
        common.gather_bytes(n, 512, 10) == 512 * n
    assert common.gather_bytes(8, 512, 3, out_row_bytes=4) == 32 + 1536 + 32
    assert common.bound_ms(3.35e9) == pytest.approx(1.0)
    assert common.bound_ms(0, flops=989e9) == pytest.approx(1.0)


def test_element_gather_counts_distinct_elements():
    """take_along_axis reads distinct (index, other coordinate) pairs:
    two rows that take the same lane read two elements; one row that
    takes a lane twice reads it once."""
    idx = torch.tensor([[1, 1, 2], [1, 0, 0]], dtype=torch.int32)
    assert common.distinct_along(idx, 1) == 4   # (0,1) (0,2) (1,1) (1,0)
    assert common.distinct_along(idx, 0) == 5   # (1,0) (1,1) (2,2) (0,1) (0,2)
    assert common.elem_bytes(idx, 4) == 8 * 6 + 16


def test_packed_scatter_bytes_by_hand():
    """K4 at 2 levels, 4 samples, 8 rows a level, counted as kernel B's
    bound counts: v2d reads pos 48 + g 64 + rows and slots 64 bytes and
    writes 2 x 8 rows of 512 bytes (twice that with two accumulators);
    novals reads the rows alone (32); noscat pos, g and the slots of each
    8192-sample block's first sample (2 x 4), and writes 64 bytes of
    contributions a (level, sample) beside its output."""
    from jnerf_tpu_torch.tools.archive import probe_bwd_var

    out = 2 * 8 * 512
    assert probe_bwd_var.k4_bytes(2, 4, 8, 1, "v2d") == 48 + 64 + 64 + out
    assert probe_bwd_var.k4_bytes(2, 4, 8, 2, "v2d") == 48 + 64 + 64 + 2 * out
    assert probe_bwd_var.k4_bytes(2, 4, 8, 1, "novals") == 32 + out
    assert probe_bwd_var.k4_bytes(2, 4, 8, 1, "noscat") == \
        48 + 64 + 8 + 64 * 8 + out
    # probe_bwd_var's v2d: N = 2^18, 16 levels of 32768 rows, 0.1011 ms.
    n = 1 << 18
    assert probe_bwd_var.k4_bytes(16, n, 32768, 1, "v2d") == \
        3_145_728 + 67_108_864 + 268_435_456 == 338_690_048


def test_packed_scatter_sums_each_segment_in_sample_order():
    """Three samples into one slot segment with corner weight 1 and g0 =
    1e8, 1, -1e8: summed in sample order from zero, (1e8 + 1) - 1e8 is 0
    in f32 (1e8 + 1 rounds to 1e8); another order gives 1.  The twin (and
    K4 on the card) sums in sample order."""
    pos = torch.full((3, 3), 0.5)  # scale 1: fract(0.5 + 0.5) = 0, X = (1, 0)
    g = torch.tensor([[1e8, 0.0], [1.0, 0.0], [-1e8, 0.0]])
    rows = torch.tensor([[2, 2, 2]], dtype=torch.int32)
    slots = torch.tensor([[5, 5, 5]], dtype=torch.int32)
    out = E.packed_hash_scatter(pos, g, rows, slots, [1.0], 4)
    assert out[2, 5 * 16].item() == 0.0
    assert out[2, 5 * 16 + 1].item() == 0.0  # G1 = g0 + (g1 - g0)
    assert torch.count_nonzero(out) == 0


@pytest.mark.parametrize("n_acc,mode,n_rows,tile_rows", [
    (1, "v2d", 37, 8), (2, "v2d", 40, 16), (1, "novals", 37, 8),
    (2, "novals", 128, 128)])
def test_packed_bin_plan_is_a_stable_sort_by_tile(n_acc, mode, n_rows,
                                                   tile_rows):
    """K4's bin plan (the kernels' bins, plainly): each kept entry's tile,
    and the entries in np.argsort(kind="stable") order of it; rows and
    slots outside their ranges dropped, the last tile of a slab short."""
    L, n = 3, 500
    rng = np.random.default_rng(0)
    rows = rng.integers(-2, n_rows + 2, (L, n)).astype(np.int32)
    slots = rng.integers(-1, 9, (L, n)).astype(np.int32)
    tile, order, start = E.packed_bin_plan(t(rows), t(slots), n_rows, n_acc,
                                           mode, tile_rows)
    tps = -(-n_rows // tile_rows)
    ok = (rows >= 0) & (rows < n_rows)
    if mode == "v2d":
        ok &= (slots >= 0) & (slots < 8)
    want = ((np.arange(L)[:, None] * n_acc + np.arange(n) % n_acc) * tps
            + np.maximum(rows, 0) // tile_rows)
    np.testing.assert_array_equal(tile.numpy(), np.where(ok, want, -1))
    flat = tile.numpy().reshape(-1)
    kept = np.nonzero(flat >= 0)[0]
    np.testing.assert_array_equal(
        order.numpy(), kept[np.argsort(flat[kept], kind="stable")])
    np.testing.assert_array_equal(
        start.numpy(), np.concatenate([[0], np.cumsum(np.bincount(
            flat[kept], minlength=L * n_acc * tps))]))


@pytest.mark.parametrize("n_acc,mode", [(1, "v2d"), (2, "v2d"),
                                        (1, "novals")])
def test_plain_bins_summed_in_order_are_the_twin(n_acc, mode):
    """K4's records (`packed_bins_plain`), their contributions summed
    into their tiles in bin order from zero, give the twin's output bit
    for bit: the records carry what the kernel's accumulate pass needs,
    and bin order is sample order within a tile."""
    L, n, n_rows, tr = 3, 400, 37, 8
    rng = np.random.default_rng(1)
    pos = t(rng.uniform(size=(n, 3)).astype(np.float32))
    g = t((rng.normal(size=(n, 2 * L)) * 0.01).astype(np.float32))
    rows = t(rng.integers(-1, n_rows + 1, (L, n)).astype(np.int32))
    slots = t(rng.integers(0, 8, (L, n)).astype(np.int32))
    slots[0, :40] = 3  # crowd a few segments
    rows[0, :40] = 5
    scales = np.asarray([3.0, 17.5, 101.25], np.float32)
    start, recA, recB = E.packed_bins_plain(pos, g, rows, slots, scales,
                                            n_rows, n_acc, mode, tr)
    tps = -(-n_rows // tr)
    tile = torch.repeat_interleave(torch.arange(len(start) - 1),
                                   (start[1:] - start[:-1]).long())
    row = ((tile // tps) * n_rows + (tile % tps) * tr
           + recB[:, 1].long() // 8)
    out = torch.zeros((L * n_acc * n_rows, E.LANES))
    if mode == "novals":
        out.index_add_(0, row, torch.ones((len(row), E.LANES)))
    else:
        f, g0 = recA[:, :3], recA[:, 3]
        g1 = recB[:, 0].contiguous().view(torch.float32)
        X = [(1.0 - f[:, d], (1.0 - f[:, d]) + (2.0 * f[:, d] - 1.0))
             for d in range(3)]
        G = (g0, g0 + (g1 - g0))
        v = torch.stack([(X[0][c & 1] * X[1][(c >> 1) & 1])
                         * X[2][(c >> 2) & 1] * G[k]
                         for c in range(8) for k in range(2)], 1)
        out.view(-1, 16).index_add_(0, row * 8 + recB[:, 1].long() % 8, v)
    twin = E.packed_hash_scatter_plain(pos, g, rows, slots, scales, n_rows,
                                       n_acc, mode)
    assert torch.equal(out, twin)
    assert torch.count_nonzero(twin) > 0


# --------------------------------------------------------------- probes
TINY = {
    "probe_rmw": dict(N=2048, ROWS=64),
    "probe_scatter": dict(N=4096, T=256, NL=1024, TL=64, CHECK_ROWS=64,
                          CHECK_N=512, NL2=1024, TL2=128),
    "probe_scatter2": dict(CHECK_ROWS=64, CHECK_N=512, NL2=1024, TL2=64,
                           T=256, N=1024),
    "probe_loop": dict(T=128, N=1024),
    "probe_final": dict(N=1024, TBIG=256, NL=1024, TL=64, T19=256),
    "probe_round2": dict(STREAM_SHAPE=(16, 16), MATMUL=32, XLA_N=2048,
                         XLA_T=128, RATE_N=1024, RATE_T=64, LANE_M=4096),
    "probe_tpu": dict(MATMUL=32, SCALE_SHAPE=(4, 4, 4), N=64, M=1 << 12,
                      B=256),
    "probe_tpu2": dict(MATMUL=32, SCALE_SHAPE=(8, 8), R=256, T=64,
                       FLAT=4096, B=128, SMALL_T=16, BIG_T=64),
    "probe_bwd_var": dict(N=1024, BLK=256, SPEC=BWD_SPEC),
}
ARGS = {"probe_final": ["1", "2", "3", "4", "5"],
        "probe_bwd_var": ["noscat", "novals", "v2d", "alt2", "v3d"]}
# The archived files' line names, in their order.
LINES = {
    "probe_rmw": [f"rmw {m}" for m in ("plain", "slab", "unroll16", "wide")],
    "probe_scatter": [
        "XLA scatter [0M]->[0K,16] float32", "XLA scatter [0M]->[0K,16] bfloat16",
        "XLA scatter [0M]->[0K,128] float32",
        "XLA scatter [0M]->[0K,128] bfloat16",
        "XLA per-level scatter x16 [256K]->[64K,16] f32",
        "pallas scatter correct",
        "pallas RMW scatter unroll=8 [1M]->[64K,128] f32",
        "pallas RMW scatter unroll=16 [1M]->[64K,128] f32"],
    "probe_scatter2": [
        "interleaved scatter correct",
        "pallas K=2 interleaved scatter [1M]->[16K,128]",
        "pallas K=4 interleaved scatter [1M]->[16K,128]",
        "XLA fused fwd gather+blend [4M rows]", "XLA fused fwd reshape variant",
        "XLA gather alone [4M,128] bf16"],
    "probe_loop": ["unroll8 gather correct"]
    + [f"gather unroll={u}" for u in (1, 4, 8, 16)]
    + ["unroll8 scatter correct", "scatter unroll=1", "scatter unroll=8"],
    "probe_final": ["XLA scatter bf16 [4M]->[1M,128]",
                    "XLA scatter f32 [4M]->[1M,128]",
                    "pallas RMW scatter [1M]->[16K,128]",
                    "XLA fused fwd (reshape blend)", "XLA fused fwd (mask blend)"],
    "probe_round2": [
        "scale 128MB r+w", "matmul 32 bf16", "row gather [128,128] bf16",
        "row gather [128,16] bf16", "row gather sorted-flag", "row scatter-add",
        "argsort+gather+segsum scatter", "argsort 0M int32 alone",
        "ds-loop gather correct", "pallas ds-loop row gather (VMEM tbl)",
        "pallas ds-loop gather*w", "pallas ds-loop row scatter-add",
        "pallas lane dyn-gather (128-wide)"],
    "probe_tpu": [
        "matmul 32 bf16", "scale 256MB", "xla take [N,128] of [512k]",
        "xla take col-sorted idx", "xla row-gather [N]x128",
        "pallas take flat [8,B] of 512k", "pallas take rows [B] of [4096,128]",
        "pallas take_along_axis lanes [B,128]",
        "pallas one-hot matmul 128-table"],
    "probe_tpu2": [
        "matmul4096", "scale128MB", "xla row-gather 262k x 128f32",
        "xla elem-gather 33.5M", "xla tala axis1 33.5M", "xla tala axis0 33.5M",
        "pallas tala axis0 [8k,128] from [16,128]",
        "pallas tala axis1 [8k,128] lanes",
        "pallas tala axis0 [8k,128] from [64,128]",
        "pallas take rows [B] from [64,128]"],
    "probe_bwd_var": ["noscat", "novals", "v2d", "alt2", "v3d"],
}


def _module(name):
    import importlib

    return importlib.import_module(f"jnerf_tpu_torch.tools.archive.{name}")


@pytest.fixture()
def tiny(monkeypatch):
    monkeypatch.setattr(common, "REPS", 1)
    monkeypatch.setattr(common, "FLUSH_BYTES", 1 << 16)

    def shrink(name):
        mod = _module(name)
        for k, v in TINY[name].items():
            monkeypatch.setattr(mod, k, v)
        return mod

    return shrink


@pytest.mark.parametrize("name", sorted(TINY))
def test_probe_runs_on_the_cpu(tiny, name, capsys):
    """Each ported probe's main with --cpu at a tiny size prints the
    archive's lines under its names, each with a positive rate, bytes and
    bound; every correctness line reads True."""
    lines = tiny(name).main(ARGS.get(name, []) + ["--cpu"])
    assert [ln["name"] for ln in lines] == LINES[name]
    for ln in lines:
        if "ok" in ln:
            assert ln["ok"] is True
        else:
            assert ln["ms"] > 0 and ln["bytes"] > 0 and ln["bound_ms"] > 0
            assert ln["clock"] == "host"
    out = capsys.readouterr().out
    assert out.startswith("card: cpu\n")


def test_probe_round2_card_shapes(tiny):
    """--table-rows, --row-bytes, --pattern, --l2 and --accesses replace
    the row sections' shapes by every combination: 2 x 2 x 2 shapes of
    three pallas_rate lines each, then the lane gather; each line carries
    its shape."""
    lines = tiny("probe_round2").main(
        ["--cpu", "--section", "pallas_rate", "--table-rows", "7",
         "--row-bytes", "16,32", "--pattern", "uniform,clustered", "--l2",
         "warm,flushed", "--accesses", "10"])
    rated = [ln for ln in lines if "ms" in ln][:-1]
    assert len(rated) == 8 * 3
    assert {(ln["row_bytes"], ln["pattern"], ln["l2"]) for ln in rated} == {
        (b, p, c) for b in (16, 32) for p in ("uniform", "clustered")
        for c in ("warm", "flushed")}
    assert all(ln["n"] == 1024 and ln["table_rows"] == 128 for ln in rated)
    with pytest.raises(SystemExit):
        _module("probe_round2").main(["--cpu", "--row-bytes", "24"])


def test_probe_bwd_var_tile_heights(tiny):
    """Each K4 line names the tile height the wrapper chose for its mode
    (64 rows for v2d, 128 for alt2 and novals; noscat has no tiles);
    --split adds no kernel times on the CPU."""
    lines = tiny("probe_bwd_var").main(
        ["novals", "noscat", "v2d", "alt2", "--split", "--cpu"])
    assert [(ln["name"], ln["tile_rows"]) for ln in lines] == [
        ("novals", 128), ("noscat", None), ("v2d", 64), ("alt2", 128)]
    assert all(ln["split_us"] == {} for ln in lines)
    assert [E.k4_tile_rows(1, "v2d"), E.k4_tile_rows(2, "v2d"),
            E.k4_tile_rows(1, "novals")] == [64, 128, 128]
    with pytest.raises(SystemExit):
        _module("probe_bwd_var").main(["--cpu", "--tile-rows", "64"])


@pytest.mark.parametrize("name", sorted(TINY))
def test_probe_refuses_to_run_without_a_card(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _module(name).main(ARGS.get(name, []))



def test_launch_cost_refuses_to_run_without_a_card(monkeypatch):
    """The launch-cost tool times ctypes launches: it runs on the card
    only, and says so without one."""
    from jnerf_tpu_torch.tools import launch_cost

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch_cost.main(["--calls", "10"])

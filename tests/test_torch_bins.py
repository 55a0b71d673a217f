"""The plain twins of the sorts that kernel B and K3 sum in, and the order
of the sums, on the CPU.

Kernel B (`csrc/hash_encode.cu`) and K3 (`csrc/envelope.cu`) sort their
items stably by output row on the card (`csrc/bins.cuh`) and then add
each row's contributions in a fixed order from +0.0.  Here:

- the sorts' plain twins (`hash_nbr.grad_table_plan_plain`,
  `envelope.row_scatter_plan_plain`) are held to ``np.argsort(kind=
  "stable")`` and ``np.searchsorted``;
- each kernel's sum is replayed in plain f32 from the twin's plan, row by
  row in the kernel's order, and must equal the kernel's plain twin bit
  for bit, also on a level whose corners collide.  Kernel B: each run of
  sorted positions (linear: corner by corner, the samples whose base
  entry is the row's, less the corner's offset; xor: the row's (sample,
  corner) items) cut where the position crosses a multiple of
  ``hash_grid.PIECE``, each piece summed from +0.0, then the pieces
  summed from +0.0 in order.  K3: the source indices ascending.
Card tests (`tests/test_torch_cuda.py`) hold the kernels' own sorts and
sums to these twins bit for bit.
"""

import numpy as np
import pytest
import torch

from jnerf_tpu_torch.ops import envelope, hash_grid, hash_nbr
from jnerf_tpu_torch.ops.hash_grid import HashGridSpec

SPECS = {
    # dense and power-of-two hashed levels
    "f8l4": dict(n_levels=4, n_features_per_level=8, base_resolution=4,
                 log2_hashmap_size=11, desired_resolution=64.0),
    # hashed levels that take a real modulo
    "f2l8cap3000": dict(n_levels=8, n_features_per_level=2,
                        base_resolution=4, log2_hashmap_size=12,
                        desired_resolution=256.0, max_level_size=3000),
    # 5 entries a level: a cell's 8 corners land on at most 5 of them
    "f4l2cap5": dict(n_levels=2, n_features_per_level=4, base_resolution=4,
                     log2_hashmap_size=10, desired_resolution=16.0,
                     max_level_size=5),
}


def _samples(spec, n, clustered, seed=0):
    """Positions in [0, 1] (uniform, or runs along 16 rays from a small
    ball, as a training step's) and g ~ N(0, 1) made with numpy; the last
    tenth of the samples are empty slots (one position, g all zero, as
    compaction leaves them) and every seventh sample's g is zero at level
    0 alone."""
    rng = np.random.default_rng(seed)
    if clustered:
        per = -(-n // 16)
        start = 0.5 + rng.uniform(-0.1, 0.1, size=(16, 1, 3))
        d = rng.normal(size=(16, 1, 3))
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        t = np.arange(per)[None, :, None] * 0.004
        pos = np.clip(start + t * d, 0.0, 1.0).reshape(-1, 3)[:n]
    else:
        pos = rng.uniform(size=(n, 3))
    F, L = spec.n_features_per_level, spec.n_levels
    g = rng.normal(size=(n, F, L))
    pos[n - n // 10:] = pos[n - n // 10 - 1]
    g[n - n // 10:] = 0.0
    g[::7, :, 0] = 0.0
    return (torch.from_numpy(pos.astype(np.float32)),
            torch.from_numpy(g.reshape(n, F * L).astype(np.float32)))


def _keys(spec, pos, g, xor):
    """Each level's items' keys [L, M] (numpy), as the plan twin keys
    them: the base entry e0, or each (sample, corner)'s entry; the level's
    size for a sample whose g is all zero at the level."""
    n, L, F = pos.shape[0], spec.n_levels, spec.n_features_per_level
    offs = np.asarray(spec.level_offsets[:-1])
    live = (g.numpy().reshape(n, F, L) != 0).any(axis=1).T  # [L, N]
    if xor:
        idx = hash_grid.hash_grid_indices(spec, pos)[0].numpy()
        keys = (idx.reshape(n, L, 8) - offs[None, :, None]) \
            .transpose(1, 0, 2).reshape(L, n * 8)
        live = np.repeat(live, 8, axis=1)
    else:
        consts = hash_nbr.level_consts(spec)
        keys = np.stack([hash_nbr._cell(consts, lvl, pos)[0].numpy()
                         for lvl in range(L)])
    return np.where(live, keys, np.asarray(spec.level_sizes)[:, None])


@pytest.mark.parametrize("xor", [False, True])
@pytest.mark.parametrize("name", list(SPECS))
def test_grad_table_plan_is_a_stable_sort(name, xor):
    """Each level's items in np.argsort(kind="stable") order (a sample
    whose g is all zero at the level keyed by the level's size, after
    every entry), and start[off_l + l + k] the first position of key k
    (np.searchsorted), for k up to the level's size."""
    spec = HashGridSpec(**SPECS[name])
    pos, g = _samples(spec, 3001, clustered=True)
    start, order = hash_nbr.grad_table_plan_plain(spec, pos, g, xor=xor)
    keys = _keys(spec, pos, g, xor)
    L, M = keys.shape
    assert start.dtype == order.dtype == torch.int32
    assert order.shape == (L * M,)
    assert start.shape == (spec.n_entries + L + 1,)
    want_start = []
    for lvl in range(L):
        srt = np.argsort(keys[lvl], kind="stable")
        assert np.array_equal(order[lvl * M:(lvl + 1) * M].numpy(), srt)
        want_start.append(lvl * M + np.searchsorted(
            keys[lvl][srt], np.arange(spec.level_sizes[lvl] + 1)))
    want_start.append([L * M])
    assert np.array_equal(start.numpy(), np.concatenate(want_start))


def _add_runs(total, j0, j1, base, contribution):
    """Adds to each row's total [R, F] its run of sorted positions [j0,
    j1) (level-local: the level's first position is base) in pieces: a
    piece ends where the position reaches a multiple of PIECE, is summed
    from +0.0, and is then added to the total.  contribution(rows, p)
    gives the rows' contributions at level-local positions p."""
    piece = torch.zeros_like(total)
    for r in range(int((j1 - j0).max()) if j0.numel() else 0):
        live = j0 + r < j1
        p = (j0 + r - base)[live]
        cut = live.clone()
        cut[live] = (r > 0) & (p % hash_grid.PIECE == 0)
        total[cut] = total[cut] + piece[cut]
        piece[cut] = 0.0
        piece[live] = piece[live] + contribution(live, p)
    ran = j1 > j0
    total[ran] = total[ran] + piece[ran]


def _replay_linear(spec, pos, g, start, order):
    """Kernel B's linear sum from a plan: entry e of level l adds, corner
    by corner, the run of samples whose base entry is (e - coff_c) mod
    size, in pieces, each contribution w_c * g in f32."""
    consts = hash_nbr.level_consts(spec)
    L, F = spec.n_levels, spec.n_features_per_level
    n = pos.shape[0]
    g3 = g.reshape(n, F, L)
    out = []
    for lvl in range(L):
        size, off = spec.level_sizes[lvl], spec.level_offsets[lvl]
        _, X = hash_nbr._cell(consts, lvl, pos)
        e = torch.arange(size)
        acc = torch.zeros((size, F), dtype=torch.float32)
        for c in range(8):
            w = hash_nbr._corner_weight(X, c)
            e0 = (e - int(consts.corner_offs[lvl, c])) % size

            def contribution(live, p, lvl=lvl, w=w):
                s = order[lvl * n + p].long()
                return w[s][:, None] * g3[s, :, lvl]

            _add_runs(acc, start[off + lvl + e0].long(),
                      start[off + lvl + e0 + 1].long(), lvl * n, contribution)
        out.append(acc)
    return torch.cat(out)


def _replay_xor(spec, pos, g, bf16, start, order):
    """Kernel B's xor sum from a plan: entry e adds its run of (sample,
    corner) items in pieces, each formed as xor_contributions forms it."""
    L, F = spec.n_levels, spec.n_features_per_level
    n = pos.shape[0]
    _, vals = hash_grid.xor_contributions(spec, pos, g, bf16)
    vals = vals.reshape(n, L, 8, F)
    out = []
    for lvl in range(L):
        size, off = spec.level_sizes[lvl], spec.level_offsets[lvl]
        v = vals[:, lvl].reshape(n * 8, F)
        e = torch.arange(size)
        acc = torch.zeros((size, F), dtype=torch.float32)
        _add_runs(acc, start[off + lvl + e].long(),
                  start[off + lvl + e + 1].long(), lvl * n * 8,
                  lambda live, p, lvl=lvl, v=v: v[order[lvl * n * 8 + p].long()])
        out.append(acc)
    return torch.cat(out)


@pytest.mark.parametrize("clustered", [False, True])
@pytest.mark.parametrize("name", list(SPECS))
def test_grad_table_twins_sum_in_the_kernel_order(name, clustered):
    """The linear and xor twins equal their kernel's sum replayed from the
    plan, bit for bit; the clustered runs span many pieces (2003 samples
    on 16 rays), and on "f4l2cap5" the corners of one cell share
    entries."""
    spec = HashGridSpec(**SPECS[name])
    pos, g = _samples(spec, 2003, clustered)
    want = hash_nbr.grad_table_plain(spec, pos, g)
    got = _replay_linear(spec, pos, g,
                         *hash_nbr.grad_table_plan_plain(spec, pos, g))
    assert torch.equal(got, want)
    plan = hash_nbr.grad_table_plan_plain(spec, pos, g, xor=True)
    for bf16 in (True, False):
        want = hash_grid.grad_table_xor_plain(spec, pos, g, bf16)
        assert torch.equal(_replay_xor(spec, pos, g, bf16, *plan), want)


def test_corners_that_share_an_entry_collide():
    """The colliding spec does what its test claims: some cell's corners
    land on one entry, in both modes."""
    spec = HashGridSpec(**SPECS["f4l2cap5"])
    assert set(spec.level_sizes) == {5}
    pos, _ = _samples(spec, 64, clustered=False)
    idx = hash_grid.hash_grid_indices(spec, pos)[0].reshape(64, 2, 8)
    assert any(len(set(row.tolist())) < 8 for row in idx.reshape(-1, 8))
    consts = hash_nbr.level_consts(spec)
    e0, _ = hash_nbr._cell(consts, 0, pos)
    corners = torch.stack([hash_nbr._corner_entry(consts, 0, e0, c)
                           for c in range(8)], 1)
    assert any(len(set(row.tolist())) < 8 for row in corners)


def test_sums_run_in_order_from_zero():
    """1e8, 1, -1e8 into one entry in that order (one piece) give 0 in
    the linear twin (an f32 sum in another order gives 1): the twin's
    order is the one the kernel follows."""
    spec = HashGridSpec(n_levels=1, n_features_per_level=1, base_resolution=2,
                        log2_hashmap_size=4, desired_resolution=2.0)
    pos = torch.full((3, 3), 0.25)
    g = torch.tensor([[1e8], [1.0], [-1e8]])
    grad = hash_nbr.grad_table_plain(spec, pos, g)
    start, order = hash_nbr.grad_table_plan_plain(spec, pos, g)
    assert order.tolist() == [0, 1, 2]
    assert torch.count_nonzero(grad) == 0
    assert torch.equal(_replay_linear(spec, pos, g, start, order), grad)


@pytest.mark.parametrize("n,n_rows,w", [(5003, 257, 4), (2048, 64, 32),
                                        (4099, 1000, 128)])
def test_row_scatter_plan_and_sum_order(n, n_rows, w):
    """K3's plan twin is np.argsort(kind="stable") of the rows (an index
    outside [0, n_rows) after every row), and its twin (index_add_)
    equals the sum replayed from the plan, row by row in index order, bit
    for bit; the plan on CPU tensors is the twin."""
    rng = np.random.default_rng(n)
    idx = torch.from_numpy(rng.integers(-8, n_rows + 8, n).astype(np.int32))
    vals = torch.from_numpy(rng.normal(size=(n, w)).astype(np.float32))
    start, order = envelope.row_scatter_plan(idx, vals, n_rows)
    key = np.where((idx.numpy() >= 0) & (idx.numpy() < n_rows), idx.numpy(),
                   n_rows)
    srt = np.argsort(key, kind="stable")
    assert np.array_equal(order.numpy(), srt)
    assert np.array_equal(start.numpy(), np.searchsorted(
        key[srt], np.arange(n_rows + 1)))
    j0, j1 = start[:-1].long(), start[1:].long()
    acc = torch.zeros((n_rows, w), dtype=torch.float32)
    for r in range(int((j1 - j0).max())):
        live = j0 + r < j1
        acc[live] = acc[live] + vals[order[(j0 + r)[live]].long()]
    assert torch.equal(acc, envelope.row_scatter_add(idx, vals, n_rows))

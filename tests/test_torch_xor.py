"""The port's xor hash (``hash_indexing='xor'``, the reference's own hash)
against the JAX package's `jnerf_tpu/ops/hash_grid.py`: the geometry, the
hash expression, the encode in bf16 and f32, and the table gradient."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jnerf_tpu.ops import hash_grid as jhg
from jnerf_tpu_torch.ops import hash_grid as thg
from jnerf_tpu_torch.ops import hash_xor
from torch_parity import j, n, t

# (levels, features, log2 size, base res): dense and hashed levels.
SPECS = {"f2l4": (4, 2, 12, 16), "f8l4": (4, 8, 11, 8), "f1l6": (6, 1, 10, 4)}
CUSTOM = "(p0 * 73856093) ^ (p1 << 5) + (p2 >> 1) * 19349663 | 7"


def _specs(name, hash_func=thg.DEFAULT_HASH_FUNC):
    L, F, log2, base = SPECS[name]
    kw = dict(n_levels=L, n_features_per_level=F, log2_hashmap_size=log2,
              base_resolution=base, hash_func=hash_func)
    return jhg.HashGridSpec(**kw), thg.HashGridSpec(**kw)


def _pos(count, seed=0, lo=0.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, (count, 3)).astype(
        np.float32)


def _bf16_ulps(a, b):
    def line(x):
        bits = x.view(np.int16).astype(np.int32)
        return np.where(bits < 0, -(bits & 0x7FFF), bits)

    return int(np.abs(line(a) - line(b)).max())


@pytest.mark.parametrize("name,hash_func", [
    ("f2l4", "default"), ("f8l4", "default"), ("f1l6", "default"),
    ("f2l4", "custom")])
def test_indices_and_weights_equal_jax(name, hash_func):
    """hash_grid_indices: the same int32 entries and f32 weights, bit for
    bit, on positions in and just outside [0, 1] (where f32 -> uint32
    saturates)."""
    func = CUSTOM if hash_func == "custom" else thg.DEFAULT_HASH_FUNC
    js, ts = _specs(name, func)
    pos = _pos(1000, lo=-0.05, hi=1.05)
    ji, jw = jhg.hash_grid_indices(js, j(pos))
    ti, tw = thg.hash_grid_indices(ts, t(pos))
    assert ti.dtype == torch.int32 and tw.dtype == torch.float32
    np.testing.assert_array_equal(n(ti), n(ji))
    np.testing.assert_array_equal(n(tw).view(np.int32), n(jw).view(np.int32))


def test_reference_sizes_equal_jax():
    """The flagship encoder's reference geometry (no fast cap): 6,098,120
    entries, five dense levels then eleven of 2^19, with the same scales and
    offsets as the JAX spec, and the same entries on a few positions."""
    js, ts = jhg.HashGridSpec(), thg.HashGridSpec()
    assert ts.n_entries == js.n_entries == 6_098_120
    assert ts.level_sizes == js.level_sizes and ts.scales == js.scales
    assert ts.level_offsets == js.level_offsets
    assert [r ** 3 <= s for r, s in zip(ts.resolutions, ts.level_sizes)] == \
        [True] * 5 + [False] * 11
    pos = _pos(500, seed=1)
    np.testing.assert_array_equal(n(thg.hash_grid_indices(ts, t(pos))[0]),
                                  n(jhg.hash_grid_indices(js, j(pos))[0]))


@pytest.mark.parametrize("name", list(SPECS))
def test_encode_matches_jax(name):
    """The xor twin against the JAX hash_encode: in bf16 (bf16 table,
    weights and products, summed in f32 and rounded once) within one bf16
    ulp; in f32 at rtol 1e-6 (the sum over corners in another order)."""
    js, ts = _specs(name)
    rng = np.random.default_rng(2)
    table = (rng.normal(size=(ts.n_entries, ts.n_features_per_level))
             * 0.1).astype(np.float32)
    pos = _pos(1000, seed=3)
    got = hash_xor.encode_xor_fwd(ts, t(table), t(pos), torch.bfloat16)
    ref = jhg.hash_encode(js, j(table), j(pos), jnp.bfloat16)
    assert got.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    assert _bf16_ulps(got.view(torch.int16).numpy(),
                      np.asarray(ref).view(np.int16)) <= 1
    got32 = hash_xor.encode_xor_fwd(ts, t(table), t(pos))
    ref32 = jhg.hash_encode(js, j(table), j(pos), None)
    np.testing.assert_allclose(n(got32), n(ref32), rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("bf16", [True, False])
def test_table_gradient_against_an_f64_sum(bf16):
    """The table gradient, from the contributions each (sample, level,
    corner) makes as the JAX backward forms them (bf16(bf16(w) * g) in
    bf16, w * g in f32): the port's f32 sum within 1e-5 of the largest
    entry of their f64 sum.  The JAX gradient sums the bf16 contributions in
    bf16 (the cotangent of the bf16 cast through jnp.take), so it is held to
    the f64 sum only at the bound of a sum rounded to bf16 after each of an
    entry's k terms: k * 2^-8 * sum |terms| (twice the unit roundoff);
    in f32 mode at 1e-5 of the largest entry, as the port."""
    js, ts = _specs("f2l4")
    L, F = ts.n_levels, ts.n_features_per_level
    pos = _pos(8000, seed=4)
    rng = np.random.default_rng(5)
    g = rng.normal(size=(pos.shape[0], F * L)).astype(np.float32)
    g = n(t(g).to(torch.bfloat16).float())  # a bf16 cotangent's values
    idx, vals = thg.xor_contributions(ts, t(pos), t(g), bf16)
    ref = np.zeros((ts.n_entries, F), np.float64)
    np.add.at(ref, n(idx), n(vals).astype(np.float64))
    top = np.abs(ref).max()

    got = hash_xor.grad_table_xor(ts, t(pos), t(g), bf16)
    assert np.abs(n(got) - ref).max() <= 1e-5 * top

    dtype = jnp.bfloat16 if bf16 else None
    table = jnp.zeros((ts.n_entries, F), jnp.float32)
    jgrad = np.asarray(jax.grad(lambda tb: jnp.sum(
        jhg.hash_encode(js, tb, j(pos), dtype).astype(jnp.float32)
        * j(g)))(table), np.float64)
    if bf16:
        k = np.zeros(ts.n_entries)
        np.add.at(k, n(idx), 1.0)
        mag = np.zeros((ts.n_entries, F))
        np.add.at(mag, n(idx), np.abs(n(vals)).astype(np.float64))
        err = np.abs(jgrad - ref)
        assert (err <= k[:, None] * 2.0 ** -8 * mag + 1e-30).all()
        assert err.max() > np.abs(n(got) - ref).max()  # bf16 sums lose more
    else:
        assert np.abs(jgrad - ref).max() <= 1e-5 * top


def test_autograd_uses_the_twins_on_cpu():
    """hash_encode_xor is differentiable in the table; on CPU tensors it runs
    the twins and launches nothing."""
    _, ts = _specs("f8l4")
    table = torch.randn((ts.n_entries, 8), generator=torch.Generator()
                        .manual_seed(0)) * 0.1
    pos = t(_pos(500, seed=6))
    counts = (hash_xor.encode_xor_fwd.launches, hash_xor.grad_table_xor.launches)
    tab = table.clone().requires_grad_(True)
    out = hash_xor.hash_encode_xor(ts, tab, pos, torch.bfloat16)
    torch.sin(out.float()).sum().backward()
    g = torch.cos(out.detach().float()).to(torch.bfloat16).float()
    ref = thg.grad_table_xor_plain(ts, pos, g, True)
    assert torch.equal(tab.grad, ref)
    assert (hash_xor.encode_xor_fwd.launches,
            hash_xor.grad_table_xor.launches) == counts
    with pytest.raises(ValueError, match="CPU or CUDA"):
        hash_xor.encode_xor_fwd(ts, table.to("meta"), pos.to("meta"))


def test_hash_func_strings():
    """A hash_func may hold p0, p1, p2, integer literals, ^ * + & | << >>
    and parentheses; it evaluates as the JAX package's uint32 arithmetic
    (shifts by 32 or more give 0) and rewrites to C with the same
    precedence; anything else is refused."""
    exprs = [thg.DEFAULT_HASH_FUNC, CUSTOM, "p0 + p1 * (3 * 7) ^ (p2 << 31)",
             "(p0 << 33) ^ (p1 >> 40) | p2 & 255"]
    rng = np.random.default_rng(7)
    p = [rng.integers(0, 2 ** 32, 2000, dtype=np.uint64).astype(np.uint32)
         for _ in range(3)]
    for expr in exprs:
        got = thg._compile_hash_func(expr)(*[t(x.astype(np.int64)) for x in p])
        ref = jhg._compile_hash_func(expr)(*[j(x) for x in p])
        np.testing.assert_array_equal(n(got), np.asarray(ref).astype(np.int64))
    assert thg._compile_hash_func(thg.DEFAULT_HASH_FUNC).c_expr == \
        "((p0 ^ (p1 * 19349663u)) ^ (p2 * 83492791u))"
    assert thg._compile_hash_func("p0 << 3 >> 1").c_expr == \
        "jn_shr(jn_shl(p0, 3u), 1u)"
    for bad in ["p0 - p1", "p3 ^ p0", "abs(p0)", "p0 ^ 1.5", "-p0", "p0 ^",
                "p0 * (1 << 40)", "p0 ^ 2654435761 * 3", "p0 if p1 else p2"]:
        with pytest.raises(ValueError, match="hash_func"):
            thg._compile_hash_func(bad)
    spec = thg.HashGridSpec(hash_func="p0 % 7", n_levels=2)  # checked at use
    with pytest.raises(ValueError, match="hash_func"):
        thg.hash_grid_indices(spec, torch.zeros((1, 3)))

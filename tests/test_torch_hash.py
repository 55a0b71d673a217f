"""Hash-grid encode of the PyTorch port against the JAX package.

The port's forward (kernel F's plain twin on the CPU) and table gradient
(kernel B's plain twin) are held against `jnerf_tpu/ops/hash_nbr.py`: the
forward against ``hash_encode_nbr``, the gradient against the Pallas
backward in interpret mode (f32 upstream gradient, as the kernels take it)
and against the XLA adjoint that the JAX package runs on the CPU.  The
CUDA kernels themselves are checked on the card by tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from jnerf_tpu.ops import hash_nbr as jnbr
from jnerf_tpu.ops.hash_grid import HashGridSpec as JaxSpec
from jnerf_tpu.ops.hash_grid_rows import _corner_offsets as jax_corner_offsets
from jnerf_tpu.ops.hash_grid_rows import level_multipliers as jax_multipliers
from jnerf_tpu_torch.ops import hash_nbr as tnbr
from jnerf_tpu_torch.ops.hash_grid import (
    HashGridSpec, _corner_offsets, level_multipliers,
)
from torch_parity import both_cfgs, j, n, t  # noqa: F401

# (L, F, log2 size, desired resolution, cap): dense + pow2 hashed levels
# at F=2 and F=8, and a non-pow2 cap whose hashed levels take a real
# modulo (the same path as the dense levels' res^3 sizes).
SPECS = {
    "f2l4": (4, 2, 10, 64.0, None),
    "f8l4": (4, 8, 13, 256.0, None),
    "f8l4cap3000": (4, 8, 12, 256.0, 3000),
}


def _kw(name):
    L, F, log2, des, cap = SPECS[name]
    return dict(n_levels=L, n_features_per_level=F, base_resolution=4,
                log2_hashmap_size=log2, desired_resolution=des,
                max_level_size=cap)


def _inputs(spec, n_samples=1024, seed=0):
    """Table ~N(0, 0.1), positions in [0, 1] with 64 of them placed on a
    level-1 cell border (where an FMA would move them to the neighbour)."""
    rng = np.random.default_rng(seed)
    F = spec.n_features_per_level
    table = (rng.normal(size=(spec.n_entries, F)) * 0.1).astype(np.float32)
    pos = rng.uniform(size=(n_samples, 3)).astype(np.float32)
    s = np.float32(spec.scales[1])
    pos[:64] = (np.floor(pos[:64] * s + 0.5) - 0.5) / s
    pos = np.clip(pos, 0.0, 1.0).astype(np.float32)
    g = rng.normal(size=(n_samples, F * spec.n_levels)).astype(np.float32)
    return table, pos, g


@pytest.mark.parametrize("name", list(SPECS))
def test_spec_geometry_matches_jax(name):
    """Identical derived geometry, hash multipliers and corner offsets:
    the rng draw order is part of the table layout."""
    ts, js = HashGridSpec(**_kw(name)), JaxSpec(**_kw(name))
    for field in ("scales", "resolutions", "level_sizes", "level_offsets",
                  "n_entries", "per_level_scale"):
        assert getattr(ts, field) == getattr(js, field), field
    assert level_multipliers(ts) == jax_multipliers(js)
    np.testing.assert_array_equal(_corner_offsets(ts), jax_corner_offsets(js))


def test_init_table_range():
    spec = HashGridSpec(**_kw("f2l4"))
    tab = spec.init_table(torch.Generator().manual_seed(0))
    assert tab.shape == (spec.n_entries, 2) and tab.dtype == torch.float32
    assert float(tab.abs().max()) <= 1e-4


@pytest.mark.parametrize("name", list(SPECS))
def test_forward_matches_jax(name):
    """Same base entries (exactly: 0 mismatches, border samples included)
    and the same encoding.  Both round each weighted corner value to bf16
    and sum in f32; only the summation order differs (JAX's assembly
    matmul vs a corner loop), so atol 1e-6 on values of order 0.3."""
    ts, js = HashGridSpec(**_kw(name)), JaxSpec(**_kw(name))
    table, pos, _ = _inputs(ts)
    e0_jax = n(jnbr._entry_indices(js, jnp.asarray(pos))[0])
    e0 = torch.zeros((pos.shape[0], ts.n_levels), dtype=torch.int32)
    out = tnbr.encode_fwd(ts, t(table), t(pos), e0_out=e0)
    assert int((n(e0) != e0_jax).sum()) == 0
    ref = n(jnbr.hash_encode_nbr(js, jnp.asarray(table), jnp.asarray(pos)))
    np.testing.assert_allclose(n(out), ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", list(SPECS))
def test_forward_bf16_matches_jax(name):
    """The encoder in the network's compute dtype, bf16: kernel F writes
    bf16 itself on the card, and on the CPU encode_fwd's bf16 output is the
    f32 twin's rounded.  It equals the JAX encoder's bf16 output
    (``compute_dtype=jnp.bfloat16``, an f32 sum cast) at the f32 test's
    atol 1e-6."""
    ts, js = HashGridSpec(**_kw(name)), JaxSpec(**_kw(name))
    table, pos, _ = _inputs(ts)
    direct = tnbr.encode_fwd(ts, t(table), t(pos), out_dtype=torch.bfloat16)
    f32 = tnbr.encode_fwd(ts, t(table), t(pos))
    assert direct.dtype == torch.bfloat16
    assert torch.equal(direct, f32.to(torch.bfloat16))
    out = tnbr.hash_encode_nbr(ts, t(table), t(pos), torch.bfloat16)
    assert out.dtype == torch.bfloat16 and torch.equal(out, direct)
    ref = jnbr.hash_encode_nbr(js, jnp.asarray(table), jnp.asarray(pos),
                               jnp.bfloat16)
    assert ref.dtype == jnp.bfloat16
    np.testing.assert_allclose(n(out.float()), n(ref.astype(jnp.float32)),
                               rtol=0, atol=1e-6)


def _clustered(n_samples=1024, n_rays=8, seed=3):
    """Samples as a training step feeds kernel B: runs of consecutive
    samples along a few rays (128 each, sqrt(3)/1024 apart, as the march
    steps) that start inside a small ball, so that consecutive samples
    share the coarse levels' cells."""
    rng = np.random.default_rng(seed)
    per = n_samples // n_rays
    start = 0.5 + rng.uniform(-0.1, 0.1, size=(n_rays, 1, 3))
    dirs = rng.normal(size=(n_rays, 1, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    t = np.arange(per)[None, :, None] * (np.sqrt(3.0) / 1024)
    return np.clip(start + t * dirs, 0.0, 1.0).reshape(-1, 3).astype(np.float32)


@pytest.mark.parametrize(
    "name,samples",
    [pytest.param(k, "uniform", id=k) for k in SPECS]
    + [pytest.param(k, "clustered", id=f"{k}-clustered") for k in SPECS])
def test_grad_table_matches_pallas_interpret(name, samples):
    """Table gradient against the TPU kernels (#1-#3, run in interpret
    mode) on the same f32 upstream gradient, on uniform samples and on
    clustered ones (runs along rays: the inputs on which many
    contributions land on the same entries).  Both sum w_c * g in f32;
    only the order of the sums differs, which moves an entry by a few f32
    ulps of the sum of its terms' magnitudes (up to ~100 uniform, ~1000
    clustered): rtol 1e-4, atol 5e-5 on gradients of order 10."""
    ts, js = HashGridSpec(**_kw(name)), JaxSpec(**_kw(name))
    _, pos, g = _inputs(ts)
    if samples == "clustered":
        pos = _clustered(pos.shape[0])
    ref = n(jnbr._grad_table_pallas(js, jnp.asarray(pos), jnp.asarray(g),
                                    interpret=True))
    got = n(tnbr.grad_table(ts, t(pos), t(g)))
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=5e-5)


# The headline's table and the f2l16 ones of the bench (level caps 2^18
# and 2^19), with their entry counts.
BENCH_SPECS = {
    "f8l4@2^19": (dict(n_levels=4, n_features_per_level=8,
                       log2_hashmap_size=19, max_level_size=1 << 19),
                  1_576_960),
    "f2l16@2^18": (dict(n_levels=16, n_features_per_level=2,
                        log2_hashmap_size=19, max_level_size=1 << 18),
                   3_214_536),
    "f2l16@2^19": (dict(n_levels=16, n_features_per_level=2,
                        log2_hashmap_size=19, max_level_size=1 << 19),
                   None),
}


@pytest.mark.parametrize("name", list(BENCH_SPECS))
def test_bench_spec_geometry_matches_jax(name):
    """The tables that kernel B is timed on: the same level sizes, offsets,
    scales, hash multipliers and corner offsets as the JAX package's, and
    the entry counts behind chip_smoke.py's byte counts."""
    kw, n_entries = BENCH_SPECS[name]
    ts, js = HashGridSpec(**kw), JaxSpec(**kw)
    for field in ("scales", "resolutions", "level_sizes", "level_offsets",
                  "n_entries"):
        assert getattr(ts, field) == getattr(js, field), field
    assert level_multipliers(ts) == jax_multipliers(js)
    np.testing.assert_array_equal(_corner_offsets(ts), jax_corner_offsets(js))
    if n_entries is not None:
        assert ts.n_entries == n_entries


@pytest.mark.parametrize("name", ["f2l4", "f8l4"])
def test_autograd_matches_jax_autodiff(name):
    """d/dtable of sum(sin(encode)) through the port's autograd.Function
    against JAX autodiff, which on the CPU takes the XLA adjoint: that
    rounds the upstream gradient to bf16, so the JAX tests' own 5e-2 /
    5e-3 apply.  The port's gradient also equals kernel B's twin on the
    same upstream gradient exactly."""
    ts, js = HashGridSpec(**_kw(name)), JaxSpec(**_kw(name))
    table, pos, _ = _inputs(ts)
    ref = n(jax.grad(lambda tb: jnp.sum(jnp.sin(
        jnbr.hash_encode_nbr(js, tb, jnp.asarray(pos)))))(jnp.asarray(table)))

    tab = t(table).requires_grad_(True)
    out = tnbr.hash_encode_nbr(ts, tab, t(pos))
    torch.sin(out).sum().backward()
    np.testing.assert_allclose(n(tab.grad), ref, rtol=5e-2, atol=5e-3)
    direct = tnbr.grad_table(ts, t(pos), torch.cos(out.detach()))
    np.testing.assert_array_equal(n(tab.grad), n(direct))


def test_compute_dtype_and_no_grad_path():
    """compute_dtype casts the output; without grad the forward runs
    alone and gives the same values."""
    ts = HashGridSpec(**_kw("f2l4"))
    table, pos, _ = _inputs(ts)
    tab = t(table).requires_grad_(True)
    out = tnbr.hash_encode_nbr(ts, tab, t(pos), torch.bfloat16)
    assert out.dtype == torch.bfloat16 and out.requires_grad
    with torch.no_grad():
        plain = tnbr.hash_encode_nbr(ts, tab, t(pos))
    assert not plain.requires_grad
    np.testing.assert_array_equal(n(out.float()), n(plain.to(torch.bfloat16).float()))


def test_wrappers_raise_off_cpu_and_cuda():
    """A wrapper runs its plain twin only for CPU tensors; any other
    device that is not CUDA is refused, never computed some other way."""
    ts = HashGridSpec(**_kw("f2l4"))
    pos = torch.zeros((8, 3), device="meta")
    tab = torch.zeros((ts.n_entries, 2), device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tnbr.encode_fwd(ts, tab, pos)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tnbr.grad_table(ts, pos, torch.zeros((8, 8), device="meta"))


def test_hash_encoder_module(both_cfgs):
    """HashEncoder keeps the JAX fast-cap default and refuses 'xor'."""
    from jnerf_tpu_torch.models.position_encoders import HashEncoder

    enc = HashEncoder(n_levels=4, n_features_per_level=2, log2_hashmap_size=19)
    assert enc.spec.level_sizes[-1] == 1 << 18  # (8 MB) // (8 * 2 * 2)
    enc8 = HashEncoder(n_levels=4, n_features_per_level=8, log2_hashmap_size=19)
    assert max(enc8.spec.level_sizes) == 1 << 16
    both_cfgs[1].hashmap_fast_cap = 1 << 19
    assert max(HashEncoder(n_levels=4, n_features_per_level=8,
                           log2_hashmap_size=19).spec.level_sizes) == 1 << 19
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        HashEncoder(indexing="xor")

"""The port's CUDA kernels against their plain PyTorch twins, on the card.

These tests need an NVIDIA GPU and nvcc and skip elsewhere.  The machine
with the card has no JAX, and tests/conftest.py imports it, so run them
there without the conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

This file imports torch and the port only.
"""

import numpy as np
import pytest
import torch

from jnerf_tpu_torch.ops import fused_mlp, hash_nbr
from jnerf_tpu_torch.ops.hash_grid import HashGridSpec

pytestmark = pytest.mark.cuda

# (L, F, log2 size, desired resolution, cap): dense + pow2 hashed levels,
# F in {1, 2, 4, 8}, and a non-pow2 cap (hashed levels take a real modulo).
SPECS = {
    "f1l8": (8, 1, 12, 512.0, None),
    "f2l4": (4, 2, 10, 64.0, None),
    "f4l8": (8, 4, 13, 512.0, None),
    "f8l4": (4, 8, 13, 256.0, None),
    "f8l4cap3000": (4, 8, 12, 256.0, 3000),
}


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _spec(name):
    L, F, log2, des, cap = SPECS[name]
    return HashGridSpec(n_levels=L, n_features_per_level=F, base_resolution=4,
                        log2_hashmap_size=log2, desired_resolution=des,
                        max_level_size=cap)


def _inputs(spec, dev, n=4096, seed=0):
    """Table ~N(0, 0.1); positions in [0, 1], 256 of them on a level-1 cell
    border (where an FMA would move them to the neighbouring cell)."""
    rng = np.random.default_rng(seed)
    F, L = spec.n_features_per_level, spec.n_levels
    table = (rng.normal(size=(spec.n_entries, F)) * 0.1).astype(np.float32)
    pos = rng.uniform(size=(n, 3)).astype(np.float32)
    s = np.float32(spec.scales[1])
    pos[:256] = (np.floor(pos[:256] * s + 0.5) - 0.5) / s
    pos = np.clip(pos, 0.0, 1.0).astype(np.float32)
    g = rng.normal(size=(n, F * L)).astype(np.float32)
    return tuple(torch.from_numpy(x).to(dev) for x in (table, pos, g))


@pytest.mark.parametrize("name", list(SPECS))
def test_kernels_match_plain(dev, name):
    """Kernel F equals its twin but for a rare bf16 rounding flip of one
    corner product (atol 1e-3 at |table| ~ 0.1), with 0 base-entry
    mismatches; kernel B agrees up to the atomics' summation order (1e-5
    of the largest gradient)."""
    spec = _spec(name)
    table, pos, g = _inputs(spec, dev)
    e0k = torch.zeros((pos.shape[0], spec.n_levels), dtype=torch.int32,
                      device=dev)
    e0p = torch.zeros_like(e0k)
    fk = hash_nbr.encode_fwd(spec, table, pos, e0_out=e0k)
    fp = hash_nbr.hash_encode_plain(spec, table, pos, e0_out=e0p)
    bk = hash_nbr.grad_table(spec, pos, g)
    bp = hash_nbr.grad_table_plain(spec, pos, g)
    torch.cuda.synchronize()
    assert int((e0k != e0p).sum()) == 0
    assert float((fk - fp).abs().max()) <= 1e-3
    assert float((bk - bp).abs().max()) <= 1e-5 * float(bp.abs().max())


# The headline's table and the f2l16 one that the bench times at 2^18.
BIG_SPECS = {
    "f8l4@2^19": dict(n_levels=4, n_features_per_level=8,
                      log2_hashmap_size=19, max_level_size=1 << 19),
    "f2l16@2^18": dict(n_levels=16, n_features_per_level=2,
                       log2_hashmap_size=19, max_level_size=1 << 18),
}


def _clustered(n, dev, n_rays=64, seed=0):
    """Samples as a training step feeds kernel B: runs of consecutive
    samples along rays (sqrt(3)/1024 apart, as the march steps) that start
    inside a small ball, so a warp's samples share the coarse cells; n need
    not divide into the rays."""
    rng = np.random.default_rng(seed)
    per = -(-n // n_rays)
    start = 0.5 + rng.uniform(-0.1, 0.1, size=(n_rays, 1, 3))
    dirs = rng.normal(size=(n_rays, 1, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    t = np.arange(per)[None, :, None] * (np.sqrt(3.0) / 1024)
    pos = np.clip(start + t * dirs, 0.0, 1.0).reshape(-1, 3)[:n]
    return torch.from_numpy(pos.astype(np.float32)).to(dev)


@pytest.mark.parametrize("n", [1 << 17, 100_003])
@pytest.mark.parametrize("name", list(BIG_SPECS))
def test_grad_table_clustered_matches_plain(dev, name, n):
    """Kernel B on clustered samples (the inputs that contend on the
    coarse levels' entries), at the headline's shapes and at a ragged N
    (a part-empty last block): within the atomics' summation order (1e-5
    of the largest gradient) of its twin."""
    spec = HashGridSpec(**BIG_SPECS[name])
    L, F = spec.n_levels, spec.n_features_per_level
    pos = _clustered(n, dev)
    g = torch.randn((n, F * L), generator=torch.Generator(dev).manual_seed(1),
                    device=dev)
    ref = hash_nbr.grad_table_plain(spec, pos, g)
    got = hash_nbr.grad_table(spec, pos, g)
    torch.cuda.synchronize()
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


@pytest.mark.parametrize("samples", ["uniform", "clustered"])
@pytest.mark.parametrize("name", list(BIG_SPECS))
def test_encode_bf16_is_f32_rounded(dev, name, samples):
    """Kernel F writing bf16 (the encoder's compute dtype on the path)
    gives, bit for bit, its f32 output rounded to bf16; the f32 output
    matches the twin (0 base-entry mismatches, atol 1e-3 as above), on
    uniform samples and on runs along rays, at a ragged N."""
    spec = HashGridSpec(**BIG_SPECS[name])
    n = 100_003
    gen = torch.Generator(dev).manual_seed(2)
    pos = (torch.rand((n, 3), generator=gen, device=dev)
           if samples == "uniform" else _clustered(n, dev))
    table = torch.randn((spec.n_entries, spec.n_features_per_level),
                        generator=gen, device=dev) * 0.1
    e0k = torch.zeros((n, spec.n_levels), dtype=torch.int32, device=dev)
    e0p = torch.zeros_like(e0k)
    f32 = hash_nbr.encode_fwd(spec, table, pos, e0_out=e0k)
    b16 = hash_nbr.encode_fwd(spec, table, pos, out_dtype=torch.bfloat16)
    ref = hash_nbr.hash_encode_plain(spec, table, pos, e0_out=e0p)
    torch.cuda.synchronize()
    assert b16.dtype == torch.bfloat16 and b16.shape == f32.shape
    assert torch.equal(b16, f32.to(torch.bfloat16))
    assert int((e0k != e0p).sum()) == 0
    assert float((f32 - ref).abs().max()) <= 1e-3


def test_autograd_goes_through_both_kernels(dev):
    """The autograd.Function launches kernel F forward and kernel B
    backward, and its table gradient matches the twin's on the upstream
    gradient that reaches it: cos(out), rounded to bf16 by the backward of
    the bf16 cast."""
    spec = _spec("f8l4")
    table, pos, _ = _inputs(spec, dev)
    f0, b0 = hash_nbr.encode_fwd.launches, hash_nbr.grad_table.launches
    tab = table.clone().requires_grad_(True)
    out = hash_nbr.hash_encode_nbr(spec, tab, pos, torch.bfloat16)
    torch.sin(out.float()).sum().backward()
    assert hash_nbr.encode_fwd.launches == f0 + 1
    assert hash_nbr.grad_table.launches == b0 + 1
    g = torch.cos(out.detach().float()).to(torch.bfloat16).float()
    ref = hash_nbr.grad_table_plain(spec, pos, g)
    assert float((tab.grad - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


def test_wrappers_refuse_bad_inputs(dev):
    """A CUDA tensor the kernel cannot take raises; it is never computed
    another way."""
    spec = _spec("f2l4")
    table, pos, g = _inputs(spec, dev)
    with pytest.raises(ValueError):
        hash_nbr.encode_fwd(spec, table.double(), pos)
    with pytest.raises(ValueError):
        hash_nbr.encode_fwd(spec, table, pos.t().contiguous().t())
    with pytest.raises(ValueError):
        hash_nbr.grad_table(spec, pos, g[:, :3].contiguous())
    f6 = HashGridSpec(n_levels=2, n_features_per_level=6, log2_hashmap_size=10)
    with pytest.raises(ValueError, match="F in"):
        hash_nbr.encode_fwd(f6, torch.zeros((f6.n_entries, 6), device=dev), pos)


def _mlp_inputs(dev, n, seed=0):
    """Kaiming-uniform weights, features ~U(-1, 1), g ~N(0, 1)."""
    gen = torch.Generator(dev).manual_seed(seed)
    ws = [(torch.rand(s, generator=gen, device=dev) * 2 - 1)
          * np.sqrt(6.0 / s[0]) for s in fused_mlp.WEIGHT_SHAPES]
    x = torch.rand((n, 32), generator=gen, device=dev) * 2 - 1
    d = torch.rand((n, 16), generator=gen, device=dev) * 2 - 1
    g = torch.randn((n, 4), generator=gen, device=dev)
    return ws, x, d, g


# Row counts: one block of the JAX package, a ragged count, and one that
# leaves the last 128-row tile of the backward partly empty.
@pytest.mark.parametrize("n", [8192, 5000, 70000])
def test_fused_mlp_kernels_match_plain(dev, n):
    """F-MLP, B-MLP and D-MLP against their twins: the same bf16 rounding
    points and f32 sums in another order, so atol 1e-5 on the outputs and
    dx and 1e-5 of each weight gradient's largest entry (a dropped bf16
    rounding was off by 1.3e-2 or more).  B-MLP sums on the tensor cores
    and re-sums, in the twin's order, the few sums that lie at a bf16
    rounding boundary or at zero, so it rounds and masks as the twin does
    and the same bounds hold.  B-MLP sums in a fixed order: two runs are
    equal bit for bit.  bf16 feature rows, as the network feeds them, give
    what their f32 originals give."""
    ws, x, d, g = _mlp_inputs(dev, n)
    out = fused_mlp.fused_mlp_fwd(ws, x, d)
    ref = fused_mlp.fused_ngp_mlp_plain(ws, x, d)
    dws, dx = fused_mlp.fused_mlp_bwd(ws, x, d, g)
    dws2, dx2 = fused_mlp.fused_mlp_bwd(ws, x, d, g)
    rdws, rdx = fused_mlp.fused_ngp_mlp_bwd_plain(ws, x, d, g)
    den = fused_mlp.fused_density_mlp(ws[0], ws[1], x)
    rden = fused_mlp.fused_density_mlp_plain(ws[0], ws[1], x)
    out_bf = fused_mlp.fused_mlp_fwd(ws, x.bfloat16(), d.bfloat16())
    torch.cuda.synchronize()
    assert float((out - ref).abs().max()) <= 1e-5
    assert float((dx - rdx).abs().max()) <= 1e-5
    for got, want in zip(dws, rdws):
        assert got.shape == want.shape
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    assert torch.equal(dx, dx2)
    assert all(torch.equal(a, b) for a, b in zip(dws, dws2))
    assert den.shape == (n, 1)
    assert float((den - rden).abs().max()) <= 1e-5
    assert torch.equal(out_bf, out)


@pytest.mark.parametrize("n", [8192, 5000, 70000, 100_003, 1 << 20])
def test_fmlp_matches_plain_and_repeats(dev, n):
    """F-MLP on the tensor cores against its twin at the training and
    render shapes and at ragged counts (a part-empty last 16-row tile):
    atol 1e-5, as above, and two runs equal bit for bit."""
    ws, x, d, _ = _mlp_inputs(dev, n, seed=3)
    x, d = x.bfloat16(), d.bfloat16()
    out = fused_mlp.fused_mlp_fwd(ws, x, d)
    out2 = fused_mlp.fused_mlp_fwd(ws, x, d)
    ref = fused_mlp.fused_ngp_mlp_plain(ws, x, d)
    torch.cuda.synchronize()
    assert out.shape == (n, 4)
    assert float((out - ref).abs().max()) <= 1e-5
    assert torch.equal(out, out2)


@pytest.mark.parametrize("n", [8192, 5000, 70000, 100_003, 1 << 20])
def test_dmlp_matches_plain_and_repeats(dev, n):
    """D-MLP, F-MLP's density half on the tensor cores, against its twin at
    F-MLP's row counts: atol 1e-5, as above, and two runs equal bit for
    bit."""
    ws, x, _, _ = _mlp_inputs(dev, n, seed=4)
    x = x.bfloat16()
    out = fused_mlp.fused_density_mlp(ws[0], ws[1], x)
    out2 = fused_mlp.fused_density_mlp(ws[0], ws[1], x)
    ref = fused_mlp.fused_density_mlp_plain(ws[0], ws[1], x)
    torch.cuda.synchronize()
    assert out.shape == (n, 1)
    assert float((out - ref).abs().max()) <= 1e-5
    assert torch.equal(out, out2)


def test_fused_autograd_goes_through_both_kernels(dev):
    """FusedNGPMLP launches F-MLP forward and B-MLP backward; dir_feat
    gets no gradient; the gradients equal B-MLP's on the same g."""
    ws, x, d, g = _mlp_inputs(dev, 8192, seed=1)
    f0, b0 = fused_mlp.fused_mlp_fwd.launches, fused_mlp.fused_mlp_bwd.launches
    wr = [w.clone().requires_grad_(True) for w in ws]
    xr, dr = x.clone().requires_grad_(True), d.clone().requires_grad_(True)
    (fused_mlp.fused_ngp_mlp(wr, xr, dr) * g).sum().backward()
    assert fused_mlp.fused_mlp_fwd.launches == f0 + 1
    assert fused_mlp.fused_mlp_bwd.launches == b0 + 1
    assert dr.grad is None
    dws, dx = fused_mlp.fused_mlp_bwd(ws, x, d, g)
    assert torch.equal(xr.grad, dx)
    assert all(torch.equal(w.grad, dw) for w, dw in zip(wr, dws))


def test_fused_wrappers_refuse_bad_inputs(dev):
    """A CUDA tensor the kernels cannot take raises."""
    ws, x, d, g = _mlp_inputs(dev, 256)
    with pytest.raises(ValueError):
        fused_mlp.fused_mlp_fwd(ws, x.double(), d)
    with pytest.raises(ValueError):
        fused_mlp.fused_mlp_fwd(ws, x[:, :16], d)
    with pytest.raises(ValueError):
        fused_mlp.fused_mlp_bwd(ws, x, d, g[:, :3])
    with pytest.raises(ValueError):
        fused_mlp.fused_density_mlp(ws[0], ws[1], x.cpu().to(dev)[:-1].T)
    with pytest.raises(ValueError):
        fused_mlp.fused_mlp_fwd(ws[:4] + [ws[0]], x, d)

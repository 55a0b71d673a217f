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

from jnerf_tpu_torch.ops import envelope, fused_mlp, hash_grid, hash_nbr, hash_xor
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
    # 5 entries a level: the corners of one cell share entries
    "f4l2cap5": (2, 4, 10, 16.0, 5),
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


def _twin_grad(spec, pos, g, xor=False, bf16=False):
    """Kernel B's twin on CPU copies (on CUDA tensors index_add_ adds with
    atomics, in no fixed order)."""
    if xor:
        return hash_grid.grad_table_xor_plain(spec, pos.cpu(), g.cpu(), bf16)
    return hash_nbr.grad_table_plain(spec, pos.cpu(), g.cpu())


@pytest.mark.parametrize("name", list(SPECS))
def test_kernels_match_plain(dev, name):
    """Kernel F equals its twin but for a rare bf16 rounding flip of one
    corner product (atol 1e-3 at |table| ~ 0.1), with 0 base-entry
    mismatches; kernel B equals its twin (on CPU copies) bit for bit."""
    spec = _spec(name)
    table, pos, g = _inputs(spec, dev)
    e0k = torch.zeros((pos.shape[0], spec.n_levels), dtype=torch.int32,
                      device=dev)
    e0p = torch.zeros_like(e0k)
    fk = hash_nbr.encode_fwd(spec, table, pos, e0_out=e0k)
    fp = hash_nbr.hash_encode_plain(spec, table, pos, e0_out=e0p)
    bk = hash_nbr.grad_table(spec, pos, g)
    torch.cuda.synchronize()
    assert int((e0k != e0p).sum()) == 0
    assert float((fk - fp).abs().max()) <= 1e-3
    assert torch.equal(bk.cpu(), _twin_grad(spec, pos, g))


RAGGED_B = 100_003

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
    """Kernel B on clustered samples (the inputs whose coarse levels'
    rows take thousands of contributions) with a fifth of the slots empty
    (one position, g zero), at the headline's shapes and at a ragged N:
    equal to its twin on CPU copies, and to a second launch, bit for
    bit."""
    spec = HashGridSpec(**BIG_SPECS[name])
    L, F = spec.n_levels, spec.n_features_per_level
    pos = _clustered(n, dev)
    g = torch.randn((n, F * L), generator=torch.Generator(dev).manual_seed(1),
                    device=dev)
    pos[-n // 5:] = 0.5  # empty slots, as compaction leaves them
    g[-n // 5:] = 0.0
    got = hash_nbr.grad_table(spec, pos, g)
    assert torch.equal(got, hash_nbr.grad_table(spec, pos, g))
    assert torch.equal(got.cpu(), _twin_grad(spec, pos, g))


@pytest.mark.parametrize("samples", ["uniform", "clustered"])
@pytest.mark.parametrize("name", list(BIG_SPECS))
def test_grad_table_sort_is_the_plain_plan(dev, name, samples):
    """Kernel B's sort (linear and xor), at a ragged N: every row's first
    position and every sorted item equal the plain plan's, a stable sort
    of each level's items by entry (a tenth of the samples empty slots,
    their g all zero, sorted last)."""
    spec = HashGridSpec(**BIG_SPECS[name])
    n = 100_003
    gen = torch.Generator(dev).manual_seed(4)
    pos = (torch.rand((n, 3), generator=gen, device=dev)
           if samples == "uniform" else _clustered(n, dev))
    g = torch.randn((n, spec.n_features_per_level * spec.n_levels),
                    generator=gen, device=dev)
    g[-n // 10:] = 0.0
    pc, gc = pos.cpu(), g.cpu()
    for got, want in ((hash_nbr.grad_table_plan(spec, pos, g),
                       hash_nbr.grad_table_plan_plain(spec, pc, gc)),
                      (hash_xor.grad_table_xor_plan(spec, pos, g),
                       hash_nbr.grad_table_plan_plain(spec, pc, gc,
                                                      xor=True))):
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("xor", [False, True])
@pytest.mark.parametrize("name,n", [("f8l4", RAGGED_B), ("f4l2cap5", 37),
                                    ("f2l4", 1)])
def test_grad_table_writes_inside_its_buffers(dev, name, n, xor):
    """Kernel B launched on a work space and a gradient with guard zones
    on both sides: the guards stay as they were and the gradient equals
    the twin, at a ragged N, at 37 samples on a level of 5 entries and
    at one sample."""
    spec = _spec(name)
    _, pos, g = _inputs(spec, dev, n=max(n, 256))
    pos, g = pos[:n].contiguous(), g[:n].contiguous()
    L, F = spec.n_levels, spec.n_features_per_level
    pad, bufs = 4096, []

    def guarded(size, dtype):
        buf = torch.full((size + 2 * pad,), -7, dtype=dtype, device=dev)
        bufs.append(buf)
        return buf[pad:pad + size]

    work = guarded(hash_nbr.bwd_layout(spec, n, xor)[0], torch.int32)
    grad = guarded(spec.n_entries * F, torch.float32)
    if xor:
        c = hash_xor.xor_consts(spec)
        hash_xor._bwd_launch(spec.hash_func)(
            dev.index or 0, pos.data_ptr(), g.data_ptr(), grad.data_ptr(),
            work.data_ptr(), n, L, F, 1, c.scales.ctypes.data,
            c.mults.ctypes.data, c.sizes.ctypes.data, c.offsets.ctypes.data,
            c.hashed.ctypes.data, 0)
    else:
        hash_nbr._HASH_BWD(
            dev.index or 0, pos.data_ptr(), g.data_ptr(), grad.data_ptr(),
            work.data_ptr(), n, L, F,
            *hash_nbr._const_ptrs(hash_nbr.level_consts(spec)), 0)
    torch.cuda.synchronize()
    for buf in bufs:
        assert bool((buf[:pad] == -7).all() and (buf[-pad:] == -7).all())
    assert torch.equal(grad.view(-1, F).cpu(),
                       _twin_grad(spec, pos, g, xor=xor, bf16=True))


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
    assert torch.equal(tab.grad.cpu(), _twin_grad(spec, pos, g))


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


# Xor mode at the reference's sizes: dense levels with a real modulo,
# power-of-two hashed levels, a non-power-of-two cap, F in {1, 2, 4, 8}.
XOR_SPECS = {
    "f2l16@2^12": dict(n_levels=16, n_features_per_level=2,
                       log2_hashmap_size=12),
    "f1l8": dict(n_levels=8, n_features_per_level=1, log2_hashmap_size=12,
                 base_resolution=4, desired_resolution=512.0),
    "f4l8cap3000": dict(n_levels=8, n_features_per_level=4,
                        log2_hashmap_size=13, base_resolution=4,
                        desired_resolution=512.0, max_level_size=3000),
    "f8l4": dict(n_levels=4, n_features_per_level=8, log2_hashmap_size=13,
                 base_resolution=4, desired_resolution=256.0),
}
CUSTOM_HASH = "(p0 * 73856093) ^ (p1 << 5) + (p2 >> 1) * 19349663 | 7"


def _bf16_ulps(a, b):
    def line(x):
        bits = x.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)

    return int((line(a) - line(b)).abs().max())


@pytest.mark.parametrize("hash_func", ["default", "custom"])
@pytest.mark.parametrize("name", list(XOR_SPECS))
def test_xor_kernels_match_plain(dev, name, hash_func):
    """Kernels F and B in xor mode against their twins, on positions in and
    just outside [0, 1] (where the f32 -> uint32 conversion saturates) and
    on cell borders, with the default hash and a custom one (its own
    library): the bf16 forward within one bf16 ulp and 1e-3, the f32
    forward within 1e-3, the table gradient (bf16 products and f32) equal
    to its twin on CPU copies and to a second launch, at a ragged N."""
    kw = dict(XOR_SPECS[name])
    if hash_func == "custom":
        kw["hash_func"] = CUSTOM_HASH
    spec = HashGridSpec(**kw)
    table, pos, g = _inputs(spec, dev, n=5003)
    pos[-300:] = pos[-300:] * 1.2 - 0.1
    for dtype in (torch.bfloat16, torch.float32):
        got = hash_xor.encode_xor_fwd(spec, table, pos, dtype)
        ref = hash_grid.hash_encode_xor_plain(spec, table, pos, dtype)
        assert got.dtype == dtype and got.shape == ref.shape
        assert float((got.float() - ref.float()).abs().max()) <= 1e-3
        if dtype == torch.bfloat16:
            assert _bf16_ulps(got, ref) <= 1
    for rnd in (True, False):
        got = hash_xor.grad_table_xor(spec, pos, g, rnd)
        assert torch.equal(got, hash_xor.grad_table_xor(spec, pos, g, rnd))
        assert torch.equal(got.cpu(), _twin_grad(spec, pos, g, True, rnd))


def test_xor_flagship_table_on_clustered_samples(dev):
    """The flagship xor table (6,098,120 entries) on 2^17 samples in runs
    along rays: the kernels against their twins, as above."""
    spec = HashGridSpec(n_levels=16, n_features_per_level=2,
                        log2_hashmap_size=19)
    assert spec.n_entries == 6_098_120
    n = 1 << 17
    pos = _clustered(n, dev)
    gen = torch.Generator(dev).manual_seed(3)
    table = torch.randn((spec.n_entries, 2), generator=gen, device=dev) * 0.1
    g = torch.randn((n, 32), generator=gen, device=dev)
    got = hash_xor.encode_xor_fwd(spec, table, pos, torch.bfloat16)
    ref = hash_grid.hash_encode_xor_plain(spec, table, pos, torch.bfloat16)
    assert _bf16_ulps(got, ref) <= 1
    got = hash_xor.grad_table_xor(spec, pos, g, True)
    assert torch.equal(got.cpu(), _twin_grad(spec, pos, g, True, True))


def test_xor_autograd_goes_through_both_kernels(dev):
    """The xor autograd.Function launches kernel F forward and kernel B
    backward (and no linear kernel), with the twin's gradient on the
    upstream gradient that reaches it."""
    spec = HashGridSpec(**XOR_SPECS["f8l4"])
    table, pos, _ = _inputs(spec, dev)
    counts = (hash_xor.encode_xor_fwd.launches, hash_xor.grad_table_xor.launches,
              hash_nbr.encode_fwd.launches, hash_nbr.grad_table.launches)
    tab = table.clone().requires_grad_(True)
    out = hash_xor.hash_encode_xor(spec, tab, pos, torch.bfloat16)
    torch.sin(out.float()).sum().backward()
    assert (hash_xor.encode_xor_fwd.launches, hash_xor.grad_table_xor.launches,
            hash_nbr.encode_fwd.launches, hash_nbr.grad_table.launches) == (
        counts[0] + 1, counts[1] + 1, counts[2], counts[3])
    g = torch.cos(out.detach().float()).to(torch.bfloat16).float()
    assert torch.equal(tab.grad.cpu(), _twin_grad(spec, pos, g, True, True))


def test_xor_wrappers_refuse_bad_inputs(dev):
    """As the linear wrappers: a CUDA tensor the kernel cannot take
    raises."""
    spec = HashGridSpec(**XOR_SPECS["f2l16@2^12"])
    table, pos, g = _inputs(spec, dev)
    with pytest.raises(ValueError):
        hash_xor.encode_xor_fwd(spec, table.double(), pos)
    with pytest.raises(ValueError):
        hash_xor.encode_xor_fwd(spec, table, pos, torch.float16)
    with pytest.raises(ValueError):
        hash_xor.grad_table_xor(spec, pos, g[:, :3].contiguous(), True)


# ---------------------------------------------------------------- envelope
# The envelope kernels K1-K4 (ops/envelope.py) at the archived probes'
# shapes and at a ragged N (100003).  K1 and K2 copy or round once, so they
# equal their twins bit for bit; K3 and K4 are held to the float64 sum of
# the same f32 contributions within 1e-5 of its largest entry, and K3 and
# K4 (but noscat, which adds with f32 atomics) also equal their twins bit
# for bit (they sum in index and sample order).
RAGGED = 100_003


def _idx(n, hi, dev, seed=0, lo=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(lo, hi, n).astype(np.int32)).to(dev)


def _randn(shape, dev, dtype=torch.float32, seed=1):
    gen = torch.Generator(dev).manual_seed(seed)
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


@pytest.mark.parametrize("t,w,dtype,n", [
    (65536, 128, torch.float32, 1 << 20),   # probe_loop.mk_gather
    (4096, 128, torch.float32, 1 << 20),    # probe_round2.k_loop
    (1 << 19, 8, torch.bfloat16, 1 << 22),  # 16-byte rows
    (1 << 19, 8, torch.float32, RAGGED),    # 32-byte rows
    (4096, 128, torch.float32, RAGGED),
])
def test_row_gather_is_its_twin(dev, t, w, dtype, n):
    """K1 copies rows, and an index outside the table (a few negative,
    a few past it) gives a zero row, bit for bit as its twin."""
    table = _randn((t, w), dev, dtype)
    idx = _idx(n, t + 64, dev, lo=-64)
    before = envelope.row_gather.launches
    got = envelope.row_gather(table, idx)
    assert envelope.row_gather.launches == before + 1
    assert torch.equal(got, envelope.row_gather_plain(table, idx))


@pytest.mark.parametrize("n", [1 << 20, RAGGED])
def test_row_gather_weighted_and_lane_sum(dev, n):
    """K1 with w (probe_round2.k_fused) and with lane sums
    (probe_tpu.k_rows) at 128- and 32-lane rows, and a 128-row table read
    by indices up to 4096 (probe_tpu.k_onehot): bit for bit."""
    table = _randn((4096, 128), dev)
    idx = _idx(n, 4096, dev)
    wt = _randn((n, 128), dev, seed=2)
    assert torch.equal(envelope.row_gather(table, idx, wt),
                       envelope.row_gather_plain(table, idx, wt))
    for width in (128, 32, 4):
        tw = table[:, :width].contiguous()
        assert torch.equal(envelope.row_gather(tw, idx, lane_sum=True),
                           envelope.row_gather_plain(tw, idx, lane_sum=True))
    small = table[:128].contiguous()
    got = envelope.row_gather(small, idx)
    assert torch.equal(got, envelope.row_gather_plain(small, idx))
    assert int((got[idx >= 128] != 0).sum()) == 0


@pytest.mark.parametrize("mode,src_shape,idx_shape,hi", [
    ("flat", (4096, 128), (8, 32768), 1 << 19),      # probe_tpu.k_flat
    ("flat", (4096, 128), (RAGGED,), 1 << 19),
    ("axis0", (512, 128), (8192, 128), 512),          # probe_tpu2.k_tala0
    ("axis0", (4096, 128), (RAGGED, 128), 4096),
    ("axis1", (8192, 128), (8192, 128), 128),         # probe_tpu2.k_tala1
    ("axis1", (RAGGED, 128), (RAGGED, 128), 128),     # probe_round2.k_lane
])
def test_elem_gather_is_its_twin(dev, mode, src_shape, idx_shape, hi):
    src = _randn(src_shape, dev)
    n = int(np.prod(idx_shape))
    idx = _idx(n, hi + 3, dev, lo=-3).reshape(idx_shape)
    before = envelope.elem_gather.launches
    got = envelope.elem_gather(src, idx, mode)
    assert envelope.elem_gather.launches == before + 1
    assert torch.equal(got, envelope.elem_gather_plain(src, idx, mode))


def _held(got, exact):
    return float((got.double() - exact).abs().max()) \
        <= 1e-5 * float(exact.abs().max())


@pytest.mark.parametrize("n,rows,w,clustered", [
    (1 << 21, 32768, 128, True),    # probe_rmw
    (1 << 20, 16384, 128, False),   # probe_final section 3, probe_scatter2
    (1 << 22, 1 << 19, 8, True),    # kernel B's 32-byte rows
    (RAGGED, 1 << 19, 4, False),    # 16-byte rows
])
def test_row_scatter_add_is_the_exact_sum(dev, n, rows, w, clustered):
    """K3 within 1e-5 of the largest entry of the f64 sum and equal to
    its twin on CPU copies and to a second launch; indices outside the
    rows are dropped."""
    if clustered:
        from jnerf_tpu_torch.tools.archive.common import clustered_rows

        idx = torch.from_numpy(np.array(clustered_rows(n, rows))).to(dev)
    else:
        idx = _idx(n, rows + 16, dev, lo=-16)
    vals = _randn((n, w), dev)
    before = envelope.row_scatter_add.launches
    got = envelope.row_scatter_add(idx, vals, rows)
    assert envelope.row_scatter_add.launches == before + 1
    assert _held(got, envelope.row_scatter_add_plain(idx, vals, rows,
                                                     torch.float64))
    assert torch.equal(got, envelope.row_scatter_add(idx, vals, rows))
    assert torch.equal(got.cpu(), envelope.row_scatter_add_plain(
        idx.cpu(), vals.cpu(), rows))


@pytest.mark.parametrize("n,rows,w", [(1 << 21, 32768, 128), (RAGGED, 5000, 4),
                                      (RAGGED, 1 << 19, 32)])
def test_row_scatter_sort_is_the_plain_plan(dev, n, rows, w):
    """K3's sort: each row's first position and every sorted source index
    equal the plain plan's (indices outside the rows last)."""
    idx = _idx(n, rows + 16, dev, lo=-16)
    vals = _randn((n, w), dev)
    for a, b in zip(envelope.row_scatter_plan(idx, vals, rows),
                    envelope.row_scatter_plan_plain(idx.cpu(), rows)):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("n,rows,w", [(RAGGED, 1000, 4), (37, 3, 32),
                                      (4099, 70000, 128)])
def test_row_scatter_add_writes_inside_its_buffers(dev, n, rows, w):
    """K3 launched on a work space and an output with guard zones on both
    sides: the guards stay as they were and the output equals the twin
    (rows with no source get zeros)."""
    idx = _idx(n, rows + 4, dev, lo=-4)
    vals = _randn((n, w), dev)
    pad, bufs = 4096, []

    def guarded(size, dtype):
        buf = torch.full((size + 2 * pad,), -7, dtype=dtype, device=dev)
        bufs.append(buf)
        return buf[pad:pad + size]

    work = guarded(envelope.row_scatter_layout(n, rows)[0], torch.int32)
    out = guarded(rows * w, torch.float32)
    envelope._ROW_SCATTER(dev.index or 0, idx.data_ptr(), vals.data_ptr(),
                          out.data_ptr(), work.data_ptr(), n, w // 4, rows, 0)
    torch.cuda.synchronize()
    for buf in bufs:
        assert bool((buf[:pad] == -7).all() and (buf[-pad:] == -7).all())
    assert torch.equal(out.view(rows, w).cpu(), envelope.row_scatter_add_plain(
        idx.cpu(), vals.cpu(), rows))


@pytest.mark.parametrize("n", [1 << 18, RAGGED])
@pytest.mark.parametrize("variant", ["v2d", "alt2", "novals", "noscat"])
def test_packed_hash_scatter_is_the_exact_sum(dev, variant, n):
    """K4 at probe_bwd_var's f2l16 shapes (and a ragged N) within 1e-5 of
    the largest entry of the f64 sum of its twin's contributions."""
    spec = HashGridSpec(n_levels=16, log2_hashmap_size=19,
                        max_level_size=1 << 18)
    rng = np.random.default_rng(0)
    pos = torch.from_numpy(rng.uniform(size=(n, 3)).astype(np.float32)).to(dev)
    g = torch.from_numpy((rng.normal(size=(n, 32)) * 0.01)
                         .astype(np.float32)).to(dev)
    rows, slots = envelope.packed_rows_slots(spec, pos)
    n_rows = max(spec.level_sizes) // 8
    scales = np.asarray(spec.scales, np.float32)
    n_acc, mode = (2, "v2d") if variant == "alt2" else (1, variant)
    got = envelope.packed_hash_scatter(pos, g, rows, slots, scales, n_rows,
                                       n_acc, mode)
    exact = envelope.packed_hash_scatter_plain(
        pos, g, rows, slots, scales, n_rows, n_acc, mode, dtype=torch.float64)
    assert _held(got, exact)


def _k4_inputs(dev, n, seed=0):
    spec = HashGridSpec(n_levels=16, log2_hashmap_size=19,
                        max_level_size=1 << 18)
    rng = np.random.default_rng(seed)
    pos = torch.from_numpy(rng.uniform(size=(n, 3)).astype(np.float32)).to(dev)
    g = torch.from_numpy((rng.normal(size=(n, 32)) * 0.01)
                         .astype(np.float32)).to(dev)
    rows, slots = envelope.packed_rows_slots(spec, pos)
    return pos, g, rows, slots, np.asarray(spec.scales, np.float32)


# (n, n_rows): probe_bwd_var's N and rows, a ragged N, and rows that are no
# multiple of a tile (the rows at or past it are dropped).
K4_SHAPES = [(1 << 18, 32768), (RAGGED, 32768), (1 << 18, 32768 - 40)]


@pytest.mark.parametrize("n,n_rows", K4_SHAPES)
@pytest.mark.parametrize("variant", ["v2d", "alt2", "novals"])
def test_packed_hash_scatter_is_its_twin_bit_for_bit(dev, variant, n, n_rows):
    """K4's v2d, alt2 and novals sum each segment in sample order, as the
    twin's index_add_ does: equal to the twin on CPU copies of the inputs,
    and two launches equal."""
    pos, g, rows, slots, scales = _k4_inputs(dev, n)
    n_acc, mode = (2, "v2d") if variant == "alt2" else (1, variant)
    args = (pos, g, rows, slots, scales, n_rows, n_acc, mode)
    before = envelope.packed_hash_scatter.launches
    got = envelope.packed_hash_scatter(*args)
    assert envelope.packed_hash_scatter.launches == before + 1
    assert torch.equal(got, envelope.packed_hash_scatter(*args))
    cpu = tuple(a.cpu() for a in args[:4]) + args[4:]
    assert torch.equal(got.cpu(), envelope.packed_hash_scatter_plain(*cpu))


@pytest.mark.parametrize("n,n_rows", [(RAGGED, 32768 - 40), (37, 3)])
@pytest.mark.parametrize("variant", ["v2d", "alt2", "novals"])
def test_packed_hash_scatter_writes_inside_its_buffers(dev, variant, n,
                                                       n_rows):
    """K4's two passes launched on buffers with guard zones on both sides
    (the work space, recA, recB and the output): the guards stay as they
    were and the output equals the twin, at a ragged N and at rows that
    are no multiple of a tile (and fewer than one)."""
    pos, g, rows, slots, scales = _k4_inputs(dev, n, seed=1)
    n_acc, mode = (2, "v2d") if variant == "alt2" else (1, variant)
    L, code = rows.shape[0], envelope.K4_MODES[mode]
    tile_rows = envelope.k4_tile_rows(n_acc, mode)
    pad, bufs = 4096, []

    def guarded(size, dtype):
        buf = torch.full((size + 2 * pad,), -7, dtype=dtype, device=dev)
        bufs.append(buf)
        return buf[pad:pad + size]

    work = guarded(envelope.envelope_lib().env_packed_work(
        n, L, n_rows, n_acc, code, tile_rows), torch.int32)
    recA = guarded(L * n * 4, torch.float32)
    recB = guarded(L * n * 2, torch.int32)
    out = guarded(L * n_acc * n_rows * 128, torch.float32)
    a_ptr = None if mode == "novals" else recA.data_ptr()
    envelope._PACKED_BINS(
        pos.get_device(), pos.data_ptr(), g.data_ptr(), rows.data_ptr(), slots.data_ptr(),
        scales.ctypes.data, work.data_ptr(), a_ptr, recB.data_ptr(), n, L,
        n_rows, n_acc, code, tile_rows)
    envelope._PACKED_ACC(pos.get_device(), work.data_ptr(), a_ptr,
                         recB.data_ptr(), out.data_ptr(), n, L, n_rows, n_acc,
                         code, tile_rows)
    torch.cuda.synchronize()
    for buf in bufs:
        assert bool((buf[:pad] == -7).all() and (buf[-pad:] == -7).all())
    assert torch.equal(out.view(-1, 128).cpu(),
                       envelope.packed_hash_scatter_plain(
                           pos.cpu(), g.cpu(), rows.cpu(), slots.cpu(), scales,
                           n_rows, n_acc, mode))


@pytest.mark.parametrize("variant", ["v2d", "alt2", "novals"])
def test_packed_hash_bins_are_the_plain_plan(dev, variant):
    """K4's bin pass: each tile's first position and every record (the
    fractions, g0, g1's bits, row-in-tile * 8 + slot) in the plain plan's
    order, a stable sort of the entries by tile."""
    pos, g, rows, slots, scales = _k4_inputs(dev, RAGGED, seed=3)
    n_acc, mode = (2, "v2d") if variant == "alt2" else (1, variant)
    args = (pos, g, rows, slots, scales, 32768 - 40, n_acc, mode)
    got = envelope.packed_hash_bins(*args)
    want = envelope.packed_hash_bins(*(tuple(a.cpu() for a in args[:4])
                                       + args[4:]))
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a.cpu(), b)


def test_packed_hash_scatter_sums_in_sample_order(dev):
    """The hand case of the CPU tests on the card: 1e8, 1, -1e8 into one
    segment give 0, their sum in sample order."""
    pos = torch.full((3, 3), 0.5, device=dev)
    g = torch.tensor([[1e8, 0.0], [1.0, 0.0], [-1e8, 0.0]], device=dev)
    rows = torch.full((1, 3), 2, dtype=torch.int32, device=dev)
    slots = torch.full((1, 3), 5, dtype=torch.int32, device=dev)
    out = envelope.packed_hash_scatter(pos, g, rows, slots, [1.0], 4)
    assert torch.count_nonzero(out) == 0


def test_envelope_kernels_on_a_side_stream(dev):
    """K2 in every mode, K3, K4 and kernel B launched under
    torch.cuda.stream(s) run on s and equal their twins."""
    side = torch.cuda.Stream()
    src = _randn((4096, 128), dev)
    cases = [("flat", _idx(8 * 32768, (1 << 19) + 3, dev, lo=-3)
              .reshape(8, 32768)),
             ("axis0", _idx(4096 * 128, 4099, dev, lo=-3).reshape(4096, 128)),
             ("axis1", _idx(4096 * 128, 131, dev, lo=-3).reshape(4096, 128))]
    pos, g, rows, slots, scales = _k4_inputs(dev, 1 << 18)
    k3_idx = _idx(1 << 20, 4096, dev)
    k3_vals = _randn((1 << 20, 32), dev)
    spec = _spec("f8l4")
    _, bpos, bg = _inputs(spec, dev, n=RAGGED)
    torch.cuda.synchronize()
    with torch.cuda.stream(side):
        got = [envelope.elem_gather(src, idx, mode) for mode, idx in cases]
        k4 = envelope.packed_hash_scatter(pos, g, rows, slots, scales, 32768)
        k3 = envelope.row_scatter_add(k3_idx, k3_vals, 4096)
        kb = hash_nbr.grad_table(spec, bpos, bg)
    side.synchronize()
    assert torch.equal(k3.cpu(), envelope.row_scatter_add_plain(
        k3_idx.cpu(), k3_vals.cpu(), 4096))
    assert torch.equal(kb.cpu(), _twin_grad(spec, bpos, bg))
    for (mode, idx), out in zip(cases, got):
        assert torch.equal(out, envelope.elem_gather_plain(src, idx, mode))
    assert torch.equal(k4.cpu(), envelope.packed_hash_scatter_plain(
        pos.cpu(), g.cpu(), rows.cpu(), slots.cpu(), scales, 32768))


def test_envelope_wrappers_refuse_bad_inputs(dev):
    """int64 indices, rows not a multiple of 16 bytes, misaligned vectors
    and mismatched shapes raise on the card; nothing falls back."""
    table = _randn((64, 8), dev)
    idx = _idx(32, 64, dev)
    with pytest.raises(TypeError):
        envelope.row_gather(table, idx.long())
    with pytest.raises(ValueError, match="16-byte"):
        envelope.row_gather(_randn((64, 6), dev), idx)
    with pytest.raises(ValueError, match="aligned"):
        envelope.row_gather(_randn((65 * 8,), dev)[1:513].view(64, 8), idx)
    with pytest.raises(ValueError):
        envelope.row_scatter_add(idx, _randn((32, 6), dev), 64)
    with pytest.raises(ValueError):
        envelope.elem_gather(table, idx.reshape(4, 8), "axis1")

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


# ------------------------------------------------- graph windows (runner)
# A tiny NGP config: 4 images of 32^2, 256 rays, a 32^3 grid, f8l4 at
# 2^13 entries, compaction to 1024 kept samples (8192 and use_pallas_mlp:
# the fused kernels, whose gate takes a multiple of their block).
WINDOW_CFG = dict(n_images=4, H=32, W=32, n_rays_per_batch=256,
                  target_batch_size=1 << 12, grid_size=32, nerf_steps=128,
                  hash_levels=4, hash_features=8, log2_hashmap_size=13)
WINDOW_KERNELS = {"F": "hash_fwd_kernel", "B": "hash_prep_kernel"}


def _window_runner(kind):
    from jnerf_tpu_torch.runner import Runner
    from jnerf_tpu_torch.utils.bench_cfg import ngp_synthetic_cfg

    cfg = ngp_synthetic_cfg(**WINDOW_CFG)
    cfg.update(compacted_batch=1024, march_budget_factor=2)
    if kind == "fused":
        cfg.update(use_pallas_mlp=True, compacted_batch=8192,
                   target_batch_size=1 << 14)
    if kind == "xor":
        cfg.update(hash_levels=8, hash_features=2, hash_indexing="xor")
    runner = Runner(device="cuda")
    assert runner.model._fused_ok == (kind == "fused")
    return runner


def _window_counters():
    from jnerf_tpu_torch.runner.windows import COUNTED_WRAPPERS

    return {name: getattr(mod, name) for mod, names in COUNTED_WRAPPERS
            for name in names}


def _training_state(runner):
    """Every tensor a run carries forward, on the host, as raw bytes."""
    st = {f"param {i}": p for i, p in enumerate(runner.params)}
    for i, p in enumerate(runner.params):
        for k, v in runner.optimizer.state[p].items():
            st[f"adam {k} {i}"] = v
    for i, v in enumerate(runner.ema_state["shadow"]):
        st[f"ema {i}"] = v
    for k, v in runner.sampler.state.items():
        if torch.is_tensor(v):
            st[f"grid {k}"] = v
    st = {k: v.detach().cpu().contiguous().reshape(-1).view(torch.uint8)
          for k, v in st.items()}
    st["generator"] = runner.generator.get_state()
    st["counts"] = torch.tensor([
        runner.optimizer.count, runner.ema_state["steps"],
        runner.sampler.state["ema_step"], runner.sampler.n_rays_per_batch,
        runner.sampler.n_samples_per_ray])
    return st


def _run_windows(runner, graph, spans):
    """Train each (start, end) span, toggling the batch shape where
    asked; returns the per-step losses and the launch counts."""
    counters = _window_counters()
    for fn in counters.values():
        fn.launches = 0
    losses = []
    train = runner.train_range if graph else runner.train_range_eager
    for span in spans:
        if span == "toggle shape":  # 256 rays <-> 128
            rays = 384 - runner.sampler.n_rays_per_batch
            runner.sampler.n_rays_per_batch = rays
            runner.sampler.n_samples_per_ray = \
                runner.sampler._samples_for_rays(rays)
            continue
        train(*span, tick=lambda *a: losses.append(
            runner.window_losses.clone()))
    torch.cuda.synchronize()
    return torch.cat(losses).cpu(), {k: fn.launches
                                     for k, fn in counters.items()}


def _kernel_counts(fn):
    """{name: launches} of the CUDA kernels ``fn`` runs, from the
    profiler."""
    from collections import Counter

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    return Counter(e.name for e in prof.events()
                   if e.device_type == cuda and not e.is_user_annotation)


@pytest.mark.parametrize("kind", ["plain", "fused", "xor"])
def test_graph_windows_equal_eager_windows(dev, kind):
    """From one seed, train_range (graph windows) and train_range_eager
    (loops of train_step) end in equal bits in every parameter, Adam
    moment, EMA shadow, grid-state tensor, host count and the generator,
    and give equal per-step losses and launch counts, across a batch-shape
    change that takes a second key through warm-up, capture and replay.
    The replays' counts agree with the profiler's kernel list."""
    spans = [(0, 16), (16, 32), (32, 48), "toggle shape", (48, 64),
             (64, 80), (80, 96)]
    runs = {}
    for graph in (True, False):
        runner = _window_runner(kind)
        losses, launches = _run_windows(runner, graph, spans)
        runs[graph] = (runner, losses, launches, _training_state(runner))
    g_runner, g_losses, g_launches, g_state = runs[True]
    _, e_losses, e_launches, e_state = runs[False]
    assert len(g_runner.windows.cache) >= 2, \
        list(g_runner.windows.cache)
    assert g_losses.numel() == 96
    assert torch.equal(g_losses.view(torch.uint8), e_losses.view(torch.uint8))
    differ = [k for k in e_state if not torch.equal(g_state[k], e_state[k])]
    assert not differ, differ
    assert g_launches == e_launches
    if kind == "xor":
        assert g_launches["grad_table_xor"] == 96
    else:
        assert g_launches["grad_table"] == 96
    if kind == "fused":
        assert g_launches["fused_mlp_bwd"] == 96
    # One more window (its refresh, then a replay) under the profiler.
    fwd, bwd = (("encode_xor_fwd", "grad_table_xor") if kind == "xor"
                else ("encode_fwd", "grad_table"))
    counters = _window_counters()
    before = {k: counters[k].launches for k in (fwd, bwd)}
    names = _kernel_counts(lambda: g_runner.train_range(96, 112))
    got = {k: counters[k].launches - before[k] for k in (fwd, bwd)}
    prof = {k: sum(n for name, n in names.items() if pat in name)
            for k, pat in ((fwd, WINDOW_KERNELS["F"]),
                           (bwd, WINDOW_KERNELS["B"]))}
    assert got[bwd] == 16 and got == prof, (got, prof)


def test_transmittance_backward_is_torch_cumprods(dev):
    """The capture-safe cumprod's gradient equals torch.cumprod's, bit for
    bit, on inputs with no zeros."""
    from jnerf_tpu_torch.ops.composite import transmittance

    gen = torch.Generator(dev).manual_seed(0)
    alpha = torch.rand((4096, 128), generator=gen, device=dev)
    alpha[:, ::7] = 1.0  # factors of 1e-10
    g = torch.randn((4096, 128), generator=gen, device=dev)
    grads = []
    for fn in (transmittance,
               lambda a: torch.cumprod(1.0 - a + 1e-10, dim=-1)):
        a = alpha.clone().requires_grad_(True)
        out = fn(a)
        out.backward(g)
        grads.append((out.detach(), a.grad))
    assert torch.equal(grads[0][0], grads[1][0])
    assert torch.equal(grads[0][1], grads[1][1])


# ------------------------------------------------------------------ kernel V
def _voxel_inputs(n, n_rows, dev, seed=0):
    """Kernel V's inputs: rows with a hot one, weights with zeros, and
    samples whose g is 0 in both tables (or in the SH table alone)."""
    g = torch.Generator().manual_seed(seed)
    idx = torch.randint(0, n_rows, (n, 8), generator=g)
    idx[n // 3:n // 2] = n_rows // 2
    w = torch.rand((n, 8), generator=g)
    w[::7, 3] = 0.0
    gd = torch.randn((n, 1), generator=g)
    gs = torch.randn((n, 27), generator=g)
    gd[::5], gs[::5], gs[1::6] = 0.0, 0.0, -0.0
    return [x.to(dev) for x in (idx, w, gd, gs)]


VOXEL_SHAPES = [(37, 3), (4099, 1000), (100_003, 64 ** 3), (1 << 18, 4096)]


@pytest.mark.parametrize("n,n_rows", VOXEL_SHAPES)
def test_voxel_grad_is_its_plain_version_bit_for_bit(dev, n, n_rows):
    """Kernel V equals its plain version run on CPU copies bit for bit
    (on CUDA tensors the plain version's index_add_ adds with atomics),
    and a second launch; its sort is the plain plan."""
    from jnerf_tpu_torch.ops import voxel_grid

    idx, w, gd, gs = _voxel_inputs(n, n_rows, dev)
    got = voxel_grid.corner_grad(idx, w, [gd, gs], n_rows)
    again = voxel_grid.corner_grad(idx, w, [gd, gs], n_rows)
    want = voxel_grid.corner_grad_plain(idx.cpu(), w.cpu(),
                                        [gd.cpu(), gs.cpu()], n_rows)
    for a, b, c in zip(got, again, want):
        assert torch.equal(a.cpu().view(torch.int32), c.view(torch.int32))
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    start, order = voxel_grid.corner_grad_plan(idx, w, [gd, gs], n_rows)
    p_start, p_order = voxel_grid.corner_grad_plan_plain(
        idx.cpu(), w.cpu(), [gd.cpu(), gs.cpu()], n_rows)
    assert torch.equal(start.cpu(), p_start)
    assert torch.equal(order.cpu(), p_order)


@pytest.mark.parametrize("n,n_rows", [(37, 3), (4099, 70000)])
def test_voxel_grad_writes_inside_its_buffers(dev, n, n_rows):
    """Kernel V launched on a work space and outputs with guard zones on
    both sides: the guards stay as they were and the outputs equal the
    plain version (rows with no item get +0.0)."""
    from jnerf_tpu_torch.ops import voxel_grid

    idx, w, gd, gs = _voxel_inputs(n, n_rows, dev, seed=1)
    pad, bufs = 4096, []

    def guarded(size, dtype):
        buf = torch.full((size + 2 * pad,), -7, dtype=dtype, device=dev)
        bufs.append(buf)
        return buf[pad:pad + size]

    work = guarded(voxel_grid.grad_layout(n, 8, n_rows)[0], torch.int32)
    outs = [guarded(n_rows, torch.float32), guarded(n_rows * 27,
                                                    torch.float32)]
    voxel_grid._launch_grad(idx, w, [gd, gs], n_rows, outs, work, False)
    torch.cuda.synchronize()
    for buf in bufs:
        assert bool((buf[:pad] == -7).all() and (buf[-pad:] == -7).all())
    want = voxel_grid.corner_grad_plain(idx.cpu(), w.cpu(),
                                        [gd.cpu(), gs.cpu()], n_rows)
    for o, c in zip(outs, want):
        assert torch.equal(o.view(c.shape).cpu().view(torch.int32),
                           c.view(torch.int32))


def test_voxel_grad_in_the_corner_gather_and_refusals(dev):
    """The corner gather's backward on the card is kernel V (one launch a
    backward, the plain version's bits); the wrapper refuses what the
    kernel does not take."""
    from jnerf_tpu_torch.ops import voxel_grid

    spec = voxel_grid.VoxelGridSpec((20, 18, 22), 9)
    gen = torch.Generator(dev).manual_seed(0)
    d = torch.rand((20, 18, 22), generator=gen, device=dev).requires_grad_()
    sh = torch.randn((20, 18, 22, 27), generator=gen,
                     device=dev).requires_grad_()
    pos = torch.rand((5000, 3), generator=gen, device=dev) * 21 - 0.5
    before = voxel_grid.corner_grad.launches
    sig, shc = voxel_grid.trilinear_sample(spec, d, sh, pos)
    (sig.sum() + (shc * 0.5).sum()).backward()
    assert voxel_grid.corner_grad.launches == before + 1
    idx, w = voxel_grid.corners(spec, pos)
    want = voxel_grid.corner_grad_plain(
        idx.cpu(), w.cpu(), [torch.ones((5000, 1)),
                             torch.full((5000, 27), 0.5)], spec.n_cells)
    assert torch.equal(d.grad.reshape(-1, 1).cpu(), want[0])
    assert torch.equal(sh.grad.reshape(-1, 27).cpu(), want[1])
    ok = [idx, w, [torch.ones((5000, 1), device=dev)]]
    for bad in ([idx.int(), w, ok[2]], [idx, w.double(), ok[2]],
                [idx, w, [torch.ones((5000, 1), device=dev).t()]],
                [idx, w, []]):
        with pytest.raises(ValueError):
            voxel_grid.corner_grad(*bad, spec.n_cells)


def _dense_voxel_inputs(reso, n, dev, seed=0, dead=0.3, cluster=False):
    """Kernel V's inputs on the sample path: corners() of positions running
    past every border of a ``reso`` grid (``cluster``: all within a cell of
    one point, so that a tile's rows hold more items than its shared
    memory), g of a ``dead`` share of samples 0 in both tables (and of
    some in the SH table alone); (base rows, w, gd, gs, n_rows, offsets),
    as the dense corner gather hands them over."""
    from jnerf_tpu_torch.ops import voxel_grid

    spec = voxel_grid.VoxelGridSpec(reso, 9)
    g = torch.Generator().manual_seed(seed)
    hi = torch.tensor(reso, dtype=torch.float32)
    if cluster:
        pos = hi / 2 + torch.rand((n, 3), generator=g) - 0.5
    else:
        pos = torch.rand((n, 3), generator=g) * (hi + 1.0) - 1.0
    pos[:7] = torch.tensor([[-2.0, -2.0, -2.0], [0.0, 0.0, 0.0],
                            [reso[0] - 1.0, reso[1] - 1.0, reso[2] - 1.0],
                            [reso[0] + 3.0, 0.5, 1.0], [1.0, 1.0, 1.0],
                            [reso[0] - 2.0, reso[1] - 2.0, 0.0],
                            [0.25, reso[1] + 0.5, reso[2] - 1.5]])
    idx, w = voxel_grid.corners(spec, pos)
    gd = torch.randn((n, 1), generator=g)
    gs = torch.randn((n, 27), generator=g)
    off = torch.rand(n, generator=g) < dead
    gd[off], gs[off] = 0.0, 0.0
    gs[torch.rand(n, generator=g) < 0.1] = -0.0
    return ([x.to(dev) for x in (idx[:, 0].contiguous(), w, gd, gs)]
            + [spec.n_cells, voxel_grid.corner_offsets(spec)])


def _assert_voxel_plain(got, idx, w, grads, n_rows, offsets=None):
    from jnerf_tpu_torch.ops import voxel_grid

    rows = voxel_grid.corner_rows(idx.cpu(), n_rows, offsets)
    want = voxel_grid.corner_grad_plain(rows, w.cpu(),
                                        [g.cpu() for g in grads], n_rows)
    for a, c in zip(got, want):
        assert torch.equal(a.cpu().view(torch.int32), c.view(torch.int32))


@pytest.mark.parametrize("reso,n,cluster", [
    ((20, 18, 22), 5000, False), ((64, 64, 64), 200_000, False),
    ((40, 33, 50), 30_000, True)])
def test_voxel_grad_sample_path_is_its_plain_version(dev, reso, n, cluster):
    """The dense grid's sample path (corners() indices of positions past
    every border, the corner offsets given) equals the plain version on
    CPU copies bit for bit, and a second launch; its sort is the plain
    sample plan.  The clustered case puts more items in a tile than its
    shared memory holds."""
    from jnerf_tpu_torch.ops import voxel_grid

    idx, w, gd, gs, n_rows, offs = _dense_voxel_inputs(reso, n, dev,
                                                       cluster=cluster)
    got = voxel_grid.corner_grad(idx, w, [gd, gs], n_rows, offs)
    again = voxel_grid.corner_grad(idx, w, [gd, gs], n_rows, offs)
    _assert_voxel_plain(got, idx, w, [gd, gs], n_rows, offs)
    for a, b in zip(got, again):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    start, order = voxel_grid.corner_grad_plan(idx, w, [gd, gs], n_rows,
                                               offs)
    p_start, p_order = voxel_grid.corner_grad_plan_plain(
        idx.cpu(), w.cpu(), [gd.cpu(), gs.cpu()], n_rows, offs)
    assert torch.equal(start.cpu(), p_start)
    assert torch.equal(order.cpu(), p_order)
    if cluster:  # a warp's rows hold more entries than its window
        tile, room = voxel_grid.grad_layout(n, 8, n_rows, True)[3:5]
        p = p_start.long()
        r0 = torch.arange(0, n_rows, tile)
        r1 = torch.clamp(r0 + tile, max=n_rows)
        entries = sum(p[torch.clamp(r1 - o, 0, n_rows)]
                      - p[torch.clamp(r0 - o, 0, n_rows)] for o in offs)
        assert int(entries.max()) > room


def test_voxel_grad_under_one_percent_kept(dev):
    """A sparse-grid-shaped case on the item path: most samples dead, most
    corners of weight 0, under 1% of the items kept; bit for bit the plain
    version and its plan."""
    from jnerf_tpu_torch.ops import voxel_grid

    n, n_rows = 300_000, 1 << 20
    idx, w, gd, gs = _voxel_inputs(n, n_rows, dev, seed=2)
    gen = torch.Generator(dev).manual_seed(5)
    dead = torch.rand(n, generator=gen, device=dev) < 0.99
    gd[dead], gs[dead] = 0.0, 0.0
    w[torch.rand((n, 8), generator=gen, device=dev) < 0.5] = 0.0
    got = voxel_grid.corner_grad(idx, w, [gd, gs], n_rows)
    _assert_voxel_plain(got, idx, w, [gd, gs], n_rows)
    start, order = voxel_grid.corner_grad_plan(idx, w, [gd, gs], n_rows)
    kept = int(start[-1])
    assert 0 < kept < n * 8 // 100
    p_start, p_order = voxel_grid.corner_grad_plan_plain(
        idx.cpu(), w.cpu(), [gd.cpu(), gs.cpu()], n_rows)
    assert torch.equal(start.cpu(), p_start)
    assert torch.equal(order.cpu(), p_order)


@pytest.mark.parametrize("samples", [False, True])
def test_voxel_grad_nothing_kept(dev, samples):
    """Every g 0 (or -0.0): nothing is kept and every row is +0.0, on both
    paths."""
    from jnerf_tpu_torch.ops import voxel_grid

    if samples:
        idx, w, gd, gs, n_rows, offs = _dense_voxel_inputs((30, 31, 29),
                                                           20_000, dev)
    else:
        (idx, w, gd, gs), n_rows, offs = _voxel_inputs(20_000, 70_000,
                                                       dev), 70_000, None
    gd.zero_()
    gs.fill_(-0.0)
    got = voxel_grid.corner_grad(idx, w, [gd, gs], n_rows, offs)
    for a in got:
        assert bool((a == 0).all()) and not bool(torch.signbit(a).any())
    start, order = voxel_grid.corner_grad_plan(idx, w, [gd, gs], n_rows,
                                               offs)
    assert int(start[-1]) == 0 and order.numel() == 0
    assert bool((start == 0).all())


@pytest.mark.parametrize("samples", [False, True])
def test_voxel_grad_in_a_cuda_graph(dev, samples):
    """corner_grad captured in a CUDA graph and replayed on new inputs
    copied into the captured buffers equals eager launches on them, and
    the plain version."""
    from jnerf_tpu_torch.ops import voxel_grid

    def inputs(seed):
        if samples:
            return _dense_voxel_inputs((48, 40, 44), 60_000, dev, seed=seed)
        return (_voxel_inputs(60_000, 90_000, dev, seed=seed)
                + [90_000, None])

    idx, w, gd, gs, n_rows, offs = inputs(0)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up: the build, the layout's cache
        voxel_grid.corner_grad(idx, w, [gd, gs], n_rows, offs)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = voxel_grid.corner_grad(idx, w, [gd, gs], n_rows, offs)
    for seed in (1, 2):
        new = inputs(seed)
        for dst, src in zip((idx, w, gd, gs), new):
            dst.copy_(src)
        graph.replay()
        eager = voxel_grid.corner_grad(idx, w, [gd, gs], n_rows, offs)
        torch.cuda.synchronize()
        for a, b in zip(outs, eager):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        _assert_voxel_plain(outs, idx, w, [gd, gs], n_rows, offs)


@pytest.mark.parametrize("samples", [False, True])
def test_voxel_grad_paths_write_inside_their_buffers(dev, samples):
    """Each path launched on a work space and outputs with guard zones on
    both sides (the outputs off 16-byte alignment too): the guards stay as
    they were and the outputs equal the plain version."""
    from jnerf_tpu_torch.ops import voxel_grid

    if samples:
        idx, w, gd, gs, n_rows, offs = _dense_voxel_inputs((25, 26, 27),
                                                           9000, dev, seed=3)
    else:
        (idx, w, gd, gs), n_rows, offs = _voxel_inputs(9000, 17_000, dev,
                                                       seed=3), 17_000, None
    n = w.shape[0]
    for pad in (4096, 4097):
        bufs = []

        def guarded(size, dtype):
            buf = torch.full((size + 2 * pad,), -7, dtype=dtype, device=dev)
            bufs.append(buf)
            return buf[pad:pad + size]

        work = guarded(voxel_grid.grad_layout(n, 8, n_rows,
                                              samples)[0], torch.int32)
        outs = [guarded(n_rows, torch.float32),
                guarded(n_rows * 27, torch.float32)]
        voxel_grid._launch_grad(idx, w, [gd, gs], n_rows, outs, work, False,
                                offs)
        torch.cuda.synchronize()
        for buf in bufs:
            assert bool((buf[:pad] == -7).all() and (buf[-pad:] == -7).all())
        _assert_voxel_plain([outs[0].view(n_rows, 1),
                             outs[1].view(n_rows, 27)],
                            idx, w, [gd, gs], n_rows, offs)


def test_voxel_grad_refuses_bad_offsets(dev):
    """The sample path's offsets: K ints in [0, n_rows), the first 0, one
    a column of w; its idx the [N] base rows, so that no corner row can
    disagree with them ([N, K] rows with offsets are refused)."""
    from jnerf_tpu_torch.ops import voxel_grid

    idx, w, gd, gs, n_rows, offs = _dense_voxel_inputs((10, 10, 10), 100,
                                                       dev)
    for bad in (offs[:7], (1,) + offs[1:], offs[:7] + (n_rows,),
                offs[:7] + (-1,), offs[:7] + (3.0,)):
        with pytest.raises(ValueError):
            voxel_grid.corner_grad(idx, w, [gd, gs], n_rows, bad)
    rows = voxel_grid.corner_rows(idx, n_rows, offs)
    for bad in ([rows, w], [idx[:, None], w], [idx.int(), w],
                [idx, w[:, :7]]):
        with pytest.raises(ValueError):
            voxel_grid.corner_grad(*bad, [gd, gs], n_rows, offs)


def test_voxel_grad_sample_path_base_rows_off_the_grid(dev):
    """Base rows below 0, past the last row and near it (some corners
    past the grid): the card gives the CPU's corner_grad bit for bit; a
    sample whose base row is off the grid adds nothing, a corner past the
    grid is left out."""
    from jnerf_tpu_torch.ops import voxel_grid

    idx, w, gd, gs, n_rows, offs = _dense_voxel_inputs((21, 19, 23),
                                                       20_000, dev, seed=4)
    gen = torch.Generator().manual_seed(6)
    picks = torch.randint(0, idx.shape[0], (3000,), generator=gen).to(dev)
    idx[picks[:1000]] = -torch.randint(1, 600, (1000,),
                                       generator=gen).to(dev)
    idx[picks[1000:2000]] = n_rows + torch.randint(
        0, 50, (1000,), generator=gen).to(dev)
    idx[picks[2000:]] = n_rows - 1 - torch.randint(
        0, 600, (1000,), generator=gen).to(dev)
    got = voxel_grid.corner_grad(idx, w, [gd, gs], n_rows, offs)
    want = voxel_grid.corner_grad(idx.cpu(), w.cpu(), [gd.cpu(), gs.cpu()],
                                  n_rows, offs)
    for a, c in zip(got, want):
        assert torch.equal(a.cpu().view(torch.int32), c.view(torch.int32))
    _assert_voxel_plain(got, idx, w, [gd, gs], n_rows, offs)


# ---------------------------------------------------- the families' windows
def _family_runner(kind, tmp_path):
    """A tiny NeuS, Mip-NeRF or Plenoxels runner on the card over a scene
    the port writes (the widths of tests/torch_parity.py's configs)."""
    import textwrap
    from pathlib import Path

    from jnerf_tpu_torch.dataset.synthetic import (
        make_synthetic_neus_scene, make_synthetic_scene,
    )
    from jnerf_tpu_torch.runner import MipRunner, NeuSRunner, Svox2Runner
    from jnerf_tpu_torch.utils.config import init_cfg

    root = Path(__file__).resolve().parents[1] / "projects"
    cfg = tmp_path / f"{kind}.py"
    if kind == "neus":
        scene = make_synthetic_neus_scene(str(tmp_path / "scene"),
                                          n_images=6, H=24, W=32)
        cfg.write_text(textwrap.dedent(f"""\
            _base_ = {str(root / "neus/configs/neus_womask.py")!r}
            dataset = dict(dataset_dir={scene!r})
            base_exp_dir = {str(tmp_path / "exp")!r}
            end_iter = 40
            batch_size = 64
            warm_up_end = 2
            anneal_end = 8
            report_freq = 10
            save_freq = 100000
            val_freq = 100000
            val_mesh_freq = 100000
            model = dict(
                nerf_network=dict(D=3, W=32, skips=[1]),
                sdf_network=dict(d_out=65, d_hidden=64, n_layers=3,
                                 skip_in=[2]),
                rendering_network=dict(d_feature=64, d_hidden=32, n_layers=2))
            render = dict(n_samples=16, n_importance=16, n_outside=4,
                          up_sample_steps=2, perturb=1.0, _cover_=True,
                          type="NeuSRenderer")
        """))
        init_cfg(str(cfg))
        return NeuSRunner(device="cuda")
    scene = str(tmp_path / "scene")
    make_synthetic_scene(scene, n_train=4, n_val=2, n_test=2, H=32, W=32)
    if kind == "mip":
        cfg.write_text(textwrap.dedent(f"""\
            _base_ = {str(root / "mipnerf/configs/mip_base.py")!r}
            dataset_dir = {scene!r}
            log_dir = {str(tmp_path / "logs")!r}
            dataset = dict(
                train=dict(root_dir=dataset_dir, batch_size=256),
                val=dict(root_dir=dataset_dir, batch_size=256),
                test=dict(root_dir=dataset_dir, batch_size=256))
            tot_train_steps = 40
            num_samples = 32
            net_depth = 4
            net_width = 64
            net_width_condition = 32
        """))
        init_cfg(str(cfg))
        return MipRunner(device="cuda")
    cfg.write_text(textwrap.dedent(f"""\
        _base_ = {str(root / "svox2/configs/svox2_base.py")!r}
        dataset_dir = {scene!r}
        log_dir = {str(tmp_path / "logs")!r}
        dataset = dict(train=dict(root=dataset_dir, split='train'),
                       test=dict(root=dataset_dir, split='test'))
        model = dict(reso=24, radius=1.4)
        reso_list = [[24] * 3, [48] * 3]
        sparse_cell_threshold = 30000
        density_thresh = 0.05
        sparse_dilate = 1
        batch_size = 512
        upsamp_every = 32
        lambda_tv = 1e-3
        lambda_tv_sh = 1e-3
    """))
    init_cfg(str(cfg))
    return Svox2Runner(device="cuda")


def _family_state(runner):
    """Every tensor a family's run carries forward, as raw bytes."""
    if hasattr(runner, "grid"):
        st = dict(runner.grid.tables())
        st.update(dict(runner.grid.named_buffers()))
        st["sh_rms"] = runner.opt_state["sh_rms"]
        counts = [runner.gstep]
    else:
        st = {f"param {i}": p for i, p in enumerate(runner.params)}
        for i, p in enumerate(runner.params):
            for k, v in runner.optimizer.state[p].items():
                st[f"adam {k} {i}"] = v
        counts = [runner.optimizer.count]
    st = {k: v.detach().cpu().contiguous().reshape(-1).view(torch.uint8)
          for k, v in st.items()}
    st["generator"] = runner.generator.get_state()
    st["counts"] = torch.tensor(counts)
    return st


@pytest.mark.parametrize("kind", ["neus", "mip", "svox2"])
def test_family_graph_windows_equal_eager(dev, kind, tmp_path):
    """From one seed, each family's train() through graph windows (twice)
    and through the eager loop ends in equal bits in every parameter,
    optimizer state, count, grid buffer and the generator, with equal
    per-step losses and launch counts; Plenoxels runs dense, upsamples
    (dropping its graphs) and runs sparse, kernel V launched once a
    step."""
    from jnerf_tpu_torch.ops import voxel_grid

    runs = []
    for graph in (True, True, False):
        runner = _family_runner(kind, tmp_path / str(len(runs)))
        losses = []
        orig = runner.train_window

        def train_window(n, graph_=None, orig=orig):
            out = orig(n, graph_)
            losses.append(out.clone())
            return out

        runner.train_window = train_window
        voxel_grid.corner_grad.launches = 0
        if kind == "svox2":  # 2 dense windows, the upsample, 2 sparse
            runner.train(64, graph=graph)
        else:
            runner.train(graph=graph)
        torch.cuda.synchronize()
        runs.append((torch.cat(losses).cpu(), _family_state(runner),
                     voxel_grid.corner_grad.launches,
                     len(runner.windows.cache)))
        del runner
    (l0, s0, v0, g0), (l1, s1, v1, _), (l2, s2, v2, g2) = runs
    steps = 64 if kind == "svox2" else 40
    assert g0 >= 1 and g2 == 0
    assert l0.shape[0] == steps
    for loss, st, v in ((l1, s1, v1), (l2, s2, v2)):
        assert torch.equal(l0.view(torch.uint8), loss.view(torch.uint8))
        differ = [k for k in s0 if not torch.equal(s0[k], st[k])]
        assert not differ, differ
        assert v == v0
    assert v0 == (steps if kind == "svox2" else 0)


def test_pixelnerf_repeats_from_a_seed(dev):
    """Two pixelNeRF runs from one seed (cuDNN pinned to its deterministic
    algorithms, the resize's backward in a fixed order) end in equal
    bits."""
    from jnerf_tpu_torch.projects.pixelnerf import main as pix

    images, poses, focal = pix.make_synthetic(6, 48, 48)
    runs = []
    for _ in range(2):
        model = pix.build_model("cuda", net_width=64)
        hist = pix.train(model, images, poses, focal, epochs=1, batch=512)
        runs.append((hist["step_loss"], {k: v.detach().cpu() for k, v in
                                         model.state_dict().items()}))
    (l1, s1), (l2, s2) = runs
    assert len(l1) >= 4 and l1 == l2
    for k in s1:
        assert torch.equal(s1[k].view(torch.uint8), s2[k].view(torch.uint8)), k

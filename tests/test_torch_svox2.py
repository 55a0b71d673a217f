"""Plenoxels in the port (`ops/voxel_grid.py`, `PlenOptim` and `expon_lr`,
`SvoxNeRFDataset`, `SparseGrid`, `Svox2Runner`) against the JAX package's
on the CPU, with grids carried across as tensors or through svox2's .npz
schema and the JAX draws passed in.

Tolerances: f32 arithmetic in the same order is held at rtol 1e-5 or
better.  Gradients of the corner gather are sums of w * g scattered into
the same cells in another order (one ``index_add_`` here, XLA's scatter
there): atol 1e-5 of the gradient's largest entry.  The compositing's
cumprod runs over up to ~100 samples: rtol 1e-5 on rgb.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import clear_cfgs, j, n, t, write_svox2_cfg  # noqa: F401

from jnerf_tpu.ops import voxel_grid as jv
from jnerf_tpu_torch.ops import voxel_grid as tv

RESO = (5, 6, 7)


def _grid(basis=4, seed=0, reso=RESO):
    rng = np.random.default_rng(seed)
    density = rng.uniform(0, 2, reso).astype(np.float32)
    sh = rng.normal(size=reso + (3 * basis,)).astype(np.float32)
    return density, sh


def _assert_grad(got, ref, name):
    scale = float(np.abs(ref).max())
    assert scale > 0, name
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * scale,
                               err_msg=name)


@pytest.mark.parametrize("basis", [1, 4, 9])
def test_eval_sh_basis_matches_jax(basis):
    rng = np.random.default_rng(basis)
    v = rng.normal(size=(500, 3))
    v = (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)
    np.testing.assert_allclose(n(tv.eval_sh_basis(basis, t(v))),
                               n(jv.eval_sh_basis(basis, j(v))), rtol=1e-6,
                               atol=1e-7)


def _sparse_pair(density, sh, seed=1):
    """build_sparse of a random half mask in both packages: equal links,
    tables and cells."""
    mask = np.random.default_rng(seed).uniform(size=density.shape) < 0.5
    got = tv.build_sparse(t(density), t(sh), t(mask))
    want = jv.build_sparse(density, sh, mask)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(n(a), np.asarray(b))
    return got, want


@pytest.mark.parametrize("sparse", [False, True])
def test_trilinear_sample_values_and_grads(sparse):
    """trilinear_sample (dense) and trilinear_sample_sparse (links from a
    random half mask) at positions that run past every border: sigma and
    SH equal JAX's at rtol 1e-6, and the gradients of a random projection
    with respect to both tables against jax.grad."""
    density, sh = _grid()
    spec_t, spec_j = tv.VoxelGridSpec(RESO, 4), jv.VoxelGridSpec(RESO, 4)
    rng = np.random.default_rng(2)
    pos = rng.uniform(-0.7, np.array(RESO) - 0.3, (300, 3)).astype(np.float32)
    rs = rng.normal(size=(300,)).astype(np.float32)
    rc = rng.normal(size=(300, 12)).astype(np.float32)
    if sparse:
        (links, dd, sd, _), (jlinks, jdd, jsd, _) = _sparse_pair(density, sh)
        a, b = dd.clone().requires_grad_(), sd.clone().requires_grad_()
        sig, shc = tv.trilinear_sample_sparse(spec_t, links, a, b, t(pos))

        def jfn(x, y):
            s, c = jv.trilinear_sample_sparse(spec_j, j(jlinks), x, y, j(pos))
            return jnp.sum(s * j(rs)) + jnp.sum(c * j(rc))
        jargs = (jdd, jsd)
        jsig, jshc = jv.trilinear_sample_sparse(spec_j, j(jlinks), jdd, jsd,
                                                j(pos))
    else:
        a, b = t(density).requires_grad_(), t(sh).requires_grad_()
        sig, shc = tv.trilinear_sample(spec_t, a, b, t(pos))

        def jfn(x, y):
            s, c = jv.trilinear_sample(spec_j, x, y, j(pos))
            return jnp.sum(s * j(rs)) + jnp.sum(c * j(rc))
        jargs = (j(density), j(sh))
        jsig, jshc = jv.trilinear_sample(spec_j, *jargs, j(pos))
    np.testing.assert_allclose(n(sig), n(jsig), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(n(shc), n(jshc), rtol=1e-6, atol=1e-6)
    ((sig * t(rs)).sum() + (shc * t(rc)).sum()).backward()
    ga, gb = jax.grad(jfn, argnums=(0, 1))(*jargs)
    _assert_grad(n(a.grad), n(ga), "density")
    _assert_grad(n(b.grad), n(gb), "sh")


def _grid_rays(seed, r=48, reso=RESO):
    """Rays in grid space from outside the box towards its inside."""
    rng = np.random.default_rng(seed)
    c = np.array(reso, np.float32) / 2
    o = c + rng.normal(size=(r, 3)) * 6
    target = c + rng.uniform(-1.5, 1.5, (r, 3))
    d = target - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ds = rng.uniform(0.5, 2, (r,)).astype(np.float32)
    return o.astype(np.float32), d.astype(np.float32), ds


@pytest.mark.parametrize("sparse", [False, True])
def test_render_rays_grid_values_and_grads(sparse):
    """render_rays_grid and render_rays_grid_sparse (basis 4, the
    diagonal's sample count at step 0.5, a delta scale a ray, background
    0.7): rgb at rtol 1e-5 and the tables' gradients against jax.grad."""
    density, sh = _grid(seed=3)
    density *= 0.4
    spec_t, spec_j = tv.VoxelGridSpec(RESO, 4), jv.VoxelGridSpec(RESO, 4)
    o, d, ds = _grid_rays(4)
    ns = int(np.ceil(np.linalg.norm(RESO) / 0.5))
    rr = np.random.default_rng(5).normal(size=(len(o), 3)).astype(np.float32)
    kw = dict(background_brightness=0.7, sigma_thresh=1e-8)
    if sparse:
        (links, dd, sd, _), (jlinks, jdd, jsd, _) = _sparse_pair(density, sh)
        a, b = dd.clone().requires_grad_(), sd.clone().requires_grad_()
        rgb = tv.render_rays_grid_sparse(spec_t, links, a, b, t(o), t(d), ns,
                                         0.5, delta_scale=t(ds), **kw)

        def jfn(x, y):
            return jv.render_rays_grid_sparse(spec_j, j(jlinks), x, y, j(o),
                                              j(d), ns, 0.5,
                                              delta_scale=j(ds), **kw)
        jargs = (jdd, jsd)
    else:
        a, b = t(density).requires_grad_(), t(sh).requires_grad_()
        rgb = tv.render_rays_grid(spec_t, a, b, t(o), t(d), ns, 0.5,
                                  delta_scale=t(ds), **kw)

        def jfn(x, y):
            return jv.render_rays_grid(spec_j, x, y, j(o), j(d), ns, 0.5,
                                       delta_scale=j(ds), **kw)
        jargs = (j(density), j(sh))
    jrgb = jfn(*jargs)
    assert float(np.abs(n(jrgb) - 0.7).max()) > 0.05  # the rays see the grid
    np.testing.assert_allclose(n(rgb), n(jrgb), rtol=1e-5, atol=1e-6)
    (rgb * t(rr)).sum().backward()
    ga, gb = jax.grad(lambda x, y: jnp.sum(jfn(x, y) * j(rr)),
                      argnums=(0, 1))(*jargs)
    _assert_grad(n(a.grad), n(ga), "density")
    _assert_grad(n(b.grad), n(gb), "sh")


def test_total_variation_dense_and_sparse():
    """Dense TV of density and SH, values and gradients; sparse TV over
    2^16 table rows drawn by the JAX key (passed in), for the density
    table and the SH table."""
    density, sh = _grid(seed=6)
    for g in (density, sh):
        x = t(g).requires_grad_()
        val = tv.total_variation(x)
        np.testing.assert_allclose(float(val),
                                   float(jv.total_variation(j(g))), rtol=1e-6)
        val.backward()
        _assert_grad(n(x.grad), n(jax.grad(jv.total_variation)(j(g))), "tv")
    (links, dd, sd, cells), (jlinks, jdd, jsd, jcells) = _sparse_pair(
        density, sh, seed=7)
    spec_t, spec_j = tv.VoxelGridSpec(RESO, 4), jv.VoxelGridSpec(RESO, 4)
    key = jax.random.PRNGKey(11)
    m = 1 << 16  # rows of [0, 32768): ~2 draws an active row
    ridx = t(np.asarray(jax.random.randint(key, (m,), 0, cells.shape[0])))
    for data, jdata in ((dd, jdd), (sd, jsd)):
        x = data.clone().requires_grad_()
        val = tv.total_variation_sparse(spec_t, links, cells, x, m, ridx=ridx)

        def jfn(y):
            return jv.total_variation_sparse(spec_j, j(jlinks), jcells, y,
                                             key, m)
        np.testing.assert_allclose(float(val), float(jfn(jdata)), rtol=1e-6)
        val.backward()
        _assert_grad(n(x.grad), n(jax.grad(jfn)(jdata)), "sparse tv")


@pytest.mark.parametrize("old,new", [(24, 48), (16, 40)])
def test_upsample_grid_matches_jax_resize(old, new):
    """upsample_grid (F.interpolate, trilinear, half-pixel) against
    jax.image.resize at 24^3 -> 48^3 and the non-2x 16^3 -> 40^3: within
    1e-5 (measured 3.6e-7 and 2.9e-6 on values of order 1)."""
    density, sh = _grid(basis=1, seed=old, reso=(old,) * 3)
    d, s = tv.upsample_grid(t(density), t(sh), (new,) * 3)
    jd, js = jv.upsample_grid(j(density), j(sh), (new,) * 3)
    assert tuple(d.shape) == (new,) * 3 and tuple(s.shape) == (new,) * 3 + (3,)
    np.testing.assert_allclose(n(d), n(jd), rtol=0, atol=1e-5)
    np.testing.assert_allclose(n(s), n(js), rtol=0, atol=1e-5)


def test_dilate_mask_and_build_sparse():
    """dilate_mask for 0-3 passes on a sparse random mask (cells on every
    border) equals JAX's; build_sparse at the default capacity and a
    given one equals JAX's (links, tables, cells)."""
    rng = np.random.default_rng(8)
    mask = rng.uniform(size=(9, 10, 11)) < 0.02
    mask[0, 0, 0] = mask[-1, -1, -1] = True
    for iters in range(4):
        np.testing.assert_array_equal(
            n(tv.dilate_mask(t(mask), iters)),
            np.asarray(jv.dilate_mask(j(mask), iters)))
    density, sh = _grid(basis=1, reso=(9, 10, 11))
    for cap in (None, 1 << 16):
        got = tv.build_sparse(t(density), t(sh), t(mask), cap)
        want = jv.build_sparse(density, sh, mask, cap)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(n(a), np.asarray(b))


def test_expon_lr_and_plen_optim_step():
    """expon_lr with and without the delay over 0-20000 (3 f32 ulps:
    numpy's f32 sin and exp against XLA's), and one PlenOptim step on
    dense and on sparse tables equal to the JAX update at rtol 1e-6."""
    from jnerf_tpu.optims.svox2_optim import PlenOptim as JaxOptim
    from jnerf_tpu.optims.svox2_optim import expon_lr as jax_lr
    from jnerf_tpu_torch.optims import PlenOptim
    from jnerf_tpu_torch.optims.svox2_optim import expon_lr

    steps = np.arange(0, 20001, 7)
    for args in ((30.0, 0.05, 15000, 0.01, 250000), (1e-2, 5e-6, 0, 0.01, 250000)):
        got = np.array([expon_lr(int(s), *args) for s in steps], np.float32)
        want = np.array([float(jax_lr(int(s), *args)) for s in steps],
                        np.float32)
        np.testing.assert_allclose(got, want, rtol=3 * 2.0 ** -23, atol=0)
    rng = np.random.default_rng(9)
    for dk, sk in (("density", "sh"), ("density_data", "sh_data")):
        p = {dk: rng.normal(size=(50,)).astype(np.float32),
             sk: rng.normal(size=(50, 27)).astype(np.float32)}
        g = {k: rng.normal(size=v.shape).astype(np.float32) * 1e-3
             for k, v in p.items()}
        rms = np.abs(rng.normal(size=(50, 27))).astype(np.float32) * 1e-6
        params = {k: torch.nn.Parameter(t(v)) for k, v in p.items()}
        for k in params:
            params[k].grad = t(g[k])
        opt = PlenOptim(0.95)
        state = opt.init(params)
        state["sh_rms"].copy_(t(rms))
        opt.step(params, state, 0.3, 1e-2)
        jp, jst = JaxOptim(0.95).step(
            {k: j(v) for k, v in p.items()}, {k: j(v) for k, v in g.items()},
            {"sh_rms": j(rms)}, jnp.float32(0.3), jnp.float32(1e-2))
        for k in p:
            np.testing.assert_allclose(n(params[k]), n(jp[k]), rtol=1e-6)
        np.testing.assert_allclose(n(state["sh_rms"]), n(jst["sh_rms"]),
                                   rtol=1e-6)


def test_svox_dataset_batches_match_jax(synthetic_scene):
    """SvoxNeRFDataset: the images, each test image's rays and the first
    batches (over a reshuffle of the 12 x 64 x 64 pool) equal the JAX
    loader's bit for bit."""
    from jnerf_tpu.dataset.svox_dataset import SvoxNeRFDataset as JaxDS
    from jnerf_tpu_torch.dataset import SvoxNeRFDataset

    for split in ("train", "test"):
        a = SvoxNeRFDataset(synthetic_scene, split=split, device="cpu")
        b = JaxDS(synthetic_scene, split=split)
        assert (a.n_images, a.H, a.W) == (b.n_images, b.H, b.W)
        for i in range(a.n_images):
            np.testing.assert_array_equal(a.image(i), b.image(i))
        for x, y in zip(a.rays_for_image(0), b.rays_for_image(0)):
            np.testing.assert_array_equal(n(x), n(y))
        bs = 20000 if split == "train" else 1000
        for _ in range(4):
            for x, y in zip(a.next_batch(bs), b.next_batch(bs)):
                np.testing.assert_array_equal(n(x), n(y))


def _svox_cfgs(tmp_path, scene, **extra):
    from jnerf_tpu.utils.config import init_cfg as jax_init
    from jnerf_tpu_torch.utils.config import init_cfg

    path = write_svox2_cfg(tmp_path, scene, **extra)
    jax_init(path)
    init_cfg(path)
    return path


def _seed_grid(tr, jr, seed=10):
    """Give both runners the same random dense grid (the init is flat)."""
    rng = np.random.default_rng(seed)
    d = rng.uniform(0, 3, tr.grid.density.shape).astype(np.float32)
    s = (rng.normal(size=tr.grid.sh.shape) * 0.3).astype(np.float32)
    with torch.no_grad():
        tr.grid.density.copy_(t(d))
        tr.grid.sh.copy_(t(s))
    jr.params = {"density": j(d), "sh": j(s)}


class _GradCapture:
    """The JAX runner's PlenOptim, keeping the step's gradients in its
    state so that the test can read them."""

    def __init__(self, optim):
        self.optim = optim

    def init(self, params):
        return self.optim.init(params)

    def step(self, params, grads, state, lr_sigma, lr_sh):
        params, state = self.optim.step(params, grads, state, lr_sigma, lr_sh)
        return params, dict(state, grads=grads)


def _jax_step(jr, ro, rd, rgb, step):
    """One JAX step at ``step``'s learning rates and key; returns its MSE
    and gradients."""
    jr.optim = _GradCapture(jr.optim)
    fn = jr._build_train_step()
    jr.params, state, mse = fn(
        jr.params, jr.opt_state, jr.aux, j(ro), j(rd), j(rgb),
        jnp.float32(jr.lr_sigma_fn(step)), jnp.float32(jr.lr_sh_fn(step)),
        jax.random.PRNGKey(step))
    jr.optim = jr.optim.optim
    jr.opt_state = {"sh_rms": state["sh_rms"]}
    return mse, state["grads"]


def _assert_step(tr, jr, mse, jmse, jgrads, lr_sh):
    """The MSE at rtol 1e-5; each table's gradient within 1e-5 of its
    largest entry; density after the SGD step at rtol 1e-5 / atol 1e-6;
    SH after the RMSprop step within 1e-2 * lr_sh: at the first step an
    entry moves by lr_sh * g / (0.2236 |g| + 1e-8), which is +-4.47 lr_sh
    for |g| >> 1e-8 but, where g nearly cancels, moves by up to lr_sh *
    |dg| / 1e-8 with the summation order's dg; the RMS state within 1e-5
    of its largest entry."""
    np.testing.assert_allclose(float(mse), float(jmse), rtol=1e-5)
    got = tr.grid.tables()
    assert set(got) == set(jr.params)
    for k, v in got.items():
        _assert_grad(n(v.grad), n(jgrads[k]), k)
        ref = n(jr.params[k])
        if k.startswith("density"):
            np.testing.assert_allclose(n(v), ref, rtol=1e-5, atol=1e-6,
                                       err_msg=k)
        else:
            np.testing.assert_allclose(n(v), ref, rtol=0, atol=1e-2 * lr_sh,
                                       err_msg=k)
    ref = n(jr.opt_state["sh_rms"])
    np.testing.assert_allclose(n(tr.opt_state["sh_rms"]), ref, rtol=0,
                               atol=1e-5 * float(ref.max()))


def _assert_tables(tr, jr, rtol=1e-5, atol=1e-6):
    got = tr.grid.tables()
    assert set(got) == set(jr.params)
    for k, v in got.items():
        np.testing.assert_allclose(n(v), n(jr.params[k]), rtol=rtol,
                                   atol=atol, err_msg=k)


def test_one_svox2_step_matches_jax(tmp_path, synthetic_scene, clear_cfgs):
    """One Svox2Runner step at reso 24 (svox2_base.py's rates and TV
    weights, 512 rays of 96 samples) from the same random grid and batch:
    the learning rates, then the MSE, the gradients, both tables and the
    RMS state after the update (`_assert_step`)."""
    from jnerf_tpu.runner.svox2_runner import Svox2Runner as JaxRunner
    from jnerf_tpu_torch.runner import Svox2Runner

    _svox_cfgs(tmp_path, synthetic_scene)
    jr, tr = JaxRunner(), Svox2Runner(device="cpu")
    _seed_grid(tr, jr)
    ro, rd, rgb = tr.dataset["train"].next_batch(512)
    jb = jr.dataset["train"].next_batch(512)
    for a, b in zip((ro, rd, rgb), jb):
        np.testing.assert_array_equal(n(a), n(b))
    assert tr.lr_sigma_fn(0) == pytest.approx(float(jr.lr_sigma_fn(0)), rel=1e-6)
    jmse, jgrads = _jax_step(jr, ro, rd, rgb, 0)
    mse = tr.train_step(ro, rd, rgb, tr.lr_sigma_fn(0), tr.lr_sh_fn(0))
    _assert_step(tr, jr, mse, jmse, jgrads, tr.lr_sh_fn(0))


def test_sparse_upsample_and_step_match_jax(tmp_path, synthetic_scene,
                                            clear_cfgs):
    """The upsample that crosses a forced-low sparse_cell_threshold (as in
    tests/test_svox2.py's sparse test: 24^3 -> 48^3, threshold 30000,
    dilate 1) from the same random grid: equal links and cells, the
    density table within the resize's 1e-5 and the SH table (sampled at
    ids * 23/47) at rtol 1e-5; then one sparse step with the JAX key's TV
    rows passed in (`_assert_step`), and the render of test image 0."""
    from jnerf_tpu.runner.svox2_runner import Svox2Runner as JaxRunner
    from jnerf_tpu_torch.runner import Svox2Runner

    _svox_cfgs(tmp_path, synthetic_scene, sparse_cell_threshold=30000,
               density_thresh=2.4, sparse_dilate=1, lambda_tv=1e-5,
               lambda_tv_sh=1e-3)
    jr, tr = JaxRunner(), Svox2Runner(device="cpu")
    _seed_grid(tr, jr)
    tr.upsample((48, 48, 48))
    jr.params, jr.aux = jr.grid.upsample(jr.params, (48, 48, 48))
    jr.opt_state = jr.optim.init(jr.params)
    assert tr.grid.sparse and jr.grid.sparse
    np.testing.assert_array_equal(n(tr.grid.links), np.asarray(jr.aux["links"]))
    np.testing.assert_array_equal(n(tr.grid.cells), np.asarray(jr.aux["cells"]))
    n_active = int((n(tr.grid.cells) >= 0).sum())
    assert 0 < n_active < 48 ** 3
    g, w = tr.grid.tables(), jr.params
    np.testing.assert_allclose(n(g["density_data"]), n(w["density_data"]),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(n(g["sh_data"]), n(w["sh_data"]), rtol=1e-5,
                               atol=1e-6)
    # Carry the JAX resize's density over, then step both.
    with torch.no_grad():
        g["density_data"].copy_(t(n(w["density_data"])))
    ro, rd, rgb = tr.dataset["train"].next_batch(512)
    jr.dataset["train"].next_batch(512)
    k_tv, k_tvc = jax.random.split(jax.random.PRNGKey(5))
    cap = tr.grid.cells.shape[0]
    rows = tuple(t(np.asarray(jax.random.randint(k, (m,), 0, cap)))
                 for k, m in ((k_tv, 1 << 18), (k_tvc, 1 << 16)))
    jmse, jgrads = _jax_step(jr, ro, rd, rgb, 5)
    mse = tr.train_step(ro, rd, rgb, tr.lr_sigma_fn(5), tr.lr_sh_fn(5),
                        tv_rows=rows)
    _assert_step(tr, jr, mse, jmse, jgrads, tr.lr_sh_fn(5))
    img = tr.render_image(tr.dataset["test"], 0)
    jimg = jr.render_image(jr.dataset["test"], 0)
    assert img.shape == (64, 64, 3)
    np.testing.assert_allclose(img, jimg, rtol=0, atol=1e-5)


@pytest.mark.parametrize("sparse", [False, True])
def test_npz_passes_both_ways(tmp_path, synthetic_scene, clear_cfgs, sparse):
    """A grid saved by either package loads into the other (dense at 24^3;
    sparse at 48^3 past a threshold of 30000 cells): the same tables,
    links and cells, and the same frame (radius, center)."""
    from jnerf_tpu.runner.svox2_runner import Svox2Runner as JaxRunner
    from jnerf_tpu_torch.runner import Svox2Runner

    _svox_cfgs(tmp_path, synthetic_scene, sparse_cell_threshold=30000,
               density_thresh=2.4, sparse_dilate=1)
    jr, tr = JaxRunner(), Svox2Runner(device="cpu")
    _seed_grid(tr, jr)
    if sparse:
        tr.upsample((48, 48, 48))
        jr.params, jr.aux = jr.grid.upsample(jr.params, (48, 48, 48))
    p_port, p_jax = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    tr.save(p_port)
    jr.save(p_jax)
    a, b = np.load(p_port), np.load(p_jax)
    assert set(a.files) == set(b.files)
    for k in ("radius", "center", "links", "basis_type"):
        np.testing.assert_array_equal(a[k], b[k])
    for k in ("density_data", "sh_data"):
        assert a[k].dtype == np.float16
        np.testing.assert_allclose(a[k].astype(np.float32),
                                   b[k].astype(np.float32), rtol=0,
                                   atol=2e-3)
    tr.load(p_jax)
    jr.load(p_port)
    assert tr.grid.sparse == jr.grid.sparse == sparse
    _assert_tables(tr, jr, rtol=0, atol=2e-3)
    if sparse:
        np.testing.assert_array_equal(n(tr.grid.links), np.asarray(jr.aux["links"]))
        np.testing.assert_array_equal(n(tr.grid.cells), np.asarray(jr.aux["cells"]))
    np.testing.assert_array_equal(tr.grid.radius, jr.grid.radius)


# The port's versions of tests/test_svox2.py's voxel-op tests.
class TestVoxelOps:
    def test_sh_basis_constant_and_norm(self):
        rng = np.random.default_rng(0)
        v = rng.normal(size=(1000, 3))
        v /= np.linalg.norm(v, axis=-1, keepdims=True)
        b = n(tv.eval_sh_basis(9, t(v)))
        np.testing.assert_allclose(b[:, 0], 0.28209479177387814, rtol=1e-6)
        gram = b.T @ b / len(b) * 4 * np.pi
        np.testing.assert_allclose(gram, np.eye(9), atol=0.2)

    def test_trilinear_sample_linear_field(self):
        spec = tv.VoxelGridSpec((8, 8, 8), 1)
        g = np.arange(8, dtype=np.float32)
        density = g[:, None, None] + 2 * g[None, :, None] + 3 * g[None, None, :]
        sh = np.zeros((8, 8, 8, 3), np.float32)
        pts = np.random.default_rng(1).uniform(0.5, 6.5, (32, 3)).astype(np.float32)
        sigma, _ = tv.trilinear_sample(spec, t(density), t(sh), t(pts))
        expect = pts[:, 0] + 2 * pts[:, 1] + 3 * pts[:, 2]
        np.testing.assert_allclose(n(sigma), expect, rtol=1e-4)

    def test_render_opaque_cell(self):
        spec = tv.VoxelGridSpec((16, 16, 16), 1)
        density = np.zeros((16, 16, 16), np.float32)
        density[8:11, 8:11, 8:11] = 1e4
        sh = np.zeros((16, 16, 16, 3), np.float32)
        sh[8:11, 8:11, 8:11, :] = 3.0 / 0.28209479177387814
        rd = torch.tensor([[0.0, 0.0, 1.0]])
        rgb = tv.render_rays_grid(spec, t(density), t(sh),
                                  torch.tensor([[8.0, 8.0, 0.0]]), rd, 64, 0.5,
                                  background_brightness=0.0)
        assert float(rgb[0, 0]) > 0.5
        rgb2 = tv.render_rays_grid(spec, t(density), t(sh),
                                   torch.tensor([[1.0, 1.0, 0.0]]), rd, 64,
                                   0.5, background_brightness=0.7)
        np.testing.assert_allclose(n(rgb2[0]), 0.7, atol=1e-3)

    def test_tv_zero_for_constant(self):
        g = torch.full((8, 8, 8), 3.0)
        assert float(tv.total_variation(g)) == 0.0
        g[4, 4, 4] = 5.0
        assert float(tv.total_variation(g)) > 0

    def test_upsample_preserves_constant(self):
        d2, sh2 = tv.upsample_grid(torch.full((8, 8, 8), 2.0),
                                   torch.full((8, 8, 8, 27), 0.5), (16, 16, 16))
        assert tuple(d2.shape) == (16, 16, 16)
        assert tuple(sh2.shape) == (16, 16, 16, 27)
        np.testing.assert_allclose(n(d2), 2.0, atol=1e-5)

"""The ports of the archived probes that make no ``pallas_call`` of their
own, on the op level (`jnerf_tpu_torch/tools/archive/probe_{march,
fused_mlp,f4,nbr,nbr2,fwd2,bwd_debug}.py`), on the CPU and against the
JAX package.

Each probe's main runs with ``--cpu`` at a tiny size (its module
constants patched, one rep a timing) and prints the archive's lines under
its names; a section without a counterpart prints its line and, asked for
alone, exits with status 2.  On the same seeded numpy inputs, the
probes' functions are held to the JAX package: probe_march's ``full``
samples to `jnerf_tpu/ops/ray_march.py::sample_rays` (the JAX key's
start jitter passed in; integer fields equal, positions, directions and
steps at atol 1e-6, as `tests/test_torch_march.py` holds the march),
probe_fused_mlp's plain chain to the archive's own ``jnp_forward`` (loaded
from the archived file by ``ast``) at atol 2e-3, the JAX fused-MLP tests'
forward tolerance, probe_nbr2's ``idxw`` stage to
``hash_nbr._entry_indices`` (base entries equal; corner weights at atol
2e-3, the hash tests' forward tolerance: XLA on the CPU may fuse
``p * scale + 0.5`` into one multiply-add and move a fraction by an ulp
of q), and the specs of probe_f4 and probe_bwd_debug to ``HashGridSpec``.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jnerf_tpu.ops import hash_nbr as jax_hash_nbr
from jnerf_tpu.ops import occupancy as jocc
from jnerf_tpu.ops import ray_march as jmarch
from jnerf_tpu.ops.hash_grid import HashGridSpec as JaxSpec
from jnerf_tpu_torch.tools.archive import common
from torch_parity import archived_kernels, n, t, two_threads  # noqa: F401

TINY = {
    "probe_march": dict(R=64, S=16, GRID=32, MAX_STEPS=128),
    "probe_fused_mlp": dict(N=1024),
    "probe_f4": dict(N=512, LOG2=12, SPECS={"F4L8": (8, 4, 1 << 10),
                                            "F2L16": (16, 2, 1 << 11)}),
    "probe_nbr": dict(N=512, LOG2=12),
    "probe_nbr2": dict(N=512, LOG2=12, CAP=1 << 11),
    "probe_fwd2": dict(N=512, LOG2=12, CAP=1 << 11),
    "probe_bwd_debug": dict(LOG2=12, GUARD=64, CASES={
        "cap18-small": (1 << 11, 256), "cap18-full": (1 << 11, 1024),
        "nocap-small": (None, 256)}),
}
ARGS = {"probe_fused_mlp": ["jf", "ff", "jg", "fg", "fd"],
        "probe_f4": ["F4L8", "F2L16"]}
LINES = {
    "probe_march": ["full sample_rays", "no occupancy gather",
                    "no first_s (arange idx)"],
    "probe_fused_mlp": ["jf", "ff", "jg", "fg", "fd"],
    "probe_f4": ["F4L8 fwd", "F4L8 fwd+bwd", "F2L16 fwd", "F2L16 fwd+bwd"],
    "probe_nbr": ["nbr fwd", "nbr fwd+bwd", "rows_fwd", "rows_bwd"],
    "probe_nbr2": ["build", "index+weights", "bare row gather [N*L,16]",
                   "fullpre", "full fwd", "fwd+bwd"],
    "probe_fwd2": ["idx", "take", "blend", "asm"],
    "probe_bwd_debug": ["cap18-small", "cap18-full", "nocap-small"],
}
ALONE = {"probe_nbr": ["rows_bwd"], "probe_nbr2": ["fullpre"],
         "probe_fwd2": ["asm"]}


def _module(name):
    return importlib.import_module(f"jnerf_tpu_torch.tools.archive.{name}")


@pytest.fixture()
def tiny(monkeypatch):
    monkeypatch.setattr(common, "REPS", 1)

    def shrink(name):
        mod = _module(name)
        for k, v in TINY.get(name, {}).items():
            monkeypatch.setattr(mod, k, v)
        return mod

    return shrink


@pytest.mark.parametrize("name", sorted(LINES))
def test_probe_runs_on_the_cpu(tiny, name, capsys):
    """--cpu at a tiny size: the archive's lines in its order, each timed
    line with a positive host time, each section without a counterpart
    naming its JAX symbol, every correctness flag True."""
    lines = tiny(name).main(ARGS.get(name, []) + ["--cpu"])
    assert [ln["name"] for ln in lines] == LINES[name]
    for ln in lines:
        if "no_counterpart" in ln:
            assert ln["no_counterpart"].startswith("jnerf_tpu.ops.")
        else:
            assert ln["ms"] > 0 and ln["clock"] == "host"
            assert ln.get("ok", True) is True
    out = capsys.readouterr().out
    assert out.startswith("card: cpu\n")
    assert "no counterpart" in out or not any(
        "no_counterpart" in ln for ln in lines)


@pytest.mark.parametrize("name", sorted(ALONE))
def test_a_section_without_a_counterpart_alone_exits_2(tiny, name, capsys):
    with pytest.raises(SystemExit) as e:
        tiny(name).main(ALONE[name] + ["--cpu"])
    assert e.value.code == common.NO_COUNTERPART
    assert "no counterpart" in capsys.readouterr().out


def test_probe_march_sections_swap_and_restore(tiny):
    """noocc occupies every cell and nofirst keeps the first S candidates:
    both change the samples; the swapped functions are put back."""
    from jnerf_tpu_torch.ops import occupancy, ray_march

    real = (occupancy.occupancy_at_xyz, ray_march.occupancy_at_xyz,
            ray_march._first_s_indices)
    lines = {ln["name"]: ln for ln in tiny("probe_march").main(["--cpu"])}
    assert (occupancy.occupancy_at_xyz, ray_march.occupancy_at_xyz,
            ray_march._first_s_indices) == real
    assert lines["no occupancy gather"]["valid"] > \
        lines["full sample_rays"]["valid"] > 0


def test_probe_march_full_matches_jax(tiny):
    """``full`` at a 32^3 grid against the JAX march, the JAX key's start
    jitter passed in."""
    pm = tiny("probe_march")
    cfg = pm.march_config()
    jg = jocc.make_grid_config((0.0, 1.0), pm.GRID, pm.MAX_STEPS)
    jc = jmarch.MarchConfig(grid=jg, near_distance=0.05, cone_angle=0.0,
                            const_dt=True)
    assert (jc.n_candidates, jc.probe_stride) == (cfg.n_candidates,
                                                  cfg.probe_stride)
    bits, ro, rd, _ = pm.inputs(cfg)
    key = jax.random.PRNGKey(3)
    u = n(jax.random.uniform(key, (pm.R,)))
    ref = jax.jit(jmarch.sample_rays, static_argnums=(0, 5))(
        jc, jnp.asarray(bits), jnp.asarray(ro), jnp.asarray(rd), key, pm.S)
    got = pm.full(cfg, t(bits), t(ro), t(rd), t(u))
    for field in ("valid", "numsteps", "truncated", "count"):
        np.testing.assert_array_equal(n(getattr(got, field)),
                                      n(getattr(ref, field)), err_msg=field)
    assert int(n(got.valid).sum()) > 0
    for field in ("positions", "dirs", "dts"):
        np.testing.assert_allclose(n(getattr(got, field)),
                                   n(getattr(ref, field)), rtol=0, atol=1e-6,
                                   err_msg=field)


def test_probe_fused_mlp_plain_chain_is_the_archives(tiny):
    """The port's plain chain against the archived file's own
    ``jnp_forward`` on the same numpy weights and rows."""
    pf = tiny("probe_fused_mlp")
    ns, _ = archived_kernels("tools/archive/probe_fused_mlp.py",
                             ["jnp_forward"])
    w, x, d, _ = pf.inputs()
    ref = n(ns["jnp_forward"](tuple(map(jnp.asarray, w)), jnp.asarray(x),
                              jnp.asarray(d)))
    got = n(pf.plain_forward(tuple(map(t, w)), t(x), t(d)))
    assert got.shape == ref.shape == (pf.N, 4)
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-3)


def test_probe_fused_mlp_checks_fail_on_a_wrong_kernel(tiny, monkeypatch):
    """A fused forward off by more than the JAX tests' tolerance reads
    False."""
    from jnerf_tpu_torch.ops import fused_mlp as fm

    real = fm.fused_ngp_mlp
    monkeypatch.setattr(fm, "fused_ngp_mlp",
                        lambda w, x, d: real(w, x, d) + 0.01)
    lines = tiny("probe_fused_mlp").main(["ff", "--cpu"])
    assert [ln["ok"] for ln in lines] == [False]


def test_probe_nbr2_index_weights_match_jax(tiny):
    """The idxw stage's base entries equal ``_entry_indices``' and its
    corner weights are the JAX fractions' trilinear weights."""
    pn = tiny("probe_nbr2")
    pos = common.uniform((pn.N, 3), seed=1)
    spec = pn.spec_of()
    js = JaxSpec(n_levels=pn.LEVELS, log2_hashmap_size=pn.LOG2,
                 max_level_size=pn.CAP)
    e0_ref, fr = jax_hash_nbr._entry_indices(js, jnp.asarray(pos))
    e0, w, entries = pn.index_weights(spec, t(pos))
    np.testing.assert_array_equal(n(e0), n(e0_ref))
    f = [n(a) for a in fr]
    want = np.stack([np.prod([f[a] if (c >> a) & 1 else 1.0 - f[a]
                              for a in range(3)], axis=0)
                     for c in range(8)], axis=-1)
    np.testing.assert_allclose(n(w), want, rtol=0, atol=2e-3)
    offs = np.asarray(spec.level_offsets[:-1])
    assert n(entries).min() >= 0
    assert (n(entries) - offs[None, :, None] <
            np.asarray(spec.level_sizes)[None, :, None]).all()


@pytest.mark.parametrize("tag", ["F4L8", "F2L16"])
def test_probe_f4_specs_match_jax(tag):
    levels, feats, cap = _module("probe_f4").SPECS[tag]
    got = _module("probe_f4").spec_of(tag)
    ref = JaxSpec(n_levels=levels, n_features_per_level=feats,
                  log2_hashmap_size=19, max_level_size=cap)
    assert (got.n_entries, got.level_sizes) == (ref.n_entries,
                                                ref.level_sizes)


@pytest.mark.parametrize("case", ["cap18-small", "cap18-full", "nocap-small"])
def test_probe_bwd_debug_specs_match_jax(case):
    pb = _module("probe_bwd_debug")
    cap, _ = pb.CASES[case]
    got = pb.spec_of(case)
    ref = JaxSpec(n_levels=16, log2_hashmap_size=19, max_level_size=cap)
    assert (got.n_entries, got.level_sizes) == (ref.n_entries,
                                                ref.level_sizes)


def test_probe_bwd_debug_fails_on_a_wrong_gradient(tiny, monkeypatch,
                                                   capsys):
    """A kernel B that writes another gradient prints FAILED and exits 1."""
    from jnerf_tpu_torch.ops import hash_nbr

    real = hash_nbr.grad_table
    monkeypatch.setattr(hash_nbr, "grad_table",
                        lambda *a, **k: real(*a, **k).mul_(2.0))
    with pytest.raises(SystemExit) as e:
        tiny("probe_bwd_debug").main(["cap18-small", "--cpu"])
    assert e.value.code == 1
    assert "cap18-small: FAILED" in capsys.readouterr().out


def test_grad_table_writes_into_the_given_buffers():
    """``grad_table(out=...)`` returns ``out`` holding the twin's
    gradient."""
    from jnerf_tpu_torch.ops import hash_nbr
    from jnerf_tpu_torch.ops.hash_grid import HashGridSpec

    spec = HashGridSpec(n_levels=4, log2_hashmap_size=10)
    pos = t(common.uniform((128, 3)))
    g = t(common.normal((128, spec.out_dim), seed=1))
    out = torch.full((spec.n_entries, 2), -7.0)
    got = hash_nbr.grad_table(spec, pos, g, out=out)
    assert got is out
    assert torch.equal(out, hash_nbr.grad_table_plain(spec, pos, g))

"""The port's reference-checkpoint converters (`jnerf_tpu_torch/utils/
convert_ckpt.py`): tests/test_convert_ckpt.py's checks on the port, and
the same outputs as the JAX package's copy for the same inputs."""

import warnings

import numpy as np
import pytest

from jnerf_tpu.utils import convert_ckpt as J
from jnerf_tpu_torch.utils import convert_ckpt as P


def _equal(fn_name, *args, **kw):
    got = getattr(P, fn_name)(*args, **kw)
    ref = getattr(J, fn_name)(*args, **kw)
    if isinstance(ref, (tuple, list)):
        for a, b in zip(got, ref):
            _equal_tree(a, b)
    else:
        _equal_tree(got, ref)
    return got


def _equal_tree(a, b):
    if isinstance(b, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal_tree(x, y)
    elif isinstance(b, dict):
        assert a.keys() == b.keys()
        for k in b:
            _equal_tree(a[k], b[k])
    else:
        np.testing.assert_array_equal(a, b)
        assert np.asarray(a).dtype == np.asarray(b).dtype


def test_morton_roundtrip_and_known_values():
    rng = np.random.default_rng(0)
    x, y, z = (rng.integers(0, 128, 1000, dtype=np.uint32) for _ in range(3))
    code = _equal("morton3d", x, y, z)
    np.testing.assert_array_equal(P.morton3d_invert(code), x)
    np.testing.assert_array_equal(_equal("morton3d_invert", code >> np.uint32(1)), y)
    np.testing.assert_array_equal(P.morton3d_invert(code >> np.uint32(2)), z)
    assert [int(P.morton3d(*c)) for c in
            ((1, 0, 0), (0, 1, 0), (0, 0, 1), (1, 1, 1), (2, 0, 0))] == \
        [1, 2, 4, 7, 8]


def test_density_grid_and_bitfield_roundtrips():
    rng = np.random.default_rng(1)
    grid = rng.normal(size=(2, 32, 32, 32)).astype(np.float32)
    flat = _equal("density_grid_to_reference", grid)
    np.testing.assert_array_equal(_equal("density_grid_from_reference", flat,
                                         2, 32), grid)
    assert flat[0] == grid[0, 0, 0, 0] and flat[7] == grid[0, 1, 1, 1]
    bf = rng.uniform(size=(3, 16, 16, 16)) < 0.2
    packed = _equal("bitfield_to_reference", bf)
    assert packed.dtype == np.uint8 and len(packed) == 3 * 16 ** 3 // 8
    np.testing.assert_array_equal(_equal("bitfield_from_reference", packed,
                                         3, 16), bf)


def test_hash_table_roundtrip_and_indexing_warning():
    """The flat fp16 table maps to [n, 2] f32 and back; a target encoder
    that does not index with 'xor' gets the JAX package's warning."""
    flat = np.random.default_rng(3).normal(size=4096).astype(np.float16)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        table = _equal("hash_table_from_reference", flat)
    assert table.shape == (2048, 2)
    np.testing.assert_array_equal(_equal("hash_table_to_reference", table), flat)
    with pytest.warns(UserWarning, match="hash_indexing='xor'"):
        P.hash_table_from_reference(flat, "linear_rows")


def test_fmlp_and_permutation():
    """The FMLP vector (the reference pads the rgb head to 16) unpacks
    exactly, and the density-input permutation and NGP unpacking equal the
    JAX package's."""
    np.testing.assert_array_equal(_equal("density_input_permutation", 4),
                                  [0, 2, 4, 6, 1, 3, 5, 7])
    rng = np.random.default_rng(0)
    dims = (32, 64, 64, 3)
    layers = [{"w": rng.standard_normal((dims[i], dims[i + 1]))
               .astype(np.float16).astype(np.float32)} for i in range(3)]
    vec = _equal("fmlp_to_reference", layers)
    assert vec.dtype == np.float16 and vec.size == 32 * 64 + 64 * 64 + 64 * 16
    for a, b in zip(layers, _equal("fmlp_from_reference", vec, dims)):
        np.testing.assert_array_equal(a["w"], b["w"])
    dvec = rng.standard_normal(32 * 64 + 64 * 16).astype(np.float16)
    rvec = rng.standard_normal(32 * 64 + 64 * 64 + 64 * 16).astype(np.float16)
    density, rgb = _equal("ngp_mlps_from_reference", dvec, rvec, n_levels=16)
    assert [p["w"].shape for p in density] == [(32, 64), (64, 16)]
    assert [p["w"].shape for p in rgb] == [(32, 64), (64, 64), (64, 3)]

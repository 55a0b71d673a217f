"""The port's `utils/general.py` and `utils/common.py` against the JAX
package's on the CPU: equal results on the same inputs, exactly."""

import random

import numpy as np
import pytest

from torch_parity import j, n, t

from jnerf_tpu.utils import common as jc, general as jg
from jnerf_tpu_torch.utils import common as tc, general as tg


def test_search_ckpt(tmp_path):
    """The highest iteration of ``{prefix}{iter}{suffix}`` files, other
    names ignored; None for an empty or a missing directory."""
    assert tg.search_ckpt(str(tmp_path)) is None
    assert tg.search_ckpt(str(tmp_path / "missing")) is None
    for name in ("ckpt_000100.pkl", "ckpt_002000.pkl", "ckpt_000999.pkl",
                 "ckpt_003000.pkl.tmp", "other_009999.pkl", "ckpt_.pkl",
                 "model_000500.pth", "model_000042.pth"):
        (tmp_path / name).write_bytes(b"")
    for args in ((), ("model_", ".pth"), ("other_",), ("none_",)):
        got = tg.search_ckpt(str(tmp_path), *args)
        assert got == jg.search_ckpt(str(tmp_path), *args), args
    assert tg.search_ckpt(str(tmp_path)) == "ckpt_002000.pkl"
    assert tg.search_ckpt(str(tmp_path), "model_", ".pth") == \
        "model_000500.pth"


def test_check_file_and_dir(tmp_path):
    f = tmp_path / "a.py"
    f.write_text("")
    for path, ext in ((str(f), None), (str(f), [".py"]), (str(f), [".pkl"]),
                      (str(tmp_path), None), ("", None),
                      (str(tmp_path / "b.py"), None)):
        assert tg.check_file(path, ext) == jg.check_file(path, ext)
    assert tg.check_file(str(f), [".py"]) and not tg.check_file("", None)
    assert tg.check_dir(str(tmp_path)) and not tg.check_dir(str(f))
    new = tmp_path / "x" / "y"
    assert not tg.check_dir(str(new))
    assert tg.check_dir(str(new), make=True) and new.is_dir()


def test_set_random_seed():
    """The host RNGs give the JAX package's draws after either seeding."""
    draws = []
    for mod in (jg, tg):
        mod.set_random_seed(123)
        draws.append((random.random(), np.random.rand(3).tolist()))
    assert draws[0] == draws[1]


@pytest.mark.parametrize("shape,size", [((5,), 8), ((5, 3), 9), ((6, 2), 4),
                                        ((0, 4), 3)])
@pytest.mark.parametrize("dtype", [np.float32, np.int32, np.bool_])
def test_enlarge(shape, size, dtype):
    """Grown to ``size`` rows with zeros of the same dtype, or returned as
    it is when already that long."""
    arr = (np.arange(int(np.prod(shape))).reshape(shape) % 3).astype(dtype)
    got = tc.enlarge(t(arr), size)
    want = n(jc.enlarge(j(arr), size))
    assert got.dtype == t(want).dtype and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(n(got), want)
    if shape[0] >= size:
        x = t(arr)
        assert tc.enlarge(x, size) is x


def test_bounding_box():
    """contains, diag and relative_pos as the JAX package's box."""
    boxes = [(jc.BoundingBox(), tc.BoundingBox()),
             (jc.BoundingBox((-1, -2, 0.5), (1, 2, 3)),
              tc.BoundingBox((-1, -2, 0.5), (1, 2, 3)))]
    rng = np.random.default_rng(0)
    pts = rng.uniform(-2.5, 3.5, (64, 3)).astype(np.float32)
    for jb, tb in boxes:
        np.testing.assert_array_equal(tb.min, jb.min)
        np.testing.assert_array_equal(tb.diag(), jb.diag())
        for p in pts:
            assert tb.contains(p) == jb.contains(p)
        np.testing.assert_array_equal(tb.relative_pos(pts),
                                      jb.relative_pos(pts))
    assert boxes[0][1].contains((0.5, 0.5, 0.5))
    assert not boxes[0][1].contains((0.5, 1.5, 0.5))

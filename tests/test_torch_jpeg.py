"""The port's JPEG codec (`dataset/jpeg.py`, `csrc/jpeg.cpp`) against the
JAX package's reads and writes: the decoder gives the JAX package's
``read_image`` pixels (imageio through PIL, libjpeg-turbo) bit for bit,
and ``cv2.imread``'s, on files that PIL and cv2 write here; the encoder's
files decode in PIL to the pixels of imageio's file of the same array and
quality; unsupported kinds raise."""

import io

import cv2
import numpy as np
import pytest
from PIL import Image

from jnerf_tpu.dataset import dataset_util as jdu
from jnerf_tpu_torch.dataset import dataset_util as du
from jnerf_tpu_torch.dataset.jpeg import decode_jpeg, encode_jpeg


def _image(h, w, channels=3, seed=0):
    """Smooth colour ramps plus noise: every DCT band carries energy."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    base = np.stack([np.sin(x / 7.0 + k) * 100 + 120 + np.cos(y / 5.0) * 20
                     for k in range(channels)], -1)
    return np.clip(base + rng.normal(0, 12, base.shape), 0, 255).astype(np.uint8)


def _pil(h, w, **kw):
    buf = io.BytesIO()
    Image.fromarray(_image(h, w)).save(buf, format="JPEG", **kw)
    return buf.getvalue()


def _grey():
    buf = io.BytesIO()
    Image.fromarray(_image(40, 52, 1)[..., 0]).save(buf, format="JPEG",
                                                    quality=85)
    return buf.getvalue()


def _cv2(h, w, sampling):
    ok, data = cv2.imencode(".jpg", _image(h, w), [
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR, sampling,
        cv2.IMWRITE_JPEG_QUALITY, 90])
    assert ok
    return data.tobytes()


def _exif():
    exif = Image.Exif()
    exif[0x0112] = 6  # orientation: rotate 90 on display
    buf = io.BytesIO()
    Image.fromarray(_image(8, 16)).save(buf, format="JPEG", quality=90,
                                        exif=exif.tobytes())
    return buf.getvalue()


# name -> the file's bytes.  PIL's subsampling 0/1/2 is 4:4:4/4:2:2/4:2:0.
CASES = {
    "q50": lambda: _pil(48, 64, quality=50),
    "q75": lambda: _pil(48, 64, quality=75),
    "q95": lambda: _pil(48, 64, quality=95),
    "q100": lambda: _pil(48, 64, quality=100),
    "444": lambda: _pil(40, 56, quality=90, subsampling=0),
    "422": lambda: _pil(40, 56, quality=90, subsampling=1),
    "420": lambda: _pil(40, 56, quality=90, subsampling=2),
    "440": lambda: _cv2(37, 45, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440),
    "grey": _grey,
    "optimize": lambda: _pil(48, 64, quality=90, optimize=True),
    "progressive": lambda: _pil(48, 64, quality=90, progressive=True),
    "progressive_422": lambda: _pil(33, 70, quality=80, progressive=True,
                                    subsampling=1),
    "restart": lambda: _pil(48, 64, quality=90, restart_marker_blocks=3),
    "adobe_rgb": lambda: _pil(24, 40, quality=90, keep_rgb=True),
    "1x1": lambda: _pil(1, 1, quality=95),
    "17x33": lambda: _pil(17, 33, quality=95),
    "250x7": lambda: _pil(250, 7, quality=95),
    "exif_orientation": _exif,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_decoder_equals_the_jax_read(tmp_path, case):
    """read_image of a .jpg equals the JAX package's read_image bit for
    bit (an EXIF orientation is ignored by both: 8 x 16 stays 8 x 16)."""
    path = str(tmp_path / f"{case}.jpg")
    with open(path, "wb") as f:
        f.write(CASES[case]())
    got = du.read_image(path)
    np.testing.assert_array_equal(got, jdu.read_image(path))
    if case == "exif_orientation":
        assert got.shape == (8, 16, 3)


@pytest.mark.parametrize("case", sorted(CASES))
def test_decoder_equals_cv2_imread(tmp_path, case):
    """read_image_u8 equals cv2.imread(IMREAD_UNCHANGED) with its BGR
    reversed (the JAX LLFF minifier's read)."""
    path = str(tmp_path / f"{case}.JPG")
    with open(path, "wb") as f:
        f.write(CASES[case]())
    ref = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if ref.ndim == 3:
        ref = ref[..., ::-1]
    np.testing.assert_array_equal(du.read_image_u8(path), ref)


@pytest.mark.parametrize("size", [(48, 64), (17, 33), (1, 1), (250, 7)])
@pytest.mark.parametrize("quality", [95, 75])
def test_encoder_writes_what_imageio_writes(tmp_path, size, quality):
    """write_image(".jpg") of the port and of the JAX package (imageio)
    decode in PIL to the same pixels; the files are the same bytes."""
    img = _image(*size).astype(np.float32) / 255.0
    port, ref = str(tmp_path / "port.jpg"), str(tmp_path / "jax.jpeg")
    du.write_image(port, img, quality=quality)
    jdu.write_image(ref, img, quality=quality)
    np.testing.assert_array_equal(np.asarray(Image.open(port)),
                                  np.asarray(Image.open(ref)))
    with open(port, "rb") as f, open(ref, "rb") as g:
        assert f.read() == g.read()


def test_encoder_grey_and_round_trip():
    """A grey array encodes as a one-component JPEG that PIL reads as
    PIL's own encoding of it; encode then decode stays within a few
    levels at quality 95."""
    img = _image(30, 41, 1)[..., 0]
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=95)
    data = encode_jpeg(img, 95)
    assert data == buf.getvalue()
    back = decode_jpeg(data)
    assert back.shape == img.shape
    assert np.abs(back.astype(int) - img.astype(int)).mean() < 4


def _patched(data: bytes, marker: int) -> bytes:
    out = bytearray(data)
    i = out.index(b"\xff\xc0")
    out[i + 1] = marker
    return bytes(out)


@pytest.mark.parametrize("kind", ["SOF9", "SOF3", "SOF5", "12-bit", "CMYK"])
def test_unsupported_kinds_raise(tmp_path, kind):
    """Arithmetic coding, lossless, hierarchical, 12-bit and CMYK raise a
    ValueError that names the file and the marker."""
    base = encode_jpeg(_image(16, 16), 90)
    if kind == "CMYK":
        buf = io.BytesIO()
        Image.fromarray(_image(16, 16)).convert("CMYK").save(buf, "JPEG")
        data, match = buf.getvalue(), "4 components in the SOF marker"
    elif kind == "12-bit":
        data = bytearray(base)
        data[data.index(b"\xff\xc0") + 4] = 12
        data, match = bytes(data), "12-bit samples in the SOF marker"
    else:
        code = {"SOF9": 0xC9, "SOF3": 0xC3, "SOF5": 0xC5}[kind]
        data, match = _patched(base, code), f"0xFF{code:02X}, {kind}"
    path = str(tmp_path / "bad.jpg")
    with open(path, "wb") as f:
        f.write(data)
    with pytest.raises(ValueError, match=match) as err:
        du.read_image(path)
    assert path in str(err.value)


def test_decode_time_tool(capsys):
    """tools/jpeg_decode_time.py at a small size: one line, its times."""
    from jnerf_tpu_torch.tools import jpeg_decode_time

    res = jpeg_decode_time.main(["--height", "40", "--width", "64",
                                 "--repeat", "1"])
    assert set(res) == {"encode_ms", "decode_ms", "bytes"}
    assert "64x40 RGB at quality 95" in capsys.readouterr().out

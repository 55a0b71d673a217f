"""The port's image codec (`jnerf_tpu_torch/dataset/dataset_util.py`)
against imageio, PIL and the JAX package's reader: PNG read and written
with the standard library and numpy, and the fp16 ``.bin`` format."""

import io
import struct
import zlib

import imageio.v2 as imageio
import numpy as np
import pytest
from PIL import Image

from jnerf_tpu.dataset import dataset_util as jdu
from jnerf_tpu_torch.dataset import dataset_util as du

SHAPES = {"grey": (19, 23), "grey+alpha": (19, 23, 2), "rgb": (19, 23, 3),
          "rgba": (19, 23, 4), "one pixel": (1, 1, 3), "one column": (7, 1, 4)}


def _image(shape, seed=0):
    """Noise over a smooth ramp: every filter type has work to do."""
    rng = np.random.default_rng(seed)
    ramp = np.add.outer(np.arange(shape[0]) * 9, np.arange(shape[1]) * 5)
    ramp = ramp.reshape(shape[:2] + (1,) * (len(shape) - 2))
    return ((ramp + rng.integers(0, 40, shape)) % 256).astype(np.uint8)


@pytest.mark.parametrize("filter_type", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("kind", list(SHAPES))
def test_each_filter_type_decodes_as_imageio_does(kind, filter_type):
    """Hand-built PNGs with every row under one filter type (None, Sub, Up,
    Average, Paeth) decode to the pixels, bit for bit as imageio decodes
    them."""
    img = _image(SHAPES[kind])
    data = du.encode_png(img, filter_type)
    np.testing.assert_array_equal(du.decode_png(data), img)
    np.testing.assert_array_equal(
        du.decode_png(data), np.asarray(imageio.imread(data, format="png")))


def test_mixed_filter_rows_decode():
    """Rows of different filter types in one image (as libpng's adaptive
    filtering writes them) decode through the wavefront pass."""
    img = _image((31, 17, 4), seed=1)
    rows = [du._filter_rows(img, f).reshape(31, -1) for f in range(5)]
    choice = np.arange(31) % 5
    raw = np.concatenate([choice[:, None].astype(np.uint8),
                          np.stack([rows[f][r] for r, f in enumerate(choice)])],
                         axis=1)
    body = struct.pack(">IIBBBBB", 17, 31, 8, 6, 0, 0, 0)

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data)))

    png = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", body)
           + chunk(b"IDAT", zlib.compress(raw.tobytes())) + chunk(b"IEND", b""))
    np.testing.assert_array_equal(du.decode_png(png), img)


@pytest.mark.parametrize("writer", ["imageio", "PIL"])
@pytest.mark.parametrize("kind", ["grey", "grey+alpha", "rgb", "rgba"])
def test_files_of_other_writers_read_as_imageio_reads_them(tmp_path, writer,
                                                           kind):
    """PNGs written by imageio and by PIL (their own filter choices) read,
    through read_image, exactly as the JAX package's imageio reader reads
    them."""
    img = _image((48, 40) + SHAPES[kind][2:], seed=2)
    path = str(tmp_path / "x.png")
    if writer == "imageio":
        imageio.imwrite(path, img)
    else:
        mode = {"grey": "L", "grey+alpha": "LA", "rgb": "RGB", "rgba": "RGBA"}
        Image.fromarray(img, mode[kind]).save(path)
    got = du.read_image(path)
    np.testing.assert_array_equal(got, jdu.read_image(path))
    assert got.dtype == np.float32 and got.ndim == 3


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_port_written_png_decodes_in_imageio(tmp_path, channels):
    """write_image's PNG decodes in imageio to the input quantized as the
    JAX package's writer quantizes it."""
    rng = np.random.default_rng(3)
    img = rng.uniform(-0.1, 1.1, (21, 18, channels)).astype(np.float32)
    path = str(tmp_path / "y.png")
    du.write_image(path, img)
    want = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    got = np.asarray(imageio.imread(path))
    np.testing.assert_array_equal(got, want[..., 0] if channels == 1 else want)
    # imageio writes no [H, W, 1] array: the JAX writer gets [H, W].
    jdu.write_image(str(tmp_path / "z.png"),
                    img[..., 0] if channels == 1 else img)
    np.testing.assert_array_equal(du.read_image(path),
                                  du.read_image(str(tmp_path / "z.png")))


def test_bin_round_trip_with_the_jax_reader(tmp_path):
    """.bin (fp16 RGBA behind an (h, w) header; RGB is padded with ones)
    written by the port reads the same in the JAX package and back."""
    rng = np.random.default_rng(4)
    img = rng.uniform(0, 1, (9, 11, 3)).astype(np.float32)
    path = str(tmp_path / "a.bin")
    du.write_image(path, img)
    got = jdu.read_image(path)
    assert got.shape == (9, 11, 4)
    np.testing.assert_array_equal(got[..., :3], img.astype(np.float16))
    np.testing.assert_array_equal(got[..., 3], 1.0)
    np.testing.assert_array_equal(du.read_image(path), got)
    jdu.write_image(str(tmp_path / "b.bin"), got)
    np.testing.assert_array_equal(du.read_image(str(tmp_path / "b.bin")), got)


def test_unsupported_pngs_raise(tmp_path):
    """16-bit, palette and interlaced PNGs and a broken CRC raise a clear
    error rather than decoding wrongly."""
    buf = io.BytesIO()
    Image.fromarray(np.full((4, 4), 300, np.uint16)).save(buf, "PNG")
    with pytest.raises(ValueError, match="bit depth 16"):
        du.decode_png(buf.getvalue())
    buf = io.BytesIO()
    Image.fromarray(_image((4, 4, 3))).convert("P").save(buf, "PNG")
    with pytest.raises(ValueError, match="colour type 3"):
        du.decode_png(buf.getvalue())
    ok = du.encode_png(_image((4, 4, 3)))
    interlaced = bytearray(ok)
    interlaced[28] = 1  # IHDR's interlace byte
    with pytest.raises(ValueError, match="bad CRC"):
        du.decode_png(bytes(interlaced))
    ihdr = struct.pack(">IIBBBBB", 4, 4, 8, 2, 0, 0, 1)
    interlaced[16:29] = ihdr
    interlaced[29:33] = struct.pack(">I", zlib.crc32(b"IHDR" + ihdr))
    with pytest.raises(ValueError, match="interlace 1"):
        du.decode_png(bytes(interlaced))


def test_jpeg_goes_to_imageio(tmp_path, monkeypatch):
    """JPEG goes to the port's codec, and no longer to imageio (whose read
    and write raise here): a .jpg and a .JPEG that the JAX package writes
    read as its imageio reader reads them, bit for bit, and the port's
    .jpg reads back close to what was written."""
    y, x = np.mgrid[0:20, 0:28] / 28.0
    img = np.stack([0.2 + 0.6 * x, 0.3 + 0.5 * y, 0.5 + 0.2 * x * y],
                   -1).astype(np.float32)
    paths = [str(tmp_path / "jax.jpg"), str(tmp_path / "jax.JPEG")]
    for path in paths:
        jdu.write_image(path, img, quality=80)
    want = [jdu.read_image(path) for path in paths]

    def refuse(*args, **kwargs):
        raise AssertionError("imageio was called for a JPEG")

    monkeypatch.setattr(imageio, "imread", refuse)
    monkeypatch.setattr(imageio, "imwrite", refuse)
    for path, ref in zip(paths, want):
        np.testing.assert_array_equal(du.read_image(path), ref)
    port = str(tmp_path / "port.jpg")
    du.write_image(port, img)
    err = np.abs(du.read_image(port) - img)
    assert err.mean() < 0.01 and err.max() < 0.04


def test_helper_math_matches_the_jax_package():
    x = np.linspace(0, 1, 101).astype(np.float32)
    np.testing.assert_array_equal(du.srgb_to_linear(x), jdu.srgb_to_linear(x))
    np.testing.assert_array_equal(du.linear_to_srgb(x), jdu.linear_to_srgb(x))
    assert du.focal_length_to_fov(800, 1111.1) == jdu.focal_length_to_fov(800, 1111.1)
    assert du.fov_to_focal_length(800, 39.6) == jdu.fov_to_focal_length(800, 39.6)

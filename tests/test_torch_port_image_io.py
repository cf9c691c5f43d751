"""The port's PNG codec and resizes (``pgdvs_tpu_torch.data.image_io``)
against PIL and OpenCV, which the JAX package's readers call.

``read_png`` on PIL-written files of every mode the readers meet (RGB, RGBA,
L, LA, P at 8, 4, 2 and 1 bits, 1-bit) equals ``np.asarray(PIL.Image.open)``
bit for bit, dtype and shape included, through both un-filters (the C
function and its numpy plain version); ``write_png`` round-trips through PIL
with each filter type; the four resizes equal ``cv2.resize`` (INTER_AREA,
INTER_NEAREST) and ``PIL.Image.resize`` (NEAREST, LANCZOS) bit for bit on
integer and non-integer factors. What the codec refuses raises, naming the
file; a JPEG file decodes through ``read_image`` as PIL decodes it (the
decoder's own matrix is tests/test_torch_port_jpeg.py); a failed build of
the C un-filter raises with its command.
"""

import io
import struct
import zlib

import cv2
import numpy as np
import PIL.Image
import pytest

from pgdvs_tpu_torch.data import image_io


def _smooth(h, w, c, seed=0):
    """A smooth image plus noise, so that PIL's adaptive filter choice takes
    several filter types."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    chans = [np.sin(xx / 7 + yy / 5), np.cos(xx / 3 - yy / 11), np.sin(xx * yy / 300),
             np.cos(xx / 13)]
    img = np.stack(chans[:c], -1) * 100 + 128 + rng.integers(-20, 20, (h, w, c))
    return img.clip(0, 255).astype(np.uint8)


def _pil_bytes(img: PIL.Image.Image) -> bytes:
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return buf.getvalue()


def _filter_types(data: bytes):
    """The set of filter types of a non-interlaced 8-bit PNG's scanlines."""
    img = image_io.read_png(data)
    h = img.shape[0]
    idat = b""
    pos = 8
    while pos < len(data):
        n, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        if ctype == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, -1)
    return set(raw[:, 0].tolist())


def _pil_images():
    rgb = _smooth(37, 53, 3)
    rgba = _smooth(37, 53, 4, seed=1)
    mask = np.random.default_rng(2).uniform(size=(29, 45)) > 0.5
    images = {
        "RGB": PIL.Image.fromarray(rgb),
        "RGBA": PIL.Image.fromarray(rgba),
        "L": PIL.Image.fromarray(rgb[..., 0]),
        "LA": PIL.Image.fromarray(rgba[..., :2], "LA"),
        "1": PIL.Image.fromarray(mask),
    }
    for colors in (200, 16, 4, 2):
        images[f"P{colors}"] = PIL.Image.fromarray(rgb).convert(
            "P", palette=PIL.Image.Palette.ADAPTIVE, colors=colors)
    return images


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA", "1", "P200", "P16", "P4", "P2"])
@pytest.mark.parametrize("native", [True, False])
def test_read_png_equals_pil(mode, native, tmp_path):
    data = _pil_bytes(_pil_images()[mode])
    ref = np.asarray(PIL.Image.open(io.BytesIO(data)))
    got = image_io.read_png(data, native=native)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    path = tmp_path / "img.png"
    path.write_bytes(data)
    np.testing.assert_array_equal(image_io.read_png(path, native=native), ref)


def test_pil_files_take_several_filter_types():
    """The PIL-written RGB file exercises more than one filter type, and
    the writer's "cycle" mode all five."""
    assert len(_filter_types(_pil_bytes(_pil_images()["RGB"]))) >= 3
    assert _filter_types(image_io.encode_png(_smooth(20, 9, 3), "cycle")) == {0, 1, 2, 3, 4}


@pytest.mark.parametrize("filter_type", ["adaptive", "cycle", 0, 1, 2, 3, 4])
def test_write_png_round_trips_through_pil(filter_type, tmp_path):
    rgba = _smooth(23, 31, 4, seed=3)
    arrays = [rgba[..., :3], rgba, rgba[..., 0], rgba[..., :2], rgba[..., :1],
              rgba[..., 0] > 128]
    for arr in arrays:
        path = image_io.write_png(tmp_path / "out.png", arr, filter_type)
        ref = np.asarray(PIL.Image.open(path))
        want = arr[..., 0] if arr.ndim == 3 and arr.shape[-1] == 1 else arr
        assert ref.dtype == want.dtype
        np.testing.assert_array_equal(ref, want)
        for native in (True, False):
            np.testing.assert_array_equal(image_io.read_png(path, native=native), want)


def test_unfilter_native_equals_plain():
    """Both un-filters on random scanlines of every filter type, at 1 to 4
    bytes per pixel and a stride that is not a multiple of them."""
    rng = np.random.default_rng(4)
    for bpp, stride in ((1, 17), (2, 18), (3, 30), (4, 28), (3, 31)):
        h = 23
        raw = rng.integers(0, 256, (h, stride + 1)).astype(np.uint8)
        raw[:, 0] = rng.integers(0, 5, h)
        a = image_io.unfilter(raw, h, stride, bpp)
        b = image_io.unfilter_plain(raw, h, stride, bpp)
        np.testing.assert_array_equal(a, b)
        raw[7, 0] = 5
        for fn in (image_io.unfilter, image_io.unfilter_plain):
            with pytest.raises(ValueError, match="scanline 7 has filter type 5"):
                fn(raw, h, stride, bpp)


def test_refusals_name_the_file(tmp_path):
    jpg = tmp_path / "cam01.jpg"
    PIL.Image.fromarray(_smooth(8, 8, 3)).save(jpg)
    with PIL.Image.open(jpg) as im:
        np.testing.assert_array_equal(image_io.read_image(jpg), np.array(im))
    with pytest.raises(ValueError, match=r"cam01\.jpg: not a PNG"):
        image_io.read_png(jpg)
    PIL.Image.fromarray(_smooth(8, 8, 3)).save(jpg, progressive=True)
    with pytest.raises(NotImplementedError, match=r"cam01\.jpg: progressive JPEG"):
        image_io.read_image(jpg)
    deep = tmp_path / "deep.png"
    PIL.Image.fromarray(np.arange(64, dtype=np.uint16).reshape(8, 8) * 999).save(deep)
    with pytest.raises(NotImplementedError, match=r"deep\.png.*bit depth 16"):
        image_io.read_png(deep)
    data = bytearray(image_io.encode_png(_smooth(8, 8, 3)))
    data[28] = 1  # IHDR interlace method: Adam7
    data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29])))
    laced = tmp_path / "laced.png"
    laced.write_bytes(bytes(data))
    with pytest.raises(NotImplementedError, match=r"laced\.png.*interlaced"):
        image_io.read_png(laced)
    data[20] ^= 1  # height changed: the IHDR CRC no longer matches
    with pytest.raises(ValueError, match="CRC"):
        image_io.read_png(bytes(data))
    with pytest.raises(ValueError, match="not a PNG"):
        image_io.read_png(b"GIF89a")
    with pytest.raises(ValueError, match="write_png takes"):
        image_io.encode_png(np.zeros((4, 4), np.float32))


def test_failed_build_raises_with_its_command(tmp_path, monkeypatch):
    """A compiler that fails makes read_png raise with the command it ran;
    nothing falls back to numpy."""
    data = image_io.encode_png(_smooth(8, 8, 3))
    monkeypatch.setattr(image_io, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CC", "false")
    image_io.load_unfilter_library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match=r"false -O2 .*png_unfilter\.c"):
            image_io.read_png(data)
    finally:
        image_io.load_unfilter_library.cache_clear()


SIZES = [((96, 128), (48, 64)), ((72, 96), (48, 64)), ((576, 1100), (288, 550)),
         ((100, 130), (37, 41)), ((50, 60), (50, 30)), ((91, 77), (13, 10))]


@pytest.mark.parametrize("src,dst", SIZES)
def test_resizes_equal_the_libraries(src, dst):
    rng = np.random.default_rng(src[0] * 7 + dst[1])
    (h, w), (oh, ow) = src, dst
    for shape in ((h, w), (h, w, 3)):
        img = rng.integers(0, 256, shape).astype(np.uint8)
        np.testing.assert_array_equal(
            image_io.resize_area(img, oh, ow),
            cv2.resize(img, (ow, oh), interpolation=cv2.INTER_AREA))
        for arr in (img, img.astype(np.float32) / 7):
            np.testing.assert_array_equal(
                image_io.resize_nearest_cv(arr, oh, ow),
                cv2.resize(arr, (ow, oh), interpolation=cv2.INTER_NEAREST))
        np.testing.assert_array_equal(
            image_io.resize_nearest_pil(img, oh, ow),
            np.asarray(PIL.Image.fromarray(img).resize((ow, oh), PIL.Image.Resampling.NEAREST)))
        np.testing.assert_array_equal(
            image_io.resize_lanczos_pil(img, oh, ow),
            np.asarray(PIL.Image.fromarray(img).resize((ow, oh), PIL.Image.Resampling.LANCZOS)))
    mask = rng.uniform(size=(h, w)) > 0.5
    np.testing.assert_array_equal(
        image_io.resize_nearest_pil(mask, oh, ow),
        np.asarray(PIL.Image.fromarray(mask).resize((ow, oh), PIL.Image.Resampling.NEAREST)))
    depth = rng.uniform(size=(h, w))
    np.testing.assert_array_equal(image_io.resize_nearest_cv(depth, oh, ow),
                                  cv2.resize(depth, (ow, oh), interpolation=cv2.INTER_NEAREST))


def test_resizes_refuse_what_they_do_not_take():
    img = np.zeros((10, 12, 3), np.uint8)
    with pytest.raises(ValueError, match="smaller"):
        image_io.resize_area(img, 20, 12)
    with pytest.raises(ValueError, match="uint8"):
        image_io.resize_area(img.astype(np.float32), 5, 6)
    with pytest.raises(ValueError, match="uint8"):
        image_io.resize_lanczos_pil(np.zeros((10, 12, 4), np.uint8), 5, 6)

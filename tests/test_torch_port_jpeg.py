"""The port's JPEG decoder (``image_io.read_image`` / ``read_jpeg``, the C
baseline decoder ``csrc/jpeg_decode.c``) against Pillow, bit for bit.

Files are written by Pillow here over a matrix: subsampling 4:4:4 / 4:2:2 /
4:2:0 and grey, quality 50 / 95 / 100, each with plain and optimised
Huffman tables and restarts every few blocks or every MCU row, at 1x1, 7x9,
37x53 and 48x64; one 576x1100 frame at quality 95; 16-bit quantisation
tables (SOF1), Adobe RGB, EXIF orientation, comments. Each decode equals
``np.array(PIL.Image.open(f))`` (``assert_array_equal``, dtype and shape
included). The committed fixtures of ``tests/data/jpeg`` decode to the
sha256 recorded from Pillow when they were made (what ``chip_smoke.py``
``[jpeg]`` checks on a machine without Pillow). Progressive, CMYK, 2
components, 12-bit, arithmetic-coded, other sampling factors and truncated
files raise, naming the file; randomly corrupted files decode or raise.
"""

import hashlib
import io
import json
import pathlib

import numpy as np
import PIL.Image
import pytest

from pgdvs_tpu_torch.data import image_io

FIXTURES = pathlib.Path(__file__).parent / "data" / "jpeg"
SUBSAMPLING = ["4:4:4", "4:2:2", "4:2:0", "grey"]
OPTIONS = [{}, {"optimize": True}, {"restart_marker_blocks": 3},
           {"restart_marker_rows": 1, "optimize": True}]


def _image(h, w, c, seed):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[:h, :w]
    base = np.stack([128 + 100 * np.sin(x / 5.0 + k) * np.cos(y / 7.0 - k) for k in range(c)],
                    -1)
    img = np.clip(base + rng.normal(0, 30, base.shape), 0, 255).astype(np.uint8)
    return img[..., 0] if c == 1 else img


def _jpeg(img, **options) -> bytes:
    buf = io.BytesIO()
    PIL.Image.fromarray(img).save(buf, format="JPEG", **options)
    return buf.getvalue()


def _assert_as_pil(data: bytes):
    with PIL.Image.open(io.BytesIO(data)) as im:
        want = np.array(im)
    got = image_io.read_image(data)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    return got


@pytest.mark.parametrize("hw", [(1, 1), (7, 9), (37, 53), (48, 64)])
@pytest.mark.parametrize("sub", SUBSAMPLING)
@pytest.mark.parametrize("quality", [50, 95, 100])
def test_read_image_equals_pil(hw, sub, quality):
    img = _image(*hw, 1 if sub == "grey" else 3, seed=hw[0] * hw[1] + quality)
    for options in OPTIONS:
        kw = dict(quality=quality, **options)
        if sub != "grey":
            kw["subsampling"] = sub
        _assert_as_pil(_jpeg(img, **kw))


def test_full_size_frame_equals_pil():
    """One frame at the NVIDIA raw size, Pillow's defaults at quality 95."""
    got = _assert_as_pil(_jpeg(_image(576, 1100, 3, 7), quality=95))
    assert got.shape == (576, 1100, 3)


@pytest.mark.parametrize("case", ["sof1_16bit_tables", "adobe_rgb", "exif_orientation",
                                  "comment_icc", "grey_restarts"])
def test_other_markers_equal_pil(case):
    img = _image(37, 53, 3, 3)
    options = {
        "sof1_16bit_tables": dict(qtables=[list(range(200, 264)), [1000] * 64]),
        "adobe_rgb": dict(keep_rgb=True, quality=90),
        "exif_orientation": dict(exif=_orientation_exif()),
        "comment_icc": dict(comment=b"a comment", icc_profile=b"\0" * 300, dpi=(300, 300)),
        "grey_restarts": dict(restart_marker_blocks=1),
    }[case]
    if case == "grey_restarts":
        img = img[..., 0]
    data = _jpeg(img, **options)
    if case == "sof1_16bit_tables":
        assert b"\xff\xc1" in data
    _assert_as_pil(data)


def _orientation_exif():
    exif = PIL.Image.Exif()
    exif[0x0112] = 6
    return exif.tobytes()


def test_fixtures_decode_to_the_recorded_hashes():
    """The committed fixtures against the hashes Pillow gave when they were
    made (``scripts/make_jpeg_fixtures.py``), and against Pillow here."""
    record = json.loads((FIXTURES / "decodes.json").read_text())
    assert record["decodes"] and sum(f.stat().st_size for f in FIXTURES.iterdir()) < 200_000
    for name, want in record["decodes"].items():
        got = image_io.read_image(FIXTURES / name)
        assert list(got.shape) == want["shape"] and str(got.dtype) == want["dtype"], name
        assert hashlib.sha256(got.tobytes()).hexdigest() == want["sha256"], name
        with PIL.Image.open(FIXTURES / name) as im:
            np.testing.assert_array_equal(got, np.array(im), err_msg=name)
    for name, what in record["refused"].items():
        with pytest.raises(NotImplementedError, match=rf"{name}.*{what}"):
            image_io.read_image(FIXTURES / name)


def _patched(data: bytes, marker: bytes, offset: int, value: int) -> bytes:
    """``data`` with the byte ``offset`` past ``marker`` set to ``value``."""
    out = bytearray(data)
    out[out.index(marker) + offset] = value
    return bytes(out)


def _refused_files():
    img = _image(37, 53, 3, 4)
    base = _jpeg(img, quality=90, subsampling="4:2:0")
    cmyk = io.BytesIO()
    PIL.Image.fromarray(img).convert("CMYK").save(cmyk, format="JPEG")
    return {
        "progressive": (_jpeg(img, progressive=True), NotImplementedError, "progressive"),
        "cmyk": (cmyk.getvalue(), NotImplementedError, "4 components"),
        "two_components": (_patched(base, b"\xff\xc0", 9, 2), NotImplementedError,
                           "2 components"),
        "12bit": (_patched(base, b"\xff\xc0", 4, 12), NotImplementedError, "12-bit"),
        "arithmetic": (_patched(base, b"\xff\xc0", 1, 0xC9), NotImplementedError,
                       "arithmetic"),
        "lossless": (_patched(base, b"\xff\xc0", 1, 0xC3), NotImplementedError, "lossless"),
        "sampling_4x1": (_patched(base, b"\xff\xc0", 11, 0x41), NotImplementedError,
                         "sampling factors 4x1"),
        "sampling_1x2": (_patched(base, b"\xff\xc0", 11, 0x12), NotImplementedError,
                         "sampling factors 1x2"),
        "truncated_half": (base[:len(base) // 2], ValueError, "truncated"),
        "truncated_eoi": (base[:-2], ValueError, "truncated"),
        "not_an_image": (b"GIF89a" + bytes(10), ValueError, "neither a PNG nor a JPEG"),
    }


@pytest.mark.parametrize("case", sorted(_refused_files()))
def test_refusals_name_the_file(tmp_path, case):
    """What the decoder does not take raises, naming the file; Pillow
    raises on the truncated ones too."""
    data, exc, what = _refused_files()[case]
    path = tmp_path / f"cam_{case}.jpg"
    path.write_bytes(data)
    with pytest.raises(exc, match=rf"cam_{case}\.jpg: .*{what}"):
        image_io.read_image(path)
    if case.startswith("truncated"):
        with pytest.raises(OSError, match="truncated"):
            with PIL.Image.open(io.BytesIO(data)) as im:
                im.load()


def test_failed_build_raises_with_its_command(tmp_path, monkeypatch):
    """A compiler that fails makes read_jpeg raise with the command it ran."""
    data = _jpeg(_image(8, 8, 3, 5))
    monkeypatch.setattr(image_io, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CC", "false")
    image_io.load_jpeg_library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match=r"false -O2 .*jpeg_decode\.c"):
            image_io.read_jpeg(data)
    finally:
        image_io.load_jpeg_library.cache_clear()


def test_corrupted_files_raise_or_decode():
    """Bytes overwritten, inserted or cut at random (500 files from 4
    valid ones, restarts included): each either decodes or raises
    ValueError / NotImplementedError; the process survives them all."""
    rng = np.random.default_rng(0)
    srcs = [_jpeg(_image(29, 41, 3, 6), quality=90),
            _jpeg(_image(29, 41, 3, 7), quality=50, subsampling="4:2:2",
                  restart_marker_blocks=2),
            _jpeg(_image(29, 41, 3, 8), quality=95, optimize=True, subsampling="4:4:4"),
            _jpeg(_image(17, 23, 1, 9), restart_marker_rows=1)]
    outcomes = set()
    for i in range(500):
        data = bytearray(srcs[i % len(srcs)])
        for _ in range(rng.integers(1, 6)):
            pos = int(rng.integers(2, len(data)))
            op = rng.integers(0, 3)
            if op == 0:
                data[pos] = int(rng.integers(0, 256))
            elif op == 1:
                del data[pos:]
            else:
                data[pos:pos] = bytes(rng.integers(0, 256, rng.integers(1, 8)).astype(np.uint8))
            if len(data) < 4:
                break
        try:
            image_io.read_image(bytes(data))
            outcomes.add("decoded")
        except (ValueError, NotImplementedError) as e:
            outcomes.add(type(e).__name__)
    assert {"decoded", "ValueError"} <= outcomes

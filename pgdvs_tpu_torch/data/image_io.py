"""Image files and resizes for the readers, in numpy (no PIL, no OpenCV).

The JAX package's readers decode with PIL and resize with OpenCV and PIL;
the GPU machine has neither. This module carries what they use:

``read_image`` decodes a PNG or a JPEG file (told apart by their first
bytes) into exactly the array ``np.array(PIL.Image.open(f))`` gives;
``image_hw`` reads its (height, width) from the header alone.

``read_png``: (H, W) uint8 for 8-bit grey, (H, W) bool for 1-bit grey,
(H, W) uint8 palette indices for a palette image, (H, W, 2 / 3 / 4) uint8
for grey + alpha, RGB and RGBA. 16-bit and interlaced files raise, naming
the file. The scanlines are un-filtered by a C function
(``csrc/png_unfilter.c``); ``unfilter_plain`` is its numpy version, which
the tests hold it against.

``read_jpeg``: (H, W, 3) uint8 for a YCbCr or RGB JPEG, (H, W) uint8 for a
grey one, by a baseline decoder in C (``csrc/jpeg_decode.c``) that follows
libjpeg-turbo's arithmetic (the library Pillow's wheels decode with), so
the two agree bit for bit. Progressive, lossless and arithmetic-coded
files, 12-bit samples, 2 or 4 components, sampling other than 1x1, 2x1 or
2x2 luma over 1x1 chroma, and truncated files raise, naming the file.

The C sources are built with the host C compiler at first use into
``pgdvs_tpu_torch/_build/`` and loaded with ctypes; a failed build raises
with the command it ran.

``write_png`` writes uint8 grey / grey + alpha / RGB / RGBA and 1-bit grey
(from bool) with any of the five filter types, fixed, cycled row by row, or
chosen per row as libpng does ("adaptive").

The resizes repeat the libraries' arithmetic from their definitions:
``resize_area`` = ``cv2.resize(INTER_AREA)`` downscaling uint8,
``resize_nearest_cv`` = ``cv2.resize(INTER_NEAREST)``,
``resize_nearest_pil`` = ``PIL.Image.resize(NEAREST)`` and
``resize_lanczos_pil`` = ``PIL.Image.resize(LANCZOS)`` on uint8 (Pillow's
fixed-point two-pass resample). Sizes are given as (out_h, out_w).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import shutil
import struct
import subprocess
import tempfile
import zlib
from pathlib import Path

import numpy as np

PKG_DIR = Path(__file__).resolve().parent.parent
UNFILTER_SOURCE = PKG_DIR / "csrc" / "png_unfilter.c"
JPEG_SOURCE = PKG_DIR / "csrc" / "jpeg_decode.c"
BUILD_DIR = PKG_DIR / "_build"
CC_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c99"]

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels
PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# colour type -> bit depths read_png takes
PNG_DEPTHS = {0: (1, 8), 2: (8,), 3: (1, 2, 4, 8), 4: (8,), 6: (8,)}
JPEG_SOI = b"\xff\xd8"


# ------------------------------------------------------------ host builds


def build_host_library(source: Path) -> ctypes.CDLL:
    """Build (if needed) and load a C source of ``csrc/`` as a shared
    library. The library is named by the source's stem and a hash of the
    source and flags, so an edited source rebuilds; the build goes through
    a temporary file and an atomic rename, so processes that build at once
    do not collide."""
    src = source.read_bytes()
    digest = hashlib.sha256(src + " ".join(CC_FLAGS).encode()).hexdigest()[:16]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = BUILD_DIR / f"lib{source.stem}_{digest}.so"
    if not so.exists():
        cc = os.environ.get("CC") or shutil.which("cc") or shutil.which("gcc") or "cc"
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [cc, *CC_FLAGS, "-o", tmp, str(source)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            os.unlink(tmp)
            raise RuntimeError(f"building {source.name} failed: {' '.join(cmd)}: {e}") from e
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"building {source.name} failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)
    return ctypes.CDLL(str(so))


# ------------------------------------------------------------- un-filtering


@functools.lru_cache(maxsize=None)
def load_unfilter_library():
    """``csrc/png_unfilter.c``, built and loaded once per process."""
    lib = build_host_library(UNFILTER_SOURCE)
    lib.png_unfilter.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                                 ctypes.c_int64, ctypes.c_int]
    lib.png_unfilter.restype = ctypes.c_int
    return lib


def _check_scanlines(raw: np.ndarray, height: int, stride: int, bpp: int) -> np.ndarray:
    raw = np.ascontiguousarray(raw, dtype=np.uint8).reshape(-1)
    if height < 0 or stride < 1 or bpp < 1:
        raise ValueError(f"bad scanline geometry: height {height}, stride {stride}, bpp {bpp}")
    if raw.size != height * (stride + 1):
        raise ValueError(f"{raw.size} scanline bytes, expected {height} x (1 + {stride})")
    return raw


def unfilter(raw, height: int, stride: int, bpp: int) -> np.ndarray:
    """Un-filter ``height`` scanlines of ``1 + stride`` bytes (filter type,
    then the filtered bytes) with ``bpp`` bytes per pixel -> [height, stride]
    uint8, through the C function."""
    raw = _check_scanlines(raw, height, stride, bpp)
    out = np.empty((height, stride), np.uint8)
    bad = load_unfilter_library().png_unfilter(raw.ctypes.data, out.ctypes.data,
                                               height, stride, bpp)
    if bad:
        raise ValueError(f"scanline {bad - 1} has filter type {raw[(bad - 1) * (stride + 1)]}, "
                         "not 0-4")
    return out


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def unfilter_plain(raw, height: int, stride: int, bpp: int) -> np.ndarray:
    """``unfilter`` in numpy: an anti-diagonal wavefront over (row, pixel),
    since a byte depends on its left, upper and upper-left neighbours. Step
    d reconstructs every pixel x of every row y with x + y = d, each row by
    its own filter type."""
    raw = _check_scanlines(raw, height, stride, bpp)
    lines = raw.reshape(height, stride + 1)
    ftype = lines[:, 0].astype(np.int64)
    if (ftype > 4).any():
        bad = int(np.argmax(ftype > 4))
        raise ValueError(f"scanline {bad} has filter type {ftype[bad]}, not 0-4")
    # pixels of bpp bytes; a sub-byte depth has bpp 1, so the units are bytes
    npx = -(-stride // bpp)
    filt = np.zeros((height, npx * bpp), np.int64)
    filt[:, :stride] = lines[:, 1:]
    filt = filt.reshape(height, npx, bpp)
    rec = np.zeros((height + 1, npx + 1, bpp), np.int64)  # a zero row above, column left
    for d in range(height + npx - 1):
        y = np.arange(max(0, d - npx + 1), min(height, d + 1))
        x = d - y
        a, b, c = rec[y + 1, x], rec[y, x + 1], rec[y, x]
        t = ftype[y][:, None]
        pred = np.select([t == 1, t == 2, t == 3, t == 4],
                         [a, b, (a + b) >> 1, _paeth(a, b, c)], 0)
        rec[y + 1, x + 1] = (filt[y, x] + pred) & 255
    return rec[1:, 1:].reshape(height, npx * bpp)[:, :stride].astype(np.uint8)


# ----------------------------------------------------------------- decoding


def _name(source) -> str:
    return "<bytes>" if isinstance(source, (bytes, bytearray, memoryview)) else str(source)


def _read(source):
    """(name, bytes) of a path or of bytes."""
    if isinstance(source, (bytes, bytearray, memoryview)):
        return _name(source), bytes(source)
    return _name(source), Path(source).read_bytes()


def read_image(source, name=None) -> np.ndarray:
    """Decode a PNG or JPEG file (path) or its bytes, told apart by their
    first bytes, into what ``np.array(PIL.Image.open(f))`` gives; errors
    name ``name`` (default: the path)."""
    src_name, data = _read(source)
    name = name or src_name
    if data[:2] == JPEG_SOI:
        return read_jpeg(data, name=name)
    if data[:8] == PNG_SIGNATURE:
        return read_png(data, name=name)
    raise ValueError(f"{name}: neither a PNG nor a JPEG file")


def image_hw(source, name=None):
    """(height, width) of a PNG or JPEG file (path) or its bytes, from its
    header, without decoding the image."""
    src_name, data = _read(source)
    name = name or src_name
    if data[:8] == PNG_SIGNATURE and data[12:16] == b"IHDR":
        width, height = struct.unpack(">II", data[16:24])
        return int(height), int(width)
    if data[:2] == JPEG_SOI:
        buf = np.frombuffer(data, np.uint8)
        err = ctypes.create_string_buffer(256)
        hwc = np.zeros(3, np.int32)
        _jpeg_check(load_jpeg_library().jpeg_header(buf.ctypes.data, buf.size, hwc.ctypes.data,
                                                    err, len(err)), name, err)
        return int(hwc[0]), int(hwc[1])
    raise ValueError(f"{name}: neither a PNG nor a JPEG file")


@functools.lru_cache(maxsize=None)
def load_jpeg_library():
    """``csrc/jpeg_decode.c``, built and loaded once per process."""
    lib = build_host_library(JPEG_SOURCE)
    lib.jpeg_header.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                                ctypes.c_char_p, ctypes.c_int64]
    lib.jpeg_header.restype = ctypes.c_int
    lib.jpeg_decode.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                                ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64]
    lib.jpeg_decode.restype = ctypes.c_int
    return lib


def _jpeg_check(code: int, name: str, err) -> None:
    msg = err.value.decode(errors="replace")
    if code == 2:
        raise NotImplementedError(f"{name}: {msg}")
    if code:
        raise ValueError(f"{name}: {msg}")


def read_jpeg(source, name=None) -> np.ndarray:
    """Decode a baseline JPEG file (path) or its bytes: (H, W, 3) uint8 RGB
    or (H, W) uint8 grey, equal to ``np.array(PIL.Image.open(f))`` (see
    the module docstring for what raises)."""
    src_name, data = _read(source)
    name = name or src_name
    buf = np.frombuffer(data, np.uint8)
    err = ctypes.create_string_buffer(256)
    hwc = np.zeros(3, np.int32)
    lib = load_jpeg_library()
    _jpeg_check(lib.jpeg_header(buf.ctypes.data, buf.size, hwc.ctypes.data, err, len(err)),
                name, err)
    h, w, c = (int(x) for x in hwc)
    out = np.empty((h, w, 3) if c == 3 else (h, w), np.uint8)
    _jpeg_check(lib.jpeg_decode(buf.ctypes.data, buf.size, out.ctypes.data, out.size, err,
                                len(err)), name, err)
    return out


def read_png(source, native: bool = True, name=None) -> np.ndarray:
    """Decode a PNG file (path) or its bytes into what ``np.asarray(PIL.Image.
    open(f))`` gives (see the module docstring). ``native=False`` un-filters
    with ``unfilter_plain``."""
    src_name, data = _read(source)
    name = name or src_name
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{name}: not a PNG file")
    pos, ihdr, idat = 8, None, []
    while True:
        if pos + 8 > len(data):
            raise ValueError(f"{name}: truncated before IEND")
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError(f"{name}: truncated {ctype!r} chunk")
        if struct.unpack(">I", crc)[0] != zlib.crc32(ctype + body):
            raise ValueError(f"{name}: bad CRC in the {ctype!r} chunk")
        pos += 12 + length
        if ctype == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if ihdr is None or not idat:
        raise ValueError(f"{name}: no IHDR or no IDAT chunk")
    width, height, depth, color, comp, fmethod, interlace = ihdr
    if color not in PNG_CHANNELS or comp != 0 or fmethod != 0:
        raise ValueError(f"{name}: colour type {color}, compression {comp}, filter method "
                         f"{fmethod} is not a PNG this reader takes")
    if depth not in PNG_DEPTHS[color]:
        raise NotImplementedError(f"{name}: bit depth {depth} of colour type {color} is not "
                                  f"decoded (takes {PNG_DEPTHS[color]})")
    if interlace:
        raise NotImplementedError(f"{name}: Adam7-interlaced PNG is not decoded")
    ch = PNG_CHANNELS[color]
    stride = -(-width * ch * depth // 8)
    bpp = max(1, ch * depth // 8)
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size < height * (stride + 1):
        raise ValueError(f"{name}: {raw.size} image bytes, expected {height * (stride + 1)}")
    raw = raw[:height * (stride + 1)]
    rows = (unfilter if native else unfilter_plain)(raw, height, stride, bpp)
    if depth == 8:
        img = rows.reshape(height, width, ch)
        return img[..., 0] if ch == 1 else img
    bits = np.unpackbits(rows, axis=1)
    if depth == 1:
        px = bits[:, :width]
        return px.astype(bool) if color == 0 else px
    groups = bits[:, :width * depth].reshape(height, width, depth)
    return (groups * (1 << np.arange(depth - 1, -1, -1, dtype=np.uint8))).sum(
        -1, dtype=np.uint8)


# ----------------------------------------------------------------- encoding


def _filter_candidates(rows: np.ndarray, bpp: int) -> np.ndarray:
    """[5, H, stride] int16: each row filtered by each of the five types."""
    x = rows.astype(np.int16)
    left = np.zeros_like(x)
    left[:, bpp:] = x[:, :-bpp]
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    upleft = np.zeros_like(x)
    upleft[1:, bpp:] = x[:-1, :-bpp]
    preds = [0, left, up, (left + up) >> 1, _paeth(left, up, upleft)]
    return np.stack([(x - p) & 255 for p in preds])


def encode_png(img, filter_type="adaptive") -> bytes:
    """PNG bytes of a uint8 [H, W] / [H, W, 1-4] array (grey, grey + alpha,
    RGB, RGBA) or a bool [H, W] array (1-bit grey). ``filter_type``: 0-4 for
    every row, "cycle" for row y's type y % 5, or "adaptive" for libpng's
    per-row choice (least sum of the filtered bytes read as signed)."""
    img = np.asarray(img)
    if img.dtype == bool and img.ndim == 2:
        color, depth = 0, 1
        rows = np.packbits(img, axis=1)
    elif img.dtype == np.uint8 and img.ndim in (2, 3):
        if img.ndim == 2:
            img = img[..., None]
        color = {1: 0, 2: 4, 3: 2, 4: 6}.get(img.shape[-1])
        if color is None:
            raise ValueError(f"{img.shape[-1]} channels: write_png takes 1 to 4")
        depth = 8
        rows = img.reshape(img.shape[0], -1)
    else:
        raise ValueError(f"write_png takes uint8 [H, W(, C)] or bool [H, W], not "
                         f"{img.dtype} {img.shape}")
    height, width = img.shape[:2]
    bpp = max(1, PNG_CHANNELS[color] * depth // 8)
    cands = _filter_candidates(rows, bpp)
    if filter_type == "adaptive":
        score = np.where(cands >= 128, 256 - cands, cands).sum(-1)  # [5, H]
        types = np.argmin(score, axis=0)
    elif filter_type == "cycle":
        types = np.arange(height) % 5
    elif filter_type in range(5):
        types = np.full(height, filter_type)
    else:
        raise ValueError(f"filter_type {filter_type!r}: 0-4, 'cycle' or 'adaptive'")
    filtered = cands[types, np.arange(height)].astype(np.uint8)
    scan = np.concatenate([types.astype(np.uint8)[:, None], filtered], axis=1)

    def chunk(ctype, body):
        return (struct.pack(">I", len(body)) + ctype + body
                + struct.pack(">I", zlib.crc32(ctype + body)))

    ihdr = struct.pack(">IIBBBBB", width, height, depth, color, 0, 0, 0)
    return (PNG_SIGNATURE + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(scan.tobytes())) + chunk(b"IEND", b""))


def write_png(path, img, filter_type="adaptive"):
    """Write ``encode_png(img, filter_type)`` to ``path``; returns it."""
    Path(path).write_bytes(encode_png(img, filter_type))
    return path


# ------------------------------------------------------------------ resizes


def _hw_c(img: np.ndarray):
    if img.ndim not in (2, 3):
        raise ValueError(f"resize takes [H, W] or [H, W, C], not {img.shape}")
    return img.shape[0], img.shape[1]


def _cv_scale(in_size: int, out_size: int) -> float:
    """OpenCV's source pixels per output pixel: 1 / (out / in), in double."""
    return 1.0 / (out_size / in_size)


def resize_nearest_cv(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """``cv2.resize(img, (out_w, out_h), interpolation=cv2.INTER_NEAREST)``:
    output pixel x reads source pixel min(floor(x * in / out), in - 1), the
    scale taken as OpenCV takes it. Any dtype; a [H, W, 1] input keeps its
    channel axis (OpenCV would drop it)."""
    h, w = _hw_c(img)
    ys = np.minimum(np.floor(np.arange(out_h) * _cv_scale(h, out_h)).astype(np.int64), h - 1)
    xs = np.minimum(np.floor(np.arange(out_w) * _cv_scale(w, out_w)).astype(np.int64), w - 1)
    return img[ys][:, xs]


def resize_nearest_pil(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """``PIL.Image.fromarray(img).resize((out_w, out_h), NEAREST)``: Pillow's
    affine scale, output pixel x reading source pixel int(x0), x0 starting at
    half a step (in / out / 2) and advanced by one step per pixel in double."""
    h, w = _hw_c(img)

    def taps(n_in, n_out):
        step = n_in / n_out
        pos = np.add.accumulate(np.concatenate([[step * 0.5], np.full(n_out - 1, step)]))
        return np.minimum(pos.astype(np.int64), n_in - 1)

    return img[taps(h, out_h)][:, taps(w, out_w)]


def _area_tab(n_in: int, n_out: int, scale: float):
    """OpenCV's ``computeResizeAreaTab``: per output pixel its source taps
    and float32 weights, as [n_out, T] index / weight tables (unused slots
    weight 0, index 0), taps in OpenCV's order."""
    rows = []
    for dx in range(n_out):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, n_in - fsx1)
        sx1, sx2 = math.ceil(fsx1), math.floor(fsx2)
        sx2 = min(sx2, n_in - 1)
        sx1 = min(sx1, sx2)
        taps = []
        if sx1 - fsx1 > 1e-3:
            taps.append((sx1 - 1, (sx1 - fsx1) / cell))
        taps += [(sx, 1.0 / cell) for sx in range(sx1, sx2)]
        if fsx2 - sx2 > 1e-3:
            taps.append((sx2, min(min(fsx2 - sx2, 1.0), cell) / cell))
        rows.append(taps)
    t = max(len(r) for r in rows)
    idx = np.zeros((n_out, t), np.int64)
    wgt = np.zeros((n_out, t), np.float32)
    for i, r in enumerate(rows):
        for j, (s, a) in enumerate(r):
            idx[i, j], wgt[i, j] = s, a
    return idx, wgt


def resize_area(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """``cv2.resize(img, (out_w, out_h), interpolation=cv2.INTER_AREA)`` for a
    uint8 image made smaller (or kept) on both axes. Integer factors take
    OpenCV's fast path: the mean of each cell, (sum + 2) >> 2 for 2x2 cells,
    else sum * float32(1 / area) rounded half to even. Other factors take its
    general path: per source row a float32 horizontal pass over the area
    table's taps, then the rows weighted into the output row in float32, in
    OpenCV's order, rounded half to even."""
    h, w = _hw_c(img)
    if img.dtype != np.uint8:
        raise ValueError(f"resize_area takes uint8, not {img.dtype}")
    sy, sx = _cv_scale(h, out_h), _cv_scale(w, out_w)
    if sy < 1 or sx < 1:
        raise ValueError(f"resize_area only makes images smaller: {h}x{w} -> {out_h}x{out_w}")
    iy, ix = int(round(sy)), int(round(sx))
    if abs(sy - iy) < np.finfo(np.float64).eps and abs(sx - ix) < np.finfo(np.float64).eps:
        if iy == 2 and ix == 2:
            a = img[:2 * out_h, :2 * out_w].astype(np.uint16)
            total = a[0::2, 0::2] + a[0::2, 1::2] + a[1::2, 0::2] + a[1::2, 1::2]
            return ((total + 2) >> 2).astype(np.uint8)
        cells = img[:out_h * iy, :out_w * ix].reshape((out_h, iy, out_w, ix) + img.shape[2:])
        total = cells.sum(axis=(1, 3), dtype=np.int32)
        out = total.astype(np.float32) * np.float32(1.0 / (iy * ix))
        return np.clip(np.rint(out), 0, 255).astype(np.uint8)
    xi, xw = _area_tab(w, out_w, sx)
    yi, yw = _area_tab(h, out_h, sy)
    src = img.astype(np.float32)
    wshape = (1, out_w) + (1,) * (img.ndim - 2)
    buf = np.zeros((h, out_w) + img.shape[2:], np.float32)
    for t in range(xi.shape[1]):
        buf = buf + src[:, xi[:, t]] * xw[:, t].reshape(wshape)
    hshape = (out_h,) + (1,) * (img.ndim - 1)
    acc = np.zeros((out_h, out_w) + img.shape[2:], np.float32)
    for t in range(yi.shape[1]):
        acc = acc + yw[:, t].reshape(hshape) * buf[yi[:, t]]
    return np.clip(np.rint(acc), 0, 255).astype(np.uint8)


PIL_PRECISION_BITS = 32 - 8 - 2
LANCZOS_SUPPORT = 3.0


def _sinc(x: float) -> float:
    if x == 0.0:
        return 1.0
    x = x * math.pi
    return math.sin(x) / x


def _lanczos(x: float) -> float:
    return _sinc(x) * _sinc(x / 3) if -3.0 <= x < 3.0 else 0.0


def _pil_coeffs(n_in: int, n_out: int):
    """Pillow's ``precompute_coeffs`` + ``normalize_coeffs_8bpc`` for the
    LANCZOS filter: (first source index [n_out], fixed-point weights
    [n_out, ksize] int32, zero past each output's tap count)."""
    scale = float(n_in) / n_out
    filterscale = max(scale, 1.0)
    support = LANCZOS_SUPPORT * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    xmins = np.zeros(n_out, np.int64)
    fixed = np.zeros((n_out, ksize), np.int32)
    ss = 1.0 / filterscale
    for xx in range(n_out):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), n_in) - xmin
        k = [_lanczos((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = 0.0
        for v in k:
            ww += v
        for x, v in enumerate(k):
            v = v / ww if ww != 0.0 else v
            fixed[xx, x] = int(-0.5 + v * (1 << PIL_PRECISION_BITS)) if v < 0 else int(
                0.5 + v * (1 << PIL_PRECISION_BITS))
        xmins[xx] = xmin
    return xmins, fixed


def _pil_pass(img: np.ndarray, axis: int, n_out: int) -> np.ndarray:
    """One Pillow 8-bit resample pass along ``axis`` (int32 in, uint8-valued
    int32 out): half a unit of the fixed point, the taps' products summed in
    int32 as Pillow sums them, shifted down and clipped to [0, 255]."""
    n_in = img.shape[axis]
    xmins, fixed = _pil_coeffs(n_in, n_out)
    shape = [1] * img.ndim
    shape[axis] = n_out
    out_shape = list(img.shape)
    out_shape[axis] = n_out
    acc = np.full(out_shape, 1 << (PIL_PRECISION_BITS - 1), np.int32)
    for t in range(fixed.shape[1]):
        idx = np.minimum(xmins + t, n_in - 1)  # past a row's taps the weight is 0
        acc += np.take(img, idx, axis=axis) * fixed[:, t].reshape(shape)
    return np.clip(acc >> PIL_PRECISION_BITS, 0, 255)


def resize_lanczos_pil(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """``PIL.Image.fromarray(img).resize((out_w, out_h), LANCZOS)`` for a
    uint8 grey [H, W] or RGB [H, W, 3] image: the horizontal pass, clipped
    to uint8, then the vertical pass, each skipped when its axis keeps its
    size."""
    h, w = _hw_c(img)
    if img.dtype != np.uint8 or (img.ndim == 3 and img.shape[2] != 3):
        raise ValueError(f"resize_lanczos_pil takes uint8 [H, W] or [H, W, 3], not "
                         f"{img.dtype} {img.shape}")
    out = img.astype(np.int32)
    if out_w != w:
        out = _pil_pass(out, 1, out_w)
    if out_h != h:
        out = _pil_pass(out, 0, out_h)
    return out.astype(np.uint8)

#!/usr/bin/env python3
"""Write the JPEG fixtures of ``tests/data/jpeg/`` with Pillow and record
what Pillow decodes them to.

    python3 scripts/make_jpeg_fixtures.py [--out tests/data/jpeg]

Each fixture is a smooth image plus noise from a fixed seed, saved by
Pillow with the options its name says (subsampling, quality, optimised
Huffman tables, restart intervals, 16-bit quantisation tables, Adobe RGB,
an EXIF orientation). ``decodes.json`` records, per file, the shape and the
sha256 of ``np.array(PIL.Image.open(f)).tobytes()``, and the Pillow and
libjpeg versions that made them; the refused files (progressive) with what
they are. ``chip_smoke.py`` ``[jpeg]`` holds the port's decoder to these
hashes on a machine without Pillow; ``tests/test_torch_port_jpeg.py`` holds
them against Pillow here.
"""

from __future__ import annotations

import argparse
import hashlib
import io
import json
import pathlib

import numpy as np
import PIL
import PIL.features
import PIL.Image


def smooth(h, w, c, seed):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[:h, :w]
    base = np.stack([128 + 90 * np.sin(x / (5.0 + k) + k) * np.cos(y / (7.0 - k) - k)
                     for k in range(c)], -1)
    img = np.clip(base + rng.normal(0, 12, base.shape), 0, 255).astype(np.uint8)
    return img[..., 0] if c == 1 else img


def fixtures():
    """{file name: (image, save options)} and {refused file name: (image,
    options, what it is)}."""
    exif = PIL.Image.Exif()
    exif[0x0112] = 6  # rotate 90 on display: np.array(PIL.Image.open) ignores it
    rgb, grey = smooth(64, 96, 3, 0), smooth(64, 96, 1, 1)
    ok = {
        "rgb_420_q95.jpg": (rgb, dict(quality=95, subsampling="4:2:0")),
        "rgb_422_q50_rst_blocks.jpg": (rgb, dict(quality=50, subsampling="4:2:2",
                                                 restart_marker_blocks=3)),
        "rgb_444_q100_optimize.jpg": (rgb, dict(quality=100, subsampling="4:4:4",
                                                optimize=True)),
        "rgb_420_37x53_rst_rows.jpg": (smooth(37, 53, 3, 2), dict(quality=90,
                                                                  restart_marker_rows=1)),
        "grey_q90.jpg": (grey, dict(quality=90)),
        "rgb_sof1_16bit_tables.jpg": (rgb, dict(qtables=[[260 + i for i in range(64)],
                                                         [300] * 64])),
        "rgb_adobe_keep_rgb.jpg": (rgb, dict(quality=85, keep_rgb=True)),
        "rgb_exif_orientation.jpg": (rgb, dict(quality=80, exif=exif.tobytes())),
    }
    refused = {"rgb_progressive.jpg": (rgb, dict(quality=90, progressive=True), "progressive")}
    return ok, refused


def encode(img, options) -> bytes:
    buf = io.BytesIO()
    PIL.Image.fromarray(img).save(buf, format="JPEG", **options)
    return buf.getvalue()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default=str(pathlib.Path(__file__).resolve().parent.parent
                                         / "tests" / "data" / "jpeg"))
    out = pathlib.Path(ap.parse_args().out)
    out.mkdir(parents=True, exist_ok=True)
    ok, refused = fixtures()
    record = {"pillow": PIL.__version__,
              "libjpeg_turbo": PIL.features.version("libjpeg_turbo"),
              "libjpeg_api": PIL.features.version("jpg"),
              "decodes": {}, "refused": {}}
    for name, (img, options) in ok.items():
        (out / name).write_bytes(encode(img, options))
        with PIL.Image.open(out / name) as im:
            arr = np.array(im)
        record["decodes"][name] = {"shape": list(arr.shape), "dtype": str(arr.dtype),
                                   "sha256": hashlib.sha256(arr.tobytes()).hexdigest()}
    for name, (img, options, what) in refused.items():
        (out / name).write_bytes(encode(img, options))
        record["refused"][name] = what
    (out / "decodes.json").write_text(json.dumps(record, indent=1, sort_keys=True) + "\n")
    total = sum(f.stat().st_size for f in out.iterdir())
    print(f"wrote {len(ok) + len(refused)} fixtures and decodes.json to {out} ({total} bytes)")


if __name__ == "__main__":
    main()

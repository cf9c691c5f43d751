"""Shared reader machinery: lazy zip readers, crop and K bookkeeping.

The counterpart of ``pgdvs_tpu.data.base``: the released benchmark data
ships as zip archives read through a handle opened lazily per process, and
crops renormalize the camera intrinsics. Images decode through
``image_io.read_image`` (PNG or JPEG).
"""

from __future__ import annotations

import io
import zipfile
from typing import Optional

import numpy as np

from pgdvs_tpu_torch.data.image_io import read_image


class ZipReader:
    """Lazily-opened zip archive reader.

    The handle opens on first use and stays open, one per process or
    worker: zipfile handles are not safely shared across forked workers, so
    pickling drops the handle and the copy reopens it lazily.
    """

    def __init__(self, path):
        self.path = str(path)
        self._zf: Optional[zipfile.ZipFile] = None

    def _zip(self) -> zipfile.ZipFile:
        if self._zf is None:
            self._zf = zipfile.ZipFile(self.path)
        return self._zf

    def namelist(self):
        return self._zip().namelist()

    def exists(self, name: str) -> bool:
        try:
            self._zip().getinfo(name)
            return True
        except KeyError:
            return False

    def read_bytes(self, name: str) -> bytes:
        return self._zip().read(name)

    def read_image(self, name: str) -> np.ndarray:
        """Decode a PNG or JPEG member of the archive (``read_image``: what
        PIL would give); what it does not decode raises, naming the member."""
        return read_image(self.read_bytes(name), name=f"{self.path}:{name}")

    def read_npz(self, name: str) -> dict:
        with np.load(io.BytesIO(self.read_bytes(name)), allow_pickle=False) as z:
            return {k: z[k] for k in z.files}

    def read_npy(self, name: str) -> np.ndarray:
        return np.load(io.BytesIO(self.read_bytes(name)), allow_pickle=False)

    def close(self):
        if self._zf is not None:
            self._zf.close()
            self._zf = None

    def __getstate__(self):
        return {"path": self.path}

    def __setstate__(self, state):
        self.path = state["path"]
        self._zf = None


def modify_K_wrt_crop(k_normalized, raw_shape, crop_hw_start, crop_hw):
    """Renormalize a resolution-normalized K (row 0 over width, row 1 over
    height) after a crop: denormalize by the raw (h, w), shift the principal
    point by the crop start (h, w), renormalize by the crop size (h, w).
    Returns a float64 copy."""
    raw_h, raw_w = raw_shape
    h_start, w_start = crop_hw_start
    crop_h, crop_w = crop_hw
    k = np.array(k_normalized, np.float64, copy=True)
    k[0, :] *= raw_w
    k[1, :] *= raw_h
    k[0, 2] -= w_start
    k[1, 2] -= h_start
    k[0, :] /= crop_w
    k[1, :] /= crop_h
    return k


def center_crop(img: np.ndarray, crop_h: int, crop_w: int):
    """Center crop: (cropped, {"h_start", "w_start", "crop_h", "crop_w"})."""
    h, w = img.shape[:2]
    h0 = max((h - crop_h) // 2, 0)
    w0 = max((w - crop_w) // 2, 0)
    out = img[h0:h0 + crop_h, w0:w0 + crop_w]
    return out, {"h_start": h0, "w_start": w0, "crop_h": out.shape[0], "crop_w": out.shape[1]}

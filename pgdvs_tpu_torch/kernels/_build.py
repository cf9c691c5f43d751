"""Build the package's CUDA sources with nvcc and load them with ctypes.

The shared library is built at first use from ``pgdvs_tpu_torch/csrc``
(``-gencode arch=compute_90a,code=sm_90a``, plain C interface) into
``pgdvs_tpu_torch/_build/``, named by a hash of the sources and flags, so an
edited source rebuilds and an unchanged one loads at once. Nothing here runs
at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

from pgdvs_tpu_torch.utils import tracing

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

c_void_p, c_int, c_float = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# the whole forwards' last arguments: h and q scratch, the ray kernel's K / V
# scratch and its block count, the rgb, weights and count outputs, the stream
KERNEL_TAIL = [c_void_p] * 3 + [c_int] + [c_void_p] * 4

# C signatures of the library's entry points (csrc/gnt_fused.cu, then
# csrc/epipolar_sample.cu)
SIGNATURES = {
    # K1: rgb_feat, pts, view code, centres, projection rows; V, R, S, C,
    # padded C; the map size; the weights and their count; scratch, outputs
    # and the stream
    "gnt_mono4_forward": (
        [c_void_p] * 5 + [c_int] * 5 + [c_float, c_float, c_void_p, c_int]
        + KERNEL_TAIL,
        c_int,
    ),
    # K1's patch_rows mode: rows, coef, then K1's list with n_pos and the
    # rays per row block after the padded C
    "gnt_mono4_patch_forward": (
        [c_void_p] * 6 + [c_int] * 7 + [c_float, c_float, c_void_p, c_int]
        + KERNEL_TAIL,
        c_int,
    ),
    # K2 in any operand mode: rf, its channel stride, lerp rows, frac, mask,
    # proj, the bf16 ray-diff and point codes, pts, view code, centres, then
    # K1's list from V on
    "gnt_mono3_forward": (
        [c_void_p, c_int] + [c_void_p] * 9 + [c_int] * 5
        + [c_float, c_float, c_void_p, c_int] + KERNEL_TAIL,
        c_int,
    ),
    # the prologue alone: source (0 rgb_feat, 1 patch rows, 2 quad rows),
    # its two operands, rf's row stride; V, R, S, C, padded C, n_pos, rays
    # per row block; w0, b0, w1, b1; h and q out; the stream
    "gnt_prologue_forward": ([c_int, c_void_p, c_void_p] + [c_int] * 8 + [c_void_p] * 7,
                             c_int),
    # the prologue's loader for a source at C, ld, n_pos, rays per row block:
    # registers, local memory bytes, shared memory bytes per block and
    # resident blocks per SM into an int[4]
    "gnt_prologue_attrs": ([c_int] * 5 + [c_void_p], c_int),
    # the ray kernel: shared memory per block, resident blocks per SM,
    # bf16 elements of one block's K / V slab for S samples
    "gnt_ray_smem_bytes": ([], c_int),
    "gnt_ray_blocks_per_sm": ([], c_int),
    "gnt_ray_slab": ([c_int], c_int),
    # the view kernel: shared memory per block; for a validity source (0
    # projection, 1 mask, 2 split) registers, local memory bytes and resident
    # blocks per SM into an int[3]
    "gnt_view_smem_bytes": ([], c_int),
    "gnt_view_attrs": ([c_int, c_void_p], c_int),
    "gnt_mono4_max_views": ([], c_int),
    "gnt_mono4_n_ptrs": ([], c_int),
    "gnt_split_view_forward": ([c_void_p] * 5 + [c_int] * 2 + [c_void_p, c_int, c_void_p], c_int),
    # q in, q out, weights, K / V scratch; R, S, the scratch's blocks
    "gnt_split_ray_forward": ([c_void_p] * 4 + [c_int] * 3 + [c_void_p, c_int, c_void_p], c_int),
    "gnt_split_n_view_ptrs": ([], c_int),
    "gnt_split_n_ray_ptrs": ([], c_int),
    # csrc/epipolar_sample.cu. The exact sampler: pts, proj, centers, rgb,
    # feat, mask (null: none); V, R, S, H, W, Hf, Wf, F, the row vector; the
    # feature coordinates' scales; rgb_feat, ray_diff, the three masks; the
    # stream
    "epipolar_exact": ([c_void_p] * 6 + [c_int] * 9 + [c_float] * 2 + [c_void_p] * 6, c_int),
    # the quad-masked sampler: pts, proj, the fused map; V, R, S, H, W, C+1,
    # the row vector; rgb_feat, the three masks; the stream
    "epipolar_quad_masked": ([c_void_p] * 3 + [c_int] * 7 + [c_void_p] * 5, c_int),
}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return nvcc


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def source_digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


@functools.lru_cache(maxsize=None)
def load_library() -> "KernelLibrary":
    """Build (if needed) and load the kernels; cached for the process. Its
    span ``setup.kernels`` and the counter ``kernels.built`` (1 where nvcc
    ran) are recorded whether tracing is on or not."""
    with tracing.span("setup.kernels", always=True):
        lib = _load_library()
    tracing.count("kernels.built", int(lib.built), always=True)
    return lib


def _load_library() -> "KernelLibrary":
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = BUILD_DIR / f"libpgdvs_kernels_{source_digest()}.so"
    log = ""
    built = not so.exists()
    if built:
        nvcc = _nvcc()
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cu = [str(p) for p in _sources() if p.suffix == ".cu"]
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *cu]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    for name, (args, res) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = res
    return KernelLibrary(lib, so, built, log)


class KernelLibrary:
    """The loaded library plus how it was obtained (for reports)."""

    def __init__(self, lib, path, built, log):
        self.lib, self.path, self.built, self.build_log = lib, path, built, log

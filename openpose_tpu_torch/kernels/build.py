"""Lazy build of the CUDA kernels into `build/openpose_tpu_torch/`.

The kernels are compiled with `nvcc` for sm_90a into one shared library
with a plain C interface, loaded with `ctypes`.  Nothing happens on import:
`library()` builds on its first call, which the first kernel launch on a
CUDA tensor makes.  The library name carries a hash of the sources and
flags, so an edited source is rebuilt and a stale library is never loaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
from typing import Optional

KERNEL_DIR = pathlib.Path(__file__).resolve().parent
SOURCES = (KERNEL_DIR / "paf_score.cu", KERNEL_DIR / "conv_epilogue.cu",
           KERNEL_DIR / "nms.cu")
BUILD_DIR = KERNEL_DIR.parent.parent / "build" / "openpose_tpu_torch"
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # every multiply and add rounds on its own, as in the plain PyTorch
    # versions the kernels are held to (see paf_score.cu, conv_epilogue.cu,
    # nms.cu)
    "-fmad=false",
    "--ptxas-options=-v", "-shared", "-Xcompiler", "-fPIC")


class Library:
    """The loaded library, built at most once per process."""

    def __init__(self):
        self._lock = threading.Lock()
        self.lib: Optional[ctypes.CDLL] = None
        self.compiler_log = ""

    def get(self) -> ctypes.CDLL:
        with self._lock:
            if self.lib is None:
                self.lib = _bind(ctypes.CDLL(str(self._build())))
            return self.lib

    def _build(self) -> pathlib.Path:
        digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for src in SOURCES:
            digest.update(src.read_bytes())
        target = BUILD_DIR / f"libopenpose_tpu_torch_{digest.hexdigest()[:16]}.so"
        if target.exists():
            return target
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # compile to a temporary name, then rename: a concurrent or cut-off
        # build never leaves a half-written library under the final name
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, SOURCES)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        self.compiler_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                f"{self.compiler_log}")
        os.replace(tmp, target)
        return target


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [pathlib.Path(home) / "bin" / "nvcc"] if home else []
    candidates.append(pathlib.Path("/usr/local/cuda/bin/nvcc"))
    for cand in candidates:
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    vp, i32, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    i64 = ctypes.c_longlong
    per_scale = [ctypes.POINTER(vp), ctypes.POINTER(i32), ctypes.POINTER(i32),
                 ctypes.POINTER(f64), ctypes.POINTER(f64), i32]
    lib.paf_score_launch.argtypes = per_scale + [
        i32, vp, vp, vp, vp,                      # C, peaks pairs map_idx out
        i32, i32, i32, i32, i32, i32,             # n parts P K th tw
        f64, f64, f64,                            # thresholds
        i64, i32, vp]                             # smem limit, device, stream
    lib.paf_score_launch.restype = i32
    lib.sample_bicubic_launch.argtypes = per_scale + [
        vp, vp, vp, vp,                           # my mx vx vy
        i32, i32, i32,                            # n P S
        i64, i32, vp]                             # smem limit, device, stream
    lib.sample_bicubic_launch.restype = i32
    lib.conv_epilogue_launch.argtypes = [
        vp, vp, vp, vp,                           # x bias slope pre
        i64, i32, i32, i32,                       # pixels C act vec
        i32, vp]                                  # device, stream
    lib.conv_epilogue_launch.restype = i32
    lib.nms_peaks_launch.argtypes = [
        vp, vp, vp, vp, vp, vp,                   # heat masks peaks windows
        i32, i32, i32, i32, i32, f64,             # n h w C K threshold
        i32, vp]                                  # device, stream
    lib.nms_peaks_launch.restype = i32
    lib.nms_refine_launch.argtypes = [
        vp, vp, vp, vp, i64, i32, f64, f64,       # sums peaks slots K offset
        i32, vp]                                  # device, stream
    lib.nms_refine_launch.restype = i32
    lib.paf_score_error_string.argtypes = [i32]
    lib.paf_score_error_string.restype = ctypes.c_char_p
    return lib


LIBRARY = Library()


def library() -> ctypes.CDLL:
    """The kernels' library, built from the repository's sources on first use."""
    return LIBRARY.get()


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if code != 0:
        msg = lib.paf_score_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")

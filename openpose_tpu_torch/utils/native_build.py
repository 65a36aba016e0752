"""Build-on-demand for the native helpers (native/*.so).

Compiled binaries are not committed (they pin one libpython/OpenCV ABI and
go stale silently); instead the first loader call runs `make -C native
<target>` when the library is missing or older than its source.  Thread-safe
and memoized per target; failures are cached so a missing toolchain degrades
to `available() == False` instead of repeated compile attempts.
"""

from __future__ import annotations

import pathlib
import subprocess
import threading
from typing import Dict, Optional

NATIVE_DIR = pathlib.Path(__file__).resolve().parents[2] / "native"

_LOCK = threading.Lock()
_RESULTS: Dict[str, Optional[pathlib.Path]] = {}

_SOURCES = {
    "libframe_pump.so": "frame_pump.cpp",
    "libopenpose_capi.so": "c_api.cpp",
}


def ensure_built(target: str) -> Optional[pathlib.Path]:
    """Return the path to native/<target>, building it if needed.

    None when the build fails (e.g. no g++ / headers); the error output is
    kept on the function for diagnostics (`ensure_built.last_error`).
    """
    with _LOCK:
        if target in _RESULTS:
            return _RESULTS[target]
        lib = NATIVE_DIR / target
        src = NATIVE_DIR / _SOURCES.get(target, "")
        fresh = (lib.exists() and src.exists()
                 and lib.stat().st_mtime >= src.stat().st_mtime)
        if not fresh:
            try:
                proc = subprocess.run(
                    ["make", "-C", str(NATIVE_DIR), target],
                    capture_output=True, text=True, timeout=300)
                if proc.returncode != 0:
                    ensure_built.last_error = proc.stderr
                    _RESULTS[target] = None
                    return None
            except (OSError, subprocess.TimeoutExpired) as exc:
                ensure_built.last_error = str(exc)
                _RESULTS[target] = None
                return None
        result = lib if lib.exists() else None
        _RESULTS[target] = result
        return result


ensure_built.last_error = ""



CAPI_SOURCE = pathlib.Path(__file__).resolve().parents[1] / "native" / \
    "c_api.cpp"


def build_capi() -> pathlib.Path:
    """Compile the port's C shim (`openpose_tpu_torch/native/c_api.cpp`)
    with g++ against this interpreter's headers and libpython (what
    `python3-config --includes --ldflags --embed` names) into
    build/openpose_tpu_torch/, under a name that carries a hash of the
    source and the command, and return its path.  A failed build raises
    `RuntimeError` with the compiler's output."""
    import hashlib
    import os
    import sysconfig
    import tempfile
    from openpose_tpu_torch.kernels.build import BUILD_DIR
    flags = ["-O3", "-fPIC", "-std=c++17", "-Wall", "-Wextra", "-shared",
             "-I" + sysconfig.get_paths()["include"],
             "-L" + sysconfig.get_config_var("LIBDIR"),
             "-lpython" + sysconfig.get_config_var("LDVERSION"), "-lpthread"]
    digest = hashlib.sha256(" ".join(flags).encode()
                            + CAPI_SOURCE.read_bytes()).hexdigest()
    target = BUILD_DIR / f"libopenpose_capi_{digest[:16]}.so"
    with _LOCK:
        if target.exists():
            return target
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # a temporary name first: a cut-off build never leaves a
        # half-written library under the final name
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = ["g++", str(CAPI_SOURCE), "-o", tmp, *flags]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"g++ failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stderr}")
        os.replace(tmp, target)
        return target

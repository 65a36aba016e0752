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

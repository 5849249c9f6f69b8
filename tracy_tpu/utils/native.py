"""Loader for the native C++ runtime library (libtracy_native.so).

The reference's runtime is C++ end-to-end; here the *device* path is
JAX/XLA and the heavy host-side runtime pieces (BVH build, OBJ scan)
are C++ behind ctypes. The library is compiled on demand from native/ with
the system toolchain and cached in native/build/.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

from tracy_tpu.utils.log import log, warn

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
_SO_PATH = os.path.join(_NATIVE_DIR, "build", "libtracy_native.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_failed = False


def _sources_newer_than_so() -> bool:
    if not os.path.exists(_SO_PATH):
        return True
    so_mtime = os.path.getmtime(_SO_PATH)
    for f in os.listdir(_NATIVE_DIR):
        if f.endswith((".cpp", ".h")) or f == "Makefile":
            if os.path.getmtime(os.path.join(_NATIVE_DIR, f)) > so_mtime:
                return True
    return False


def _build() -> bool:
    try:
        res = subprocess.run(
            ["make", "-C", _NATIVE_DIR, "all"],
            capture_output=True,
            text=True,
            timeout=120,
        )
        if res.returncode != 0:
            warn(f"native build failed:\n{res.stderr[-2000:]}")
            return False
        log("native library built")
        return True
    except Exception as e:
        warn(f"native build error: {e}")
        return False


def get_native_lib() -> Optional[ctypes.CDLL]:
    """Returns the loaded library, building it if needed; None if unavailable."""
    global _lib, _failed
    with _lock:
        if _lib is not None:
            return _lib
        if _failed:
            return None
        if _sources_newer_than_so() and not _build():
            _failed = True
            return None
        try:
            lib = ctypes.CDLL(_SO_PATH)
        except OSError as e:
            warn(f"native library load failed: {e}")
            _failed = True
            return None

        lib.tracy_build_bvh.restype = ctypes.c_int
        lib.tracy_build_bvh.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int,  # ..., max_depth, cost_mode
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p,
        ]
        lib.tracy_obj_scan.restype = ctypes.c_int64
        lib.tracy_obj_scan.argtypes = [ctypes.c_char_p, ctypes.c_void_p]
        lib.tracy_obj_fill.restype = ctypes.c_int
        lib.tracy_obj_fill.argtypes = [ctypes.c_int64] + [ctypes.c_void_p] * 7
        lib.tracy_obj_free.restype = None
        lib.tracy_obj_free.argtypes = [ctypes.c_int64]

        _lib = lib
        return _lib

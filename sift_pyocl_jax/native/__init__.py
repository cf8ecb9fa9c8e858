"""Native (C++) runtime components, built on demand with the system g++.

The compute path is JAX; these are the host-side runtime pieces a
production streaming deployment needs off the GIL (SURVEY.md §2.2 note — the
reference's only native surface is its OpenCL kernels; the loader here has no
reference counterpart and serves parallel/video.py).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

_SRC = Path(__file__).parent / "framesource.cpp"
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _build_lib() -> Optional[ctypes.CDLL]:
    """Compile framesource.cpp to a cached shared object; None if no g++."""
    src = _SRC.read_text()
    tag = hashlib.sha256(src.encode()).hexdigest()[:16]
    cache = Path(
        os.environ.get("SIFT_NATIVE_CACHE", Path(tempfile.gettempdir()) / "sift_pyocl_jax")
    )
    cache.mkdir(parents=True, exist_ok=True)
    so = cache / f"framesource_{tag}.so"
    if not so.exists():
        try:
            subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                 str(_SRC), "-o", str(so), "-pthread"],
                check=True, capture_output=True,
            )
        except (OSError, subprocess.CalledProcessError):
            return None
    lib = ctypes.CDLL(str(so))
    lib.fs_open.restype = ctypes.c_void_p
    lib.fs_open.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_long,
        ctypes.c_int, ctypes.c_int,
    ]
    lib.fs_next.restype = ctypes.c_long
    lib.fs_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)]
    lib.fs_close.argtypes = [ctypes.c_void_p]
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The compiled native library, or None when no toolchain is available."""
    global _LIB, _TRIED
    if not _TRIED:
        _TRIED = True
        _LIB = _build_lib()
    return _LIB

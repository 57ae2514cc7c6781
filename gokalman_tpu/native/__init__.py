"""Native (C++) runtime tier: host-side I/O hot paths.

The device compute path is JAX/Pallas; the host runtime around it uses
C++ where Python-level throughput is the bottleneck.  Currently:
fastcsv — printf-compatible bulk CSV formatting/parsing for estimate
and Monte-Carlo trace export (the reference's exporter.go/montecarlo.go
equivalents), ~30x faster than Python string formatting.

The shared library builds on demand with g++ (cached next to the
source); every consumer falls back to the pure-Python path when the
toolchain or binary is unavailable, so the package works without it.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "fastcsv.cpp")
_LIB = os.path.join(_DIR, "_fastcsv.so")

_lib = None


def _build() -> bool:
    try:
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-o", _LIB, _SRC],
            check=True, capture_output=True, timeout=120,
        )
        return True
    except Exception:
        return False


def _load():
    global _lib
    if _lib is not None:
        return _lib
    fresh = os.path.exists(_LIB) and (
        os.path.getmtime(_LIB) >= os.path.getmtime(_SRC)
    )
    if not fresh and not _build():
        return None
    try:
        lib = ctypes.CDLL(_LIB)
    except OSError:
        return None
    lib.fastcsv_format.restype = ctypes.c_long
    lib.fastcsv_format.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_long, ctypes.c_long,
        ctypes.c_char_p, ctypes.c_long,
    ]
    lib.fastcsv_parse.restype = ctypes.c_long
    lib.fastcsv_parse.argtypes = [
        ctypes.c_char_p, ctypes.c_long,
        ctypes.POINTER(ctypes.c_double), ctypes.c_long,
    ]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def format_csv(matrix) -> str | None:
    """CSV-format a [rows, cols] array with printf("%f") semantics
    (byte-identical to Python's f"{x:f}").  None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    m = np.ascontiguousarray(np.asarray(matrix, dtype=np.float64))
    if m.ndim == 1:
        m = m[None, :]
    rows, cols = m.shape
    cap = rows * cols * 32 + rows + 512  # slack covers snprintf fallbacks
    buf = ctypes.create_string_buffer(cap)
    n = lib.fastcsv_format(
        m.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        rows, cols, buf, cap,
    )
    if n < 0:
        return None
    return buf.raw[:n].decode("ascii")


def parse_floats(text: str, expected: int | None = None):
    """Parse all floats out of comma/newline-separated text.  None if
    the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    raw = text.encode("ascii", errors="replace")
    cap = expected if expected is not None else max(16, len(raw) // 2 + 16)
    out = np.empty(cap, dtype=np.float64)
    n = lib.fastcsv_parse(
        raw, len(raw), out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        cap,
    )
    if n < 0:
        return None
    return out[:n]

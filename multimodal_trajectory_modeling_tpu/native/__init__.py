"""ctypes loader for the native host-side data path (mtm_native.c).

The shared library is built on first use from ``mtm_native.c`` with the
system C compiler into ``build/`` beside the source (never shipped, no
host-specific ``-march``); every entry point has a NumPy fallback, so the
package works identically (slower) without a toolchain.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "mtm_native.c")
_SO = os.path.join(_HERE, "build", "libmtm_native.so")

_lib = None
_build_failed = False


def _load():
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    try:
        if not os.path.exists(_SO) or os.path.getmtime(_SO) < os.path.getmtime(
            _SRC
        ):
            os.makedirs(os.path.dirname(_SO), exist_ok=True)
            # build to a private name and rename into place: concurrent
            # importers (test workers) never load a half-written library
            tmp = f"{_SO}.{os.getpid()}.tmp"
            subprocess.run(
                [
                    os.environ.get("CC", "cc"),
                    "-O3",
                    "-fopenmp",
                    "-shared",
                    "-fPIC",
                    "-o",
                    tmp,
                    _SRC,
                    "-lm",
                ],
                check=True,
                capture_output=True,
            )
            os.replace(tmp, _SO)
        lib = ctypes.CDLL(_SO)
        lib.pack_joint_f64.restype = None
        lib.pattern_groups_f64.restype = ctypes.c_int64
        lib.finite_lengths_f64.restype = None
        _lib = lib
    except Exception:  # noqa: BLE001 — fall back to NumPy
        _build_failed = True
    return _lib


def available() -> bool:
    return _load() is not None


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def pack_joint(z: np.ndarray, x: np.ndarray) -> np.ndarray:
    """(T,n,d)+(T,n,l) → (n, T*(d+l)) joint layout (native, NumPy fallback).
    """
    z = np.ascontiguousarray(z, dtype=np.float64)
    x = np.ascontiguousarray(x, dtype=np.float64)
    T, n, d = z.shape
    l = x.shape[-1]
    lib = _load()
    if lib is None:
        return np.concatenate(
            [
                z.transpose(1, 0, 2).reshape(n, T * d),
                x.transpose(1, 0, 2).reshape(n, T * l),
            ],
            axis=1,
        )
    out = np.empty((n, T * (d + l)), dtype=np.float64)
    lib.pack_joint_f64(
        _ptr(z),
        _ptr(x),
        ctypes.c_int64(T),
        ctypes.c_int64(n),
        ctypes.c_int64(d),
        ctypes.c_int64(l),
        _ptr(out),
    )
    return out


def pattern_groups(
    v: np.ndarray, max_patterns: int = 4096
) -> tuple[np.ndarray, np.ndarray]:
    """Single-pass hash grouping of rows by finite-mask; falls back to
    np.unique.  Returns ``(patterns bool (P, D), pattern_id int32 (n,))`` in
    first-appearance order."""
    v = np.ascontiguousarray(np.atleast_2d(v), dtype=np.float64)
    n, D = v.shape
    lib = _load()
    if lib is None:
        finite = np.isfinite(v)
        patterns, pattern_id = np.unique(finite, axis=0, return_inverse=True)
        return patterns.astype(bool), pattern_id.astype(np.int32).reshape(-1)
    patterns = np.zeros((max_patterns, D), dtype=np.uint8)
    pattern_id = np.zeros(n, dtype=np.int32)
    got = lib.pattern_groups_f64(
        _ptr(v),
        ctypes.c_int64(n),
        ctypes.c_int64(D),
        _ptr(patterns),
        _ptr(pattern_id),
        ctypes.c_int64(max_patterns),
    )
    if got < 0:  # more patterns than the cap — defer to NumPy
        finite = np.isfinite(v)
        patterns, pattern_id = np.unique(finite, axis=0, return_inverse=True)
        return patterns.astype(bool), pattern_id.astype(np.int32).reshape(-1)
    return patterns[:got].astype(bool), pattern_id


def finite_lengths(arr: np.ndarray) -> np.ndarray:
    """Fully-finite prefix length per trajectory of a (T, n, d) array."""
    arr = np.ascontiguousarray(np.atleast_3d(arr), dtype=np.float64)
    T, n, d = arr.shape
    lib = _load()
    if lib is None:
        fin = np.isfinite(arr).all(axis=-1)
        return np.where(
            fin.all(axis=0), fin.shape[0], np.argmin(fin, axis=0)
        ).astype(np.int32)
    out = np.empty(n, dtype=np.int32)
    lib.finite_lengths_f64(
        _ptr(arr),
        ctypes.c_int64(T),
        ctypes.c_int64(n),
        ctypes.c_int64(d),
        _ptr(out),
    )
    return out

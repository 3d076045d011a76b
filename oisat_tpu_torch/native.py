"""ctypes bindings + on-demand build of the native (C++) runtime components.

The only compute-heavy host path is regrid weight construction; the
``swath_weights`` library exploits the structured (scanline x pixel) nature
of L2 swaths — trivial quad triangulation plus a spatial hash — instead of
a general qhull Delaunay over scattered points.  Loaded via ctypes (no
pybind11 here); built on first use with g++ and cached next to the source.
Everything degrades gracefully to the scipy path when no compiler exists.

The port's own copy of :mod:`oisat_tpu.native` (same names and behaviour).
Its source is the port's copy ``oisat_tpu_torch/csrc/swath_weights.cpp``,
built into the gitignored ``oisat_tpu_torch/_build/`` beside the CUDA
libraries, never into the JAX side's ``native/build/``.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC_PATH = os.path.join(_PKG_DIR, "csrc", "swath_weights.cpp")
_SO_PATH = os.path.join(_PKG_DIR, "_build", "libswath_weights.so")
_lib = None
_build_failed = False


def _ensure_built():
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    src = _SRC_PATH
    try:
        if not os.path.exists(_SO_PATH) or os.path.getmtime(_SO_PATH) < os.path.getmtime(src):
            os.makedirs(os.path.dirname(_SO_PATH), exist_ok=True)
            # build to a per-pid temp and atomically rename: a concurrent
            # process must never CDLL a partially written .so
            tmp = f"{_SO_PATH}.{os.getpid()}.tmp"
            try:
                subprocess.run(
                    ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", src, "-o", tmp],
                    check=True, capture_output=True, text=True)
                os.replace(tmp, _SO_PATH)
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
        lib = ctypes.CDLL(_SO_PATH)
        fn = lib.build_structured_weights
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
            ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
            ctypes.c_int, ctypes.c_double, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_uint8),
        ]
        _lib = lib
    except Exception as e:  # no compiler / build error -> scipy fallback
        detail = getattr(e, "stderr", "") or ""
        print(f"[native] swath_weights unavailable ({e}); falling back to "
              f"scipy{chr(10) + detail if detail else ''}")
        _build_failed = True
        _lib = None
    return _lib


def available() -> bool:
    return _ensure_built() is not None


def structured_weights(lon2d, lat2d, tx, ty, max_dist=float("inf"),
                       need_tri=True, exact_dist=True):
    """Barycentric weights of targets in a structured swath.

    Returns (idx (T,3) int32 into flattened pixels, w (T,3), dist (T,)
    nearest-pixel distance, nn (T,) int32 nearest flat pixel id, ok (T,)
    bool inside-swath) or None when the native library is unavailable.
    Distances are exact up to ``max_dist`` (pass the far-mask cutoff:
    farther targets report some value > max_dist without paying the
    O((dist/pitch)^2) ring scan).

    ``exact_dist=False`` relaxes the contract to the boolean the far mask
    needs: ``dist`` is only guaranteed to land on the correct SIDE of
    ``max_dist`` (the scan stops at the first pixel within the cutoff)
    and ``nn`` is unspecified — callers that use only
    ``dist > max_dist`` get an identical mask for a fraction of the scan.
    """
    lib = _ensure_built()
    if lib is None:
        return None
    lon = np.ascontiguousarray(lon2d, np.float64)
    lat = np.ascontiguousarray(lat2d, np.float64)
    if lon.ndim != 2 or lon.shape != lat.shape:
        raise ValueError("structured_weights needs matching 2-D pixel grids")
    tx = np.ascontiguousarray(tx, np.float64).ravel()
    ty = np.ascontiguousarray(ty, np.float64).ravel()
    if tx.size != ty.size:
        raise ValueError("structured_weights needs matching target arrays")
    nt = tx.size
    idx = np.zeros((nt, 3), np.int32)
    w = np.zeros((nt, 3), np.float64)
    dist = np.zeros(nt, np.float64)
    nn = np.zeros(nt, np.int32)
    ok = np.zeros(nt, np.uint8)
    dptr = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
    iptr = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    rc = lib.build_structured_weights(
        dptr(lon), dptr(lat), lon.shape[0], lon.shape[1],
        dptr(tx), dptr(ty), nt, ctypes.c_double(max_dist),
        ctypes.c_int(1 if need_tri else 0),
        ctypes.c_int(0 if exact_dist else 1),
        iptr(idx), dptr(w), dptr(dist), iptr(nn),
        ok.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if rc != 0:
        return None
    return idx, w, dist, nn, ok.astype(bool)

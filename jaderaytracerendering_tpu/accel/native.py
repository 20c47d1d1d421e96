"""ctypes binding to the native C++ scene runtime (SAH BVH builder).

The reference's BVH build is host C++ (PathTrace.cpp:532-663); this is
its native counterpart. The shared library is compiled from
runtime/jade_native.cpp at first use into ``<checkout>/build/`` (listed
in .gitignore) with the host's C++ compiler (``$CXX``, default g++);
``python -m jaderaytracerendering_tpu.accel.native`` builds it ahead of
time. When no compiler is available we fall back to the NumPy builder
in accel.bvh, which implements identical semantics (equivalence-tested
in tests/test_native.py).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile

import numpy as np

from . import bvh as bvh_mod

_LIB_NAME = "libjade_native.so"
_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SOURCE = os.path.join(_PKG, "runtime", "jade_native.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build")
_lib = None
_lib_checked = False


def build_library() -> str | None:
    """Compile runtime/jade_native.cpp into BUILD_DIR; returns the path,
    or None if the compiler is missing or fails. Portable flags only (no
    -march=native): the checkout may move between hosts."""
    out = os.path.join(BUILD_DIR, _LIB_NAME)
    if os.path.exists(out):
        return out
    try:
        os.makedirs(BUILD_DIR, exist_ok=True)
        # compile to a private name, then rename: concurrent first uses
        # (test workers) never load a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        subprocess.run(
            [os.environ.get("CXX", "g++"), "-O3", "-fPIC", "-shared",
             "-std=c++17", "-o", tmp, _SOURCE],
            check=True, capture_output=True, timeout=300)
        os.replace(tmp, out)
    except (OSError, subprocess.SubprocessError):
        return None
    return out


def _find_lib() -> str | None:
    env = os.environ.get("JADE_NATIVE_LIB")
    if env:
        return env if os.path.exists(env) else None
    return build_library()


def load_library():
    """Load (and memoize) the native library, or None if unavailable."""
    global _lib, _lib_checked
    if _lib_checked:
        return _lib
    _lib_checked = True
    path = _find_lib()
    if path is None:
        return None
    lib = ctypes.CDLL(path)
    lib.jade_build_bvh_sah.restype = ctypes.c_int64
    lib.jade_build_bvh_sah.argtypes = [
        ctypes.POINTER(ctypes.c_float),   # p1 [T*3]
        ctypes.POINTER(ctypes.c_float),   # p2
        ctypes.POINTER(ctypes.c_float),   # p3
        ctypes.c_int64,                   # T
        ctypes.c_int32,                   # leaf_size
        ctypes.c_int32,                   # method: 0 sah, 1 median
        ctypes.POINTER(ctypes.c_int64),   # out perm [T]
        ctypes.POINTER(ctypes.c_int32),   # out left [cap]
        ctypes.POINTER(ctypes.c_int32),   # out right
        ctypes.POINTER(ctypes.c_int32),   # out n
        ctypes.POINTER(ctypes.c_int32),   # out index
        ctypes.POINTER(ctypes.c_float),   # out aa [cap*3]
        ctypes.POINTER(ctypes.c_float),   # out bb [cap*3]
        ctypes.c_int64,                   # cap
    ]
    lib.jade_parse_obj_counts.restype = ctypes.c_int64
    lib.jade_parse_obj_counts.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int32,
    ]
    lib.jade_parse_obj.restype = ctypes.c_int64
    lib.jade_parse_obj.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_int32,
    ]
    _lib = lib
    return _lib


def parse_obj(path: str, compat_slash_faces: bool = False):
    """Native OBJ parse -> (vertices [V,3] f64, faces [F,3] i64), or None
    if the library is unavailable."""
    lib = load_library()
    if lib is None:
        return None
    nv = ctypes.c_int64(0)
    nf = ctypes.c_int64(0)
    rc = lib.jade_parse_obj_counts(
        path.encode(), ctypes.byref(nv), ctypes.byref(nf),
        1 if compat_slash_faces else 0,
    )
    if rc < 0:
        raise FileNotFoundError(path)
    verts = np.empty((nv.value, 3), np.float64)
    faces = np.empty((nf.value, 3), np.int64)
    rc = lib.jade_parse_obj(
        path.encode(),
        verts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        nv.value, nf.value, 1 if compat_slash_faces else 0,
    )
    if rc < 0:
        raise RuntimeError(f"native OBJ parse failed ({rc}) for {path}")
    return verts, faces


def available() -> bool:
    return load_library() is not None


def build(
    p1: np.ndarray,
    p2: np.ndarray,
    p3: np.ndarray,
    leaf_size: int = 8,
    method: str = "sah",
    required: bool = False,
) -> tuple[bvh_mod.BVHArrays, np.ndarray]:
    """Build via the native library; fall back to NumPy if unavailable."""
    lib = load_library()
    if lib is None:
        if required:
            raise RuntimeError(
                "native BVH backend requested but libjade_native.so could "
                f"not be built from {_SOURCE} (is a C++ compiler on PATH?)"
            )
        return bvh_mod.build(p1, p2, p3, leaf_size=leaf_size, method=method)

    t = len(p1)
    cap = max(2 * t + 2, 8)
    f32 = lambda a: np.ascontiguousarray(a, np.float32)
    p1c, p2c, p3c = f32(p1), f32(p2), f32(p3)
    perm = np.empty(t, np.int64)
    left = np.empty(cap, np.int32)
    right = np.empty(cap, np.int32)
    n = np.empty(cap, np.int32)
    index = np.empty(cap, np.int32)
    aa = np.empty((cap, 3), np.float32)
    bb = np.empty((cap, 3), np.float32)
    ptr = lambda a, ty: a.ctypes.data_as(ctypes.POINTER(ty))
    n_nodes = lib.jade_build_bvh_sah(
        ptr(p1c, ctypes.c_float), ptr(p2c, ctypes.c_float), ptr(p3c, ctypes.c_float),
        t, leaf_size, 0 if method == "sah" else 1,
        ptr(perm, ctypes.c_int64),
        ptr(left, ctypes.c_int32), ptr(right, ctypes.c_int32),
        ptr(n, ctypes.c_int32), ptr(index, ctypes.c_int32),
        ptr(aa, ctypes.c_float), ptr(bb, ctypes.c_float), cap,
    )
    if n_nodes < 0:
        raise RuntimeError(f"native BVH build failed (code {n_nodes})")
    k = int(n_nodes)
    nodes = bvh_mod.BVHArrays(
        left=left[:k].copy(), right=right[:k].copy(), n=n[:k].copy(),
        index=index[:k].copy(), aa=aa[:k].copy(), bb=bb[:k].copy(),
    )
    return nodes, perm


if __name__ == "__main__":
    path = build_library()
    if path is None:
        raise SystemExit(f"failed to build {_LIB_NAME} from {_SOURCE}")
    print(path)

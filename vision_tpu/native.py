"""ctypes bindings for the native host runtime (native/build/libvision_native.so).

Provides fast OBJ parsing, Morton sorting and the binned-SAH BVH build. The
library is built from native/*.cpp by `make -C native` on first use (make
rebuilds it when a source is newer). Without a C++ compiler the OBJ loader
falls back to the Python parser (same mesh), and `build_bvh_native` returns
None: GPU traversal then refuses to run (accel/cuda_trace.py) instead of
silently walking another tree.
"""
from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "native")
_LIB_PATH = os.path.join(_DIR, "build", "libvision_native.so")
_lib = None
build_error = None   # why the library could not be built, if it could not


class _MeshBlob(ctypes.Structure):
    _fields_ = [
        ("positions", ctypes.POINTER(ctypes.c_float)),
        ("normals", ctypes.POINTER(ctypes.c_float)),
        ("uvs", ctypes.POINTER(ctypes.c_float)),
        ("triangles", ctypes.POINTER(ctypes.c_int32)),
        ("n_verts", ctypes.c_int64),
        ("n_tris", ctypes.c_int64),
    ]


def make(target="all", timeout=120, **variables):
    """Run `make -C native <target> [NAME=value ...]`; raises RuntimeError
    with the compiler's output on failure."""
    args = [f"{k}={v}" for k, v in variables.items()]
    try:
        subprocess.run(["make", "-C", _DIR, target, *args], check=True,
                       capture_output=True, text=True, timeout=timeout)
    except subprocess.CalledProcessError as e:
        raise RuntimeError(f"make -C native {target} failed:\n"
                           f"{e.stdout}\n{e.stderr}") from e


def _load():
    global _lib, build_error
    if _lib is not None:
        return _lib
    try:
        make()
        lib = ctypes.CDLL(_LIB_PATH)
    except (OSError, RuntimeError, subprocess.SubprocessError) as e:
        build_error = str(e)
        _lib = False
        return False
    lib.vt_load_obj.argtypes = [ctypes.c_char_p, ctypes.POINTER(_MeshBlob)]
    lib.vt_load_obj.restype = ctypes.c_int32
    lib.vt_free_mesh.argtypes = [ctypes.POINTER(_MeshBlob)]
    lib.vt_morton_sort.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32)]
    _lib = lib
    return _lib


def available():
    return bool(_load())


def load_obj_native(path):
    """Fast OBJ load. Returns (positions [V,3], normals [V,3], uvs [V,2],
    triangles [T,3]) or None if the native lib is unavailable."""
    lib = _load()
    if not lib:
        return None
    blob = _MeshBlob()
    rc = lib.vt_load_obj(os.fsencode(path), ctypes.byref(blob))
    if rc != 0:
        return None
    nv, nt = blob.n_verts, blob.n_tris
    P = np.ctypeslib.as_array(blob.positions, (nv, 3)).copy()
    N = np.ctypeslib.as_array(blob.normals, (nv, 3)).copy()
    UV = np.ctypeslib.as_array(blob.uvs, (nv, 2)).copy()
    T = np.ctypeslib.as_array(blob.triangles, (nt, 3)).copy()
    lib.vt_free_mesh(ctypes.byref(blob))
    return P, N, UV, T


def morton_sort_native(centroids):
    """Morton-order permutation of [N,3] centroids, or None."""
    lib = _load()
    if not lib:
        return None
    c = np.ascontiguousarray(centroids, np.float32)
    n = len(c)
    order = np.empty(n, np.int32)
    lib.vt_morton_sort(c.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                       n, order.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return order.astype(np.int64)


def build_bvh_native(p0, p1, p2, max_leaf=4):
    """Binned-SAH BVH build (native/bvh_builder.cpp). Returns a dict of flat
    arrays (lo/hi [N,3] f32, first/count/skip/axis [N] i32, order [T] i32)
    or None if the native lib is unavailable. `axis` is the split axis of
    inner nodes (-1 for leaves); the left child always covers the lower side
    of that axis (front-to-back traversal invariant)."""
    lib = _load()
    if not lib:
        return None
    if not hasattr(lib, "_bvh_bound"):
        F = ctypes.POINTER(ctypes.c_float)
        I = ctypes.POINTER(ctypes.c_int32)
        lib.vt_build_bvh.argtypes = [F, F, F, ctypes.c_int64,
                                     ctypes.c_int32, F, F, I, I, I, I, I]
        lib.vt_build_bvh.restype = ctypes.c_int64
        lib._bvh_bound = True
    a0 = np.ascontiguousarray(p0, np.float32)
    a1 = np.ascontiguousarray(p1, np.float32)
    a2 = np.ascontiguousarray(p2, np.float32)
    n = len(a0)
    cap = max(2 * n, 2)
    lo = np.empty((cap, 3), np.float32)
    hi = np.empty((cap, 3), np.float32)
    first = np.empty(cap, np.int32)
    count = np.empty(cap, np.int32)
    skip = np.empty(cap, np.int32)
    axis = np.empty(cap, np.int32)
    order = np.empty(max(n, 1), np.int32)
    F = ctypes.POINTER(ctypes.c_float)
    I = ctypes.POINTER(ctypes.c_int32)
    nn = lib.vt_build_bvh(
        a0.ctypes.data_as(F), a1.ctypes.data_as(F), a2.ctypes.data_as(F),
        n, max_leaf, lo.ctypes.data_as(F), hi.ctypes.data_as(F),
        first.ctypes.data_as(I), count.ctypes.data_as(I),
        skip.ctypes.data_as(I), order.ctypes.data_as(I),
        axis.ctypes.data_as(I))
    if nn <= 0:
        return None
    return dict(lo=lo[:nn].copy(), hi=hi[:nn].copy(),
                first=first[:nn].copy(), count=count[:nn].copy(),
                skip=skip[:nn].copy(), axis=axis[:nn].copy(),
                order=order[:n].copy())

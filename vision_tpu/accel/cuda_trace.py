"""GPU BVH traversal: the per-ray kernel of native/trace.cu through jax.ffi.

The library is compiled by `make -C native cuda` (nvcc, sm_90a) into
native/build/ the first time a GPU process traces a BVH scene; the build
counts as set-up time. `load()` builds and registers the two FFI targets
and reports why it could not. The kernel has no CPU implementation: the
traversal router (accel/intersect.py `trace`) stages it with
`lax.platform_dependent`, so the same jitted code still runs the XLA walk
when it is compiled for the CPU.
"""
from __future__ import annotations

import ctypes
import os

import jax
import jax.numpy as jnp

from .. import native

BLOCK = 128   # rays per CUDA block (kBlock in native/trace.cu)
_LIB_PATH = os.path.join(native._DIR, "build", "libvision_cuda.so")
_TARGETS = (("vt_trace_closest", "VtTraceClosest"),
            ("vt_trace_any", "VtTraceAny"))
_load_result = []


def load():
    """Build and register the kernel once per process. Returns None on
    success, else the reason it is unavailable."""
    if _load_result:
        return _load_result[0]
    err = None
    try:
        native.make("cuda", timeout=900,
                    FFI_INCLUDE=jax.ffi.include_dir())
        lib = ctypes.cdll.LoadLibrary(_LIB_PATH)
        for name, sym in _TARGETS:
            jax.ffi.register_ffi_target(
                name, jax.ffi.pycapsule(getattr(lib, sym)), platform="CUDA")
    except (OSError, RuntimeError, AttributeError) as e:
        err = f"GPU traversal kernel unavailable: {e}"
    _load_result.append(err)
    return err


def pack_rays(ray):
    """Ray -> [Rp, 8] rows (o.xyz, t_max, d.xyz, 0), R padded up to a whole
    number of BLOCKs. Padding rows have t_max = 0 and miss immediately."""
    R = ray.origin.shape[0]
    rows = jnp.concatenate(
        [ray.origin, ray.t_max[:, None], ray.direction,
         jnp.zeros((R, 1), ray.origin.dtype)], -1).astype(jnp.float32)
    pad = -R % BLOCK
    return jnp.pad(rows, ((0, pad), (0, 0)))


def intersect_cuda(ray, sah, any_hit=False):
    """Closest (or any) hit over a SahBVH. Returns (t [R], prim_id [R],
    truncated) where truncated counts rays whose traversal stack
    overflowed. No gradient flows through it: callers pass stopped rays."""
    R = ray.origin.shape[0]
    rows = pack_rays(ray)
    Rp = rows.shape[0]
    name = _TARGETS[1][0] if any_hit else _TARGETS[0][0]
    t, pid, trunc = jax.ffi.ffi_call(
        name,
        (jax.ShapeDtypeStruct((Rp,), jnp.float32),
         jax.ShapeDtypeStruct((Rp,), jnp.int32),
         jax.ShapeDtypeStruct((1,), jnp.int32)))(
        sah.boxes, sah.links, sah.tris, sah.prim, rows)
    return t[:R], pid[:R], trunc[0]

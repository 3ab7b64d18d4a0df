"""ctypes bindings for the port's native scan decoder (csrc/scanpack.cpp).

Port of immesh_tpu/frontend/native.py.  The reference's frontend is C++
(src/preprocess.cpp); the runtime keeps a native path for the byte-level
work: strided PointCloud2-style decode with fused gates, and a lock-free
IMU ring.  The library is built from the port's own copy of the source by
`kernels/build.py` with the host C++ compiler at first use.  Unlike the JAX
package there is no NumPy fallback: a failed build raises with the
compiler's output.  `_decode_filter_numpy` stays as the oracle the tests and
chip_smoke.py hold the library to.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np

from immesh_tpu_torch.kernels import build as _build

NAME = "scanpack"

# field dtype codes matching scanpack.cpp
DTYPE_F32, DTYPE_F64, DTYPE_U32, DTYPE_U16, DTYPE_U8, DTYPE_I32 = range(6)

_c_u8p = ctypes.POINTER(ctypes.c_uint8)
_c_f32p = ctypes.POINTER(ctypes.c_float)
_c_f64p = ctypes.POINTER(ctypes.c_double)
_c_i32p = ctypes.POINTER(ctypes.c_int32)
_i32, _i64 = ctypes.c_int32, ctypes.c_int64

_SIGNATURES = {
    # name: (restype, argtypes)
    "scanpack_decode_filter": (_i64, [
        _c_u8p, _i64, _i32, _i32, _i32, _i32, _i32, _i32, ctypes.c_double,
        _i32, _i32, ctypes.c_float, ctypes.c_float, _i32,
        _c_f32p, _c_f32p, _c_i32p, _i64]),
    "scanpack_imu_ring_new": (ctypes.c_void_p, [_i64]),
    "scanpack_imu_ring_free": (None, [ctypes.c_void_p]),
    "scanpack_imu_ring_push": (_i32, [
        ctypes.c_void_p, ctypes.c_double, _c_f32p, _c_f32p]),
    "scanpack_imu_ring_drain": (_i64, [
        ctypes.c_void_p, ctypes.c_double, _i64, _c_f64p, _c_f32p, _c_f32p]),
    "scanpack_imu_ring_size": (_i64, [ctypes.c_void_p]),
}

_lib = None


def _load() -> ctypes.CDLL:
    """The port's scanpack library, built on first use; raises if the build
    fails."""
    global _lib
    if _lib is None:
        lib = _build.load(NAME)
        for fn, (res, args) in _SIGNATURES.items():
            getattr(lib, fn).restype = res
            getattr(lib, fn).argtypes = args
        _lib = lib
    return _lib


def _ptr(a, t):
    return a.ctypes.data_as(ctypes.POINTER(t))


def decode_filter(buf: bytes | np.ndarray, n: int, point_step: int,
                  off_xyz: Tuple[int, int, int],
                  t_off: int = -1, t_dtype: int = DTYPE_F32,
                  t_scale: float = 1.0,
                  ring_off: int = -1, ring_dtype: int = DTYPE_U16,
                  blind: float = 0.1, max_range: float = 150.0,
                  filter_num: int = 1, want_ring: bool = False):
    """Fused strided decode + gates. Returns (xyz (M,3) f32, t (M,), ring?)."""
    lib = _load()
    n, point_step, filter_num = int(n), int(point_step), int(filter_num)
    raw = np.frombuffer(buf, np.uint8) if isinstance(buf, (bytes, bytearray)) \
        else np.ascontiguousarray(buf, np.uint8)
    if raw.size < n * point_step:
        raise ValueError(f"buffer of {raw.size} bytes holds fewer than "
                         f"{n} points of {point_step} bytes")
    out_xyz = np.empty((n, 3), np.float32)
    out_t = np.empty(n, np.float32)
    out_ring = np.empty(n, np.int32) if want_ring else None
    m = lib.scanpack_decode_filter(
        _ptr(raw, ctypes.c_uint8), n, point_step, *map(int, off_xyz),
        t_off, t_dtype, float(t_scale), ring_off, ring_dtype,
        float(blind * blind), float(max_range * max_range), filter_num,
        _ptr(out_xyz, ctypes.c_float), _ptr(out_t, ctypes.c_float),
        _ptr(out_ring, ctypes.c_int32) if want_ring else None, n)
    if want_ring:
        return out_xyz[:m], out_t[:m], out_ring[:m]
    return out_xyz[:m], out_t[:m]


_NP_DTYPES = {DTYPE_F32: "<f4", DTYPE_F64: "<f8", DTYPE_U32: "<u4",
              DTYPE_U16: "<u2", DTYPE_U8: "u1", DTYPE_I32: "<i4"}


def _decode_filter_numpy(raw, n, step, off_xyz, t_off, t_dtype, t_scale,
                         ring_off, ring_dtype, blind, max_range,
                         filter_num, want_ring):
    """Pure-NumPy reference implementation: the library's test oracle."""
    def field(off, dt):
        sz = np.dtype(_NP_DTYPES[dt]).itemsize
        b = np.lib.stride_tricks.as_strided(
            raw[off:], shape=(n, sz), strides=(step, 1))
        return b.copy().view(_NP_DTYPES[dt]).reshape(n)

    xyz = np.stack([field(o, DTYPE_F32) for o in off_xyz], -1)
    idx = np.arange(0, n, max(filter_num, 1))
    xyz = xyz[idx]
    t = (field(t_off, t_dtype)[idx].astype(np.float64) * t_scale
         ).astype(np.float32) if t_off >= 0 else np.zeros(len(idx), np.float32)
    ring = field(ring_off, ring_dtype)[idx].astype(np.int32) \
        if ring_off >= 0 else np.zeros(len(idx), np.int32)
    r2 = np.einsum("ij,ij->i", xyz, xyz)
    keep = np.isfinite(xyz).all(1) & (r2 > blind ** 2) & (r2 < max_range ** 2)
    xyz, t, ring = xyz[keep], t[keep], ring[keep]
    if t_off >= 0 and len(t):
        t = t - t.min()
    if want_ring:
        return xyz.astype(np.float32), t, ring
    return xyz.astype(np.float32), t


class ImuRing:
    """Lock-free SPSC IMU buffer backed by the native ring."""

    def __init__(self, cap: int = 4096):
        self._lib = _load()
        self.cap = cap
        self._h = ctypes.c_void_p(self._lib.scanpack_imu_ring_new(cap))

    def push(self, stamp: float, acc, gyr) -> bool:
        a = np.ascontiguousarray(acc, np.float32).reshape(3)
        g = np.ascontiguousarray(gyr, np.float32).reshape(3)
        return bool(self._lib.scanpack_imu_ring_push(
            self._h, float(stamp), _ptr(a, ctypes.c_float),
            _ptr(g, ctypes.c_float)))

    def drain_until(self, t: float, max_out: int = 4096):
        s = np.empty(max_out, np.float64)
        a = np.empty((max_out, 3), np.float32)
        g = np.empty((max_out, 3), np.float32)
        m = self._lib.scanpack_imu_ring_drain(
            self._h, float(t), max_out, _ptr(s, ctypes.c_double),
            _ptr(a, ctypes.c_float), _ptr(g, ctypes.c_float))
        return s[:m], a[:m], g[:m]

    def __len__(self) -> int:
        return int(self._lib.scanpack_imu_ring_size(self._h))

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.scanpack_imu_ring_free(self._h)
            self._h = None


# Common sensor buffer layouts (PointCloud2 field offsets, reference
# point-type registrations preprocess.h:95-149)
LAYOUTS = {
    # name: (point_step, (x,y,z) offsets, t_off, t_dtype, t_scale, ring_off, ring_dtype)
    # Packed driver-wire variants (PointCloud2 fields laid end-to-end):
    "velodyne": (22, (0, 4, 8), 18, DTYPE_F32, 1.0, 16, DTYPE_U16),
    "hesai_xt32": (26, (0, 4, 8), 18, DTYPE_F64, 1.0, 16, DTYPE_U16),
    "livox": (18, (0, 4, 8), 14, DTYPE_F32, 1e-3, -1, DTYPE_U8),
    # C++-padded struct layouts exactly as the reference registers them
    # (reference src/preprocess.h:95-149; PCL_ADD_POINT4D = x,y,z + 4 B pad,
    # EIGEN_ALIGN16 rounds sizeof to 16) — what pcl::toROSMsg serializes:
    #   ouster_ros::Point  {xyzw, intensity@16, t u32@20, reflectivity@24,
    #                       ring u8@26, ambient@28, range u32@32} → 48 B
    #   velodyne_ros::Point{xyzw, intensity@16, time f32@20, ring@24} → 32 B
    #   xt32_ros::Point    {xyzw, intensity@16, timestamp f64@24 (8-aligned),
    #                       ring@32} → 48 B
    "ouster64": (48, (0, 4, 8), 20, DTYPE_U32, 1e-9, 26, DTYPE_U8),
    "velodyne_pcl": (32, (0, 4, 8), 20, DTYPE_F32, 1.0, 24, DTYPE_U16),
    "xt32_pcl": (48, (0, 4, 8), 24, DTYPE_F64, 1.0, 32, DTYPE_U16),
    # livox_ros_driver CustomMsg CustomPoint wire layout (the message the
    # reference's avia_handler consumes, preprocess.cpp:139): offset_time
    # u32 ns @0, x/y/z f32 @4/8/12, reflectivity u8 @16, tag @17, line @18
    "livox_custommsg": (19, (4, 8, 12), 0, DTYPE_U32, 1e-9, 18, DTYPE_U8),
}

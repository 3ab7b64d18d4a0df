"""The strided decode with its gates: a frozen copy of the port's NumPy
oracle, immesh_tpu_torch/frontend/native.py::_decode_filter_numpy, which
the port's tests hold its native decoder (csrc/scanpack.cpp) to byte for
byte, and the layout table it reads."""

from __future__ import annotations

import numpy as np

# field dtype codes matching scanpack.cpp
DTYPE_F32, DTYPE_F64, DTYPE_U32, DTYPE_U16, DTYPE_U8, DTYPE_I32 = range(6)

_NP_DTYPES = {DTYPE_F32: "<f4", DTYPE_F64: "<f8", DTYPE_U32: "<u4",
              DTYPE_U16: "<u2", DTYPE_U8: "u1", DTYPE_I32: "<i4"}


def decode_filter(raw, n, step, off_xyz, t_off, t_dtype, t_scale,
                  ring_off, ring_dtype, blind, max_range, filter_num,
                  want_ring):
    """(xyz (M, 3) f32, t (M,) f32 rebased to its least, ring?) of the n
    records of `step` bytes in `raw`: 1-in-filter_num, finite, beyond
    blind and within max_range."""
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


# name: (point_step, (x,y,z) offsets, t_off, t_dtype, t_scale, ring_off,
# ring_dtype).  livox_ros_driver's CustomMsg point: offset_time u32 ns @0,
# x/y/z f32 @4/8/12, reflectivity u8 @16, tag @17, line @18
LAYOUTS = {
    "livox_custommsg": (19, (4, 8, 12), 0, DTYPE_U32, 1e-9, 18, DTYPE_U8),
}

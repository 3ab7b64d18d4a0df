// scanpack — native host-side scan decoding for immesh_tpu_torch.
//
// A copy of the JAX package's native/scanpack.cpp (the same C ABI and the
// same arithmetic; its bundle packer, which no Python caller uses, is left
// out), so the port builds its own library instead of loading one built
// elsewhere.  The reference's receiver is C++ (src/preprocess.cpp:
// per-sensor handlers walking ROS PointCloud2 byte blobs with pointer
// strides).  This library is the equivalent native path: fused strided
// decode of raw sensor buffers (arbitrary point_step / field offsets, like
// PointCloud2) plus the blind-range / max-range / 1-in-N gates in one pass,
// writing directly into caller-provided output arrays so Python never
// touches the per-point bytes.  Exposed via a C ABI for ctypes.
//
// Built at first use by immesh_tpu_torch/kernels/build.py with the host
// C++ compiler: -O3 -std=c++17 -fPIC -shared -ffp-contract=off, without
// -march=native, so r² = x·x + y·y + z·z rounds every product as NumPy's
// oracle does and no FMA moves a point across the blind or max-range edge.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <atomic>

extern "C" {

// Field dtype codes for decode: 0=f32, 1=f64, 2=u32, 3=u16, 4=u8, 5=i32
static inline double read_field(const uint8_t* p, int dtype) {
    switch (dtype) {
        case 0: { float v;    std::memcpy(&v, p, 4); return (double)v; }
        case 1: { double v;   std::memcpy(&v, p, 8); return v; }
        case 2: { uint32_t v; std::memcpy(&v, p, 4); return (double)v; }
        case 3: { uint16_t v; std::memcpy(&v, p, 2); return (double)v; }
        case 4: { return (double)*p; }
        case 5: { int32_t v;  std::memcpy(&v, p, 4); return (double)v; }
        default: return 0.0;
    }
}

// Decode xyz (+ optional per-point time and ring) from a strided buffer and
// apply blind/max-range/decimation gates in the same pass.
// Returns the number of points written (<= n).
//   t_off < 0   → no time field (out_t filled with 0)
//   ring_off < 0 → no ring field
int64_t scanpack_decode_filter(
    const uint8_t* buf, int64_t n, int32_t point_step,
    int32_t off_x, int32_t off_y, int32_t off_z,  // field byte offsets
    int32_t t_off, int32_t t_dtype, double t_scale,
    int32_t ring_off, int32_t ring_dtype,
    float blind2, float max_r2, int32_t filter_num,
    float* out_xyz, float* out_t, int32_t* out_ring, int64_t out_cap)
{
    int64_t m = 0;
    if (filter_num < 1) filter_num = 1;
    for (int64_t i = 0; i < n; i += filter_num) {
        const uint8_t* p = buf + i * point_step;
        float x, y, z;
        std::memcpy(&x, p + off_x, 4);
        std::memcpy(&y, p + off_y, 4);
        std::memcpy(&z, p + off_z, 4);
        if (!std::isfinite(x) || !std::isfinite(y) || !std::isfinite(z))
            continue;
        float r2 = x * x + y * y + z * z;
        if (r2 <= blind2 || r2 >= max_r2) continue;
        if (m >= out_cap) break;
        out_xyz[3 * m + 0] = x;
        out_xyz[3 * m + 1] = y;
        out_xyz[3 * m + 2] = z;
        out_t[m] = (t_off >= 0)
            ? (float)(read_field(p + t_off, t_dtype) * t_scale) : 0.0f;
        if (out_ring) {
            out_ring[m] = (ring_off >= 0)
                ? (int32_t)read_field(p + ring_off, ring_dtype) : 0;
        }
        ++m;
    }
    // rebase time to scan start (drivers emitting absolute stamps)
    if (t_off >= 0 && m > 0) {
        float tmin = out_t[0];
        for (int64_t i = 1; i < m; ++i) if (out_t[i] < tmin) tmin = out_t[i];
        for (int64_t i = 0; i < m; ++i) out_t[i] -= tmin;
    }
    return m;
}

// ---------------------------------------------------------------------
// Lock-free SPSC ring for IMU samples (reference buffers are mutex deques,
// voxel_mapping.hpp:138; a sensor-driver thread can push while the pipeline
// thread drains without taking the GIL or a lock).
// ---------------------------------------------------------------------

struct ImuRing {
    double* stamps;
    float* acc;   // (cap, 3)
    float* gyr;   // (cap, 3)
    int64_t cap;
    std::atomic<int64_t> head;  // next write
    std::atomic<int64_t> tail;  // next read
};

void* scanpack_imu_ring_new(int64_t cap) {
    ImuRing* r = new ImuRing();
    r->stamps = new double[cap];
    r->acc = new float[cap * 3];
    r->gyr = new float[cap * 3];
    r->cap = cap;
    r->head.store(0);
    r->tail.store(0);
    return r;
}

void scanpack_imu_ring_free(void* h) {
    ImuRing* r = (ImuRing*)h;
    delete[] r->stamps; delete[] r->acc; delete[] r->gyr; delete r;
}

// returns 1 on success, 0 if full
int32_t scanpack_imu_ring_push(void* h, double stamp,
                               const float* acc, const float* gyr) {
    ImuRing* r = (ImuRing*)h;
    int64_t head = r->head.load(std::memory_order_relaxed);
    int64_t tail = r->tail.load(std::memory_order_acquire);
    if (head - tail >= r->cap) return 0;
    int64_t i = head % r->cap;
    r->stamps[i] = stamp;
    std::memcpy(r->acc + 3 * i, acc, 12);
    std::memcpy(r->gyr + 3 * i, gyr, 12);
    r->head.store(head + 1, std::memory_order_release);
    return 1;
}

// Drain every sample with stamp <= t_until into out arrays; returns count.
int64_t scanpack_imu_ring_drain(void* h, double t_until, int64_t max_out,
                                double* out_stamps, float* out_acc,
                                float* out_gyr) {
    ImuRing* r = (ImuRing*)h;
    int64_t tail = r->tail.load(std::memory_order_relaxed);
    int64_t head = r->head.load(std::memory_order_acquire);
    int64_t m = 0;
    while (tail < head && m < max_out) {
        int64_t i = tail % r->cap;
        if (r->stamps[i] > t_until) break;
        out_stamps[m] = r->stamps[i];
        std::memcpy(out_acc + 3 * m, r->acc + 3 * i, 12);
        std::memcpy(out_gyr + 3 * m, r->gyr + 3 * i, 12);
        ++tail; ++m;
    }
    r->tail.store(tail, std::memory_order_release);
    return m;
}

int64_t scanpack_imu_ring_size(void* h) {
    ImuRing* r = (ImuRing*)h;
    return r->head.load() - r->tail.load();
}

}  // extern "C"

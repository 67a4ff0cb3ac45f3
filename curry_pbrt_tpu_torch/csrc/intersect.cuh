// Per-ray device code shared by the traversal kernels (intersect.cu): ray
// setup, the widened slab test, the watertight ray-triangle test and the
// stable-quadratic ray-sphere test.
//
// Every expression below is written in the operation order of the plain
// PyTorch versions (ops/kernels/intersect_kernel.py, ops/intersect.py
// watertight_core, ops/kernels/sphere_kernel.py), and the library is built
// with -fmad=false and without fast math, so each add, multiply, divide and
// square root rounds separately (IEEE), exactly as the eager PyTorch ops and
// the JAX reference do. The watertight test's conservative error bounds
// (pbrt §3.9) assume that rounding.
#pragma once

#include <cfloat>
#include <cstdint>

namespace curry {

constexpr int PRIM_COLS = 16;  // (rows, 16) primitive tables: tris16 and sph16
constexpr int BOX_COLS = 8;    // (C, 8) rows: bmin xyz, bmax xyz, 2 unused
constexpr int SUPER_G = 8;     // clusters per super-cluster

// Error-bound constants, computed once on the host in float32 exactly as
// the plain version computes them, and passed in by value.
struct Consts {
    float g2, g3, g5, t_scale;
};

// jnp.minimum / torch.minimum semantics: NaN in, NaN out. CUDA's fminf and
// fmaxf return the non-NaN operand instead, which would make the NaN boxes
// of empty clusters enterable.
__device__ __forceinline__ float nan_min(float a, float b) {
    return (isnan(a) || isnan(b)) ? __int_as_float(0x7fc00000) : fminf(a, b);
}
__device__ __forceinline__ float nan_max(float a, float b) {
    return (isnan(a) || isnan(b)) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

// What one thread keeps about its ray for the whole traversal. Each
// primitive test reads only its own fields; the compiler drops the rest.
struct Ray {
    float ox, oy, oz;
    float dx, dy, dz;  // raw direction (sphere test)
    float sx, sy, sz;  // shear to +z (ray_shear; triangle test)
    int kz;            // dominant axis of |d|
    float ix, iy, iz;  // 1 / d with 0 → 1e-30 (slab test)
};

__device__ __forceinline__ float select_kz(int kz, float a, float b, float c) {
    return kz == 0 ? a : (kz == 1 ? b : c);
}

__device__ __forceinline__ Ray make_ray(const float* o, const float* d) {
    Ray r;
    r.ox = o[0];
    r.oy = o[1];
    r.oz = o[2];
    const float dx0 = d[0], dy0 = d[1], dz0 = d[2];
    r.dx = dx0;
    r.dy = dy0;
    r.dz = dz0;
    const float ax = fabsf(dx0), ay = fabsf(dy0), az = fabsf(dz0);
    // first max index (_argmax3)
    r.kz = (ax >= ay && ax >= az) ? 0 : (ay >= az ? 1 : 2);
    // permute_by_kz: (d[kx], d[ky], d[kz]) with kx = kz+1, ky = kz+2 (mod 3)
    const float dx = select_kz(r.kz, dy0, dz0, dx0);
    const float dy = select_kz(r.kz, dz0, dx0, dy0);
    float dz = select_kz(r.kz, dx0, dy0, dz0);
    dz = (dz == 0.0f) ? 1.0f : dz;
    r.sx = -dx / dz;
    r.sy = -dy / dz;
    r.sz = 1.0f / dz;
    r.ix = 1.0f / (dx0 == 0.0f ? 1e-30f : dx0);
    r.iy = 1.0f / (dy0 == 0.0f ? 1e-30f : dy0);
    r.iz = 1.0f / (dz0 == 0.0f ? 1e-30f : dz0);
    return r;
}

// Slab test of one ray against one AABB row, widened by (1 + 2γ₃) on the far
// side (pbrt bounds). `t_best > 0` is the dead-lane gate: integrators pass
// t_max = 0 for lanes whose result is discarded, and such a lane must never
// enter a box even when its stale origin lies inside it. 25 f32 operations.
__device__ __forceinline__ bool box_enter(const float* box, const Ray& r, float t_best,
                                          float t_scale) {
    const float t0x = (box[0] - r.ox) * r.ix, t1x = (box[3] - r.ox) * r.ix;
    const float t0y = (box[1] - r.oy) * r.iy, t1y = (box[4] - r.oy) * r.iy;
    const float t0z = (box[2] - r.oz) * r.iz, t1z = (box[5] - r.oz) * r.iz;
    const float nx = nan_min(t0x, t1x), fx = nan_max(t0x, t1x) * t_scale;
    const float ny = nan_min(t0y, t1y), fy = nan_max(t0y, t1y) * t_scale;
    const float nz = nan_min(t0z, t1z), fz = nan_max(t0z, t1z) * t_scale;
    const float tn = nan_max(nx, nan_max(ny, nz));
    const float tf = nan_min(fx, nan_min(fy, fz));
    return (tn <= tf) && (tn < t_best) && (tf > 0.0f) && (t_best > 0.0f);
}

// box_enter split at the bound: the ray's entry distance tn into the box,
// or NaN where box_enter fails whatever the bound (the slab intervals miss
// each other, the box lies behind the ray, or one of the six slab distances
// is NaN — an empty cluster's box), so that
//   box_enter(box, r, t_best, t_scale) == (box_near(box, r, t_scale) < t_best) && (t_best > 0).
// Without a NaN among the slab distances fminf / fmaxf equal nan_min /
// nan_max operation for operation; with one, box_enter fails on the NaN and
// box_near returns NaN. 25 f32 operations, one NaN flag instead of twelve.
__device__ __forceinline__ float box_near(const float* box, const Ray& r, float t_scale) {
    const float t0x = (box[0] - r.ox) * r.ix, t1x = (box[3] - r.ox) * r.ix;
    const float t0y = (box[1] - r.oy) * r.iy, t1y = (box[4] - r.oy) * r.iy;
    const float t0z = (box[2] - r.oz) * r.iz, t1z = (box[5] - r.oz) * r.iz;
    const bool nan = isnan(t0x) | isnan(t1x) | isnan(t0y) | isnan(t1y) | isnan(t0z) | isnan(t1z);
    const float nx = fminf(t0x, t1x), fx = fmaxf(t0x, t1x) * t_scale;
    const float ny = fminf(t0y, t1y), fy = fmaxf(t0y, t1y) * t_scale;
    const float nz = fminf(t0z, t1z), fz = fmaxf(t0z, t1z) * t_scale;
    const float tn = fmaxf(nx, fmaxf(ny, nz));
    const float tf = fminf(fx, fminf(fy, fz));
    return (!nan && (tn <= tf) && (tf > 0.0f)) ? tn : __int_as_float(0x7fc00000);
}

// Watertight test of one ray against one tris16 row (p0 xyz, p1 xyz, p2 xyz,
// valid ±1), with t_best as the range bound. Returns the hit t, or FLT_MAX
// where there is no hit. 84 f32 operations (add, sub, mul, div, abs, min,
// max; comparisons and selects not counted) on a valid row.
//
// Template arguments, for callers whose lanes share one ray (the warp walk,
// intersect_warp.cu); the defaults are the per-thread test:
//   KZ >= 0: the ray's dominant axis, known at compile time (r.kz == KZ), so
//     the permutation costs no selects;
//   FAST_MAX: fmaxf instead of nan_max in the error bounds. The result is the
//     same: a NaN among the x, y or z terms makes det or t_scaled NaN, and so
//     fails in_range, whatever the bounds say.
template <int KZ = -1, bool FAST_MAX = false>
__device__ __forceinline__ float tri_test(const float* tri, const Ray& r, float t_best,
                                          const Consts& k) {
    if (!(tri[9] > 0.0f)) return FLT_MAX;  // padding row
    const int kz = KZ >= 0 ? KZ : r.kz;
    auto vmax = [](float a, float b) { return FAST_MAX ? fmaxf(a, b) : nan_max(a, b); };
    float q[3][3];  // translated + permuted vertices: q[v] = (x, y, z)
#pragma unroll
    for (int v = 0; v < 3; ++v) {
        const float tx = tri[3 * v + 0] - r.ox;
        const float ty = tri[3 * v + 1] - r.oy;
        const float tz = tri[3 * v + 2] - r.oz;
        q[v][0] = select_kz(kz, ty, tz, tx);
        q[v][1] = select_kz(kz, tz, tx, ty);
        q[v][2] = select_kz(kz, tx, ty, tz);
    }
    const float x0 = q[0][0] + r.sx * q[0][2], y0 = q[0][1] + r.sy * q[0][2];
    const float x1 = q[1][0] + r.sx * q[1][2], y1 = q[1][1] + r.sy * q[1][2];
    const float x2 = q[2][0] + r.sx * q[2][2], y2 = q[2][1] + r.sy * q[2][2];
    const float e0 = x1 * y2 - y1 * x2;
    const float e1 = x2 * y0 - y2 * x0;
    const float e2 = x0 * y1 - y0 * x1;
    const bool same_side =
        !(((e0 < 0.0f) || (e1 < 0.0f) || (e2 < 0.0f)) && ((e0 > 0.0f) || (e1 > 0.0f) || (e2 > 0.0f)));
    const float det = e0 + e1 + e2;
    const float z0 = q[0][2] * r.sz, z1 = q[1][2] * r.sz, z2 = q[2][2] * r.sz;
    const float t_scaled = e0 * z0 + e1 * z1 + e2 * z2;
    const bool in_range = (det < 0.0f) ? ((t_scaled < 0.0f) && (t_scaled >= t_best * det))
                                       : ((t_scaled > 0.0f) && (t_scaled <= t_best * det));
    const float inv_det = 1.0f / (det == 0.0f ? 1.0f : det);
    const float t = t_scaled * inv_det;

    // conservative fp-error rejection (reference triangle.rs:243-257)
    const float max_zt = vmax(fabsf(z0), vmax(fabsf(z1), fabsf(z2)));
    const float max_xt = vmax(fabsf(x0), vmax(fabsf(x1), fabsf(x2)));
    const float max_yt = vmax(fabsf(y0), vmax(fabsf(y1), fabsf(y2)));
    const float delta_z = k.g3 * max_zt;
    const float delta_x = k.g5 * (max_xt + max_zt);
    const float delta_y = k.g5 * (max_yt + max_zt);
    const float delta_e = 2.0f * (k.g2 * max_xt * max_yt + delta_y * max_xt + delta_x * max_yt);
    const float max_e = vmax(fabsf(e0), vmax(fabsf(e1), fabsf(e2)));
    const float delta_t =
        3.0f * (k.g3 * max_e * max_zt + delta_e * max_zt + delta_z * max_e) * fabsf(inv_det);

    const bool ok = same_side && (det != 0.0f) && in_range && (t > delta_t);
    return ok ? t : FLT_MAX;
}

// Stable-quadratic test of one ray against one sph16 row (cols 0-8 the
// world-to-object rotation rows, 9-11 its translation, 12 the radius, 13 a
// ±1 valid flag), with t_best as the range bound: the ray goes into the
// sphere's object space through its RAW direction, and |o + t d|² = r² is
// solved with the small root recovered as c/q and the discriminant from the
// perpendicular distance (reference sphere.rs:111-132). Operation for
// operation the JAX kernel's _sphere_tile_test, including the double-where
// square root and NaN-propagating min/max. Returns the hit t or FLT_MAX.
// 73 f32 operations (counted as for tri_test) on a valid row.
__device__ __forceinline__ float sphere_test(const float* s, const Ray& r, float t_best,
                                             const Consts&) {
    if (!(s[13] > 0.0f)) return FLT_MAX;  // padding row
    const float oox = s[0] * r.ox + s[1] * r.oy + s[2] * r.oz + s[9];
    const float ooy = s[3] * r.ox + s[4] * r.oy + s[5] * r.oz + s[10];
    const float ooz = s[6] * r.ox + s[7] * r.oy + s[8] * r.oz + s[11];
    const float ddx = s[0] * r.dx + s[1] * r.dy + s[2] * r.dz;
    const float ddy = s[3] * r.dx + s[4] * r.dy + s[5] * r.dz;
    const float ddz = s[6] * r.dx + s[7] * r.dy + s[8] * r.dz;

    const float a = ddx * ddx + ddy * ddy + ddz * ddz;
    const float safe_a = (a == 0.0f) ? 1.0f : a;
    const float b_half = oox * ddx + ooy * ddy + ooz * ddz;
    const float radius = s[12];
    const float r2 = radius * radius;
    const float c = oox * oox + ooy * ooy + ooz * ooz - r2;
    const float t_center = -b_half / safe_a;
    const float px = oox + t_center * ddx;
    const float py = ooy + t_center * ddy;
    const float pz = ooz + t_center * ddz;
    const float perp2 = px * px + py * py + pz * pz;
    const bool disc_ok = (perp2 <= r2) && (a > 0.0f);
    const float disc = a * (r2 - perp2);
    const float sq = (disc <= 0.0f) ? 0.0f : sqrtf(disc);
    const float sgn = (b_half >= 0.0f) ? 1.0f : -1.0f;
    const float q = -(b_half + sgn * sq);
    const float safe_q = (q == 0.0f) ? 1.0f : q;
    const float r1 = q / safe_a;
    const float r2q = (q == 0.0f) ? r1 : c / safe_q;
    const float t0 = nan_min(r1, r2q);
    const float t1 = nan_max(r1, r2q);
    const float t = (t0 >= 0.0f) ? t0 : t1;
    const bool ok = disc_ok && (t0 <= t_best) && (t1 >= 0.0f) && (t <= t_best);
    return ok ? t : FLT_MAX;
}

// The primitive tests as types, so one templated walk serves both. test() is
// the per-thread walk's (intersect.cu: each row read where it lies). The
// warp walk (intersect_warp.cu), whose lanes share one ray, uses the rest:
//   COLS, load(): the used columns of one 64-byte-aligned row, as 16- and
//     8-byte loads, into registers;
//   BY_AXIS, test_kz<KZ>(): the test on loaded columns; with BY_AXIS the
//     walk makes the ray's dominant axis a compile-time constant KZ (r.kz is
//     the same on every lane, so dispatching on it does not diverge);
//   shfl(): ray r of lane src on every lane — the fields the test and the
//     box test read (the triangle test the shear, the sphere test the raw
//     direction), no others;
//   NEG_ZERO: the test can return a hit at t = -0.0 (a sphere hit from a
//     ray that starts on its surface and leaves it: c / q = +0 / (q < 0));
//     a triangle hit's t is > delta_t >= 0.
struct TriPrim {
    static constexpr int COLS = 10;  // p0 xyz, p1 xyz, p2 xyz, valid
    static constexpr bool BY_AXIS = true;
    static constexpr bool NEG_ZERO = false;
    __device__ __forceinline__ static float test(const float* row, const Ray& r, float t_best,
                                                 const Consts& k) {
        return tri_test(row, r, t_best, k);
    }
    __device__ __forceinline__ static void load(const float* row, float* p) {
        const float4 a = __ldg(reinterpret_cast<const float4*>(row));
        const float4 b = __ldg(reinterpret_cast<const float4*>(row) + 1);
        const float2 c = __ldg(reinterpret_cast<const float2*>(row) + 4);
        p[0] = a.x, p[1] = a.y, p[2] = a.z, p[3] = a.w;
        p[4] = b.x, p[5] = b.y, p[6] = b.z, p[7] = b.w;
        p[8] = c.x, p[9] = c.y;
    }
    template <int KZ>
    __device__ __forceinline__ static float test_kz(const float* p, const Ray& r, float t_best,
                                                    const Consts& k) {
        return tri_test<KZ, true>(p, r, t_best, k);
    }
    __device__ __forceinline__ static Ray shfl(const Ray& r, int src) {
        constexpr unsigned FULL = 0xffffffffu;
        Ray q{};
        q.ox = __shfl_sync(FULL, r.ox, src);
        q.oy = __shfl_sync(FULL, r.oy, src);
        q.oz = __shfl_sync(FULL, r.oz, src);
        q.sx = __shfl_sync(FULL, r.sx, src);
        q.sy = __shfl_sync(FULL, r.sy, src);
        q.sz = __shfl_sync(FULL, r.sz, src);
        q.kz = __shfl_sync(FULL, r.kz, src);
        q.ix = __shfl_sync(FULL, r.ix, src);
        q.iy = __shfl_sync(FULL, r.iy, src);
        q.iz = __shfl_sync(FULL, r.iz, src);
        return q;
    }
};
struct SpherePrim {
    static constexpr int COLS = 14;  // w2o rows, translation, radius, valid
    static constexpr bool BY_AXIS = false;
    static constexpr bool NEG_ZERO = true;
    __device__ __forceinline__ static float test(const float* row, const Ray& r, float t_best,
                                                 const Consts& k) {
        return sphere_test(row, r, t_best, k);
    }
    __device__ __forceinline__ static void load(const float* row, float* p) {
        const float4 a = __ldg(reinterpret_cast<const float4*>(row));
        const float4 b = __ldg(reinterpret_cast<const float4*>(row) + 1);
        const float4 c = __ldg(reinterpret_cast<const float4*>(row) + 2);
        const float2 e = __ldg(reinterpret_cast<const float2*>(row) + 6);
        p[0] = a.x, p[1] = a.y, p[2] = a.z, p[3] = a.w;
        p[4] = b.x, p[5] = b.y, p[6] = b.z, p[7] = b.w;
        p[8] = c.x, p[9] = c.y, p[10] = c.z, p[11] = c.w;
        p[12] = e.x, p[13] = e.y;
    }
    template <int KZ>
    __device__ __forceinline__ static float test_kz(const float* p, const Ray& r, float t_best,
                                                    const Consts& k) {
        return sphere_test(p, r, t_best, k);
    }
    __device__ __forceinline__ static Ray shfl(const Ray& r, int src) {
        constexpr unsigned FULL = 0xffffffffu;
        Ray q{};
        q.ox = __shfl_sync(FULL, r.ox, src);
        q.oy = __shfl_sync(FULL, r.oy, src);
        q.oz = __shfl_sync(FULL, r.oz, src);
        q.dx = __shfl_sync(FULL, r.dx, src);
        q.dy = __shfl_sync(FULL, r.dy, src);
        q.dz = __shfl_sync(FULL, r.dz, src);
        q.ix = __shfl_sync(FULL, r.ix, src);
        q.iy = __shfl_sync(FULL, r.iy, src);
        q.iz = __shfl_sync(FULL, r.iz, src);
        return q;
    }
};

// The cluster tables every traversal kernel walks.
struct Tables {
    const float* prims;  // (n_clusters * block, PRIM_COLS): tris16 or sph16
    const float* caabb;  // (n_clusters, 8)
    const float* saabb;  // (n_clusters / SUPER_G, 8) when use_supers
    const float* slab;   // (n_slabs, 8)
    int block;
    int clusters_per_slab;
    int n_slabs;
    int use_supers;
};

inline Tables make_tables(const void* prims, const void* caabb, const void* saabb,
                          const void* slab, int block, int clusters_per_slab, int n_slabs,
                          int use_supers) {
    return Tables{static_cast<const float*>(prims), static_cast<const float*>(caabb),
                  static_cast<const float*>(saabb), static_cast<const float*>(slab),
                  block, clusters_per_slab, n_slabs, use_supers};
}

}  // namespace curry

// Plain C interface for ctypes. Pointers are device pointers; the launch goes
// on `stream` and does not synchronise. Each entry point returns
// cudaGetLastError(). `prims` is tris16 for the tri_* entry points and sph16
// for the sphere_* ones; `block` is block_t or block_s.
#define CURRY_TABLE_ARGS                                                                  \
    const void *o, const void *d, const void *t_max, const void *prims, const void *caabb, \
        const void *saabb, const void *slab, int n, int block, int clusters_per_slab,    \
        int n_slabs, int use_supers, float g2, float g3, float g5, float t_scale
#define CURRY_TABLES                                                                       \
    curry::make_tables(prims, caabb, saabb, slab, block, clusters_per_slab, n_slabs,     \
                       use_supers),                                                        \
        curry::Consts { g2, g3, g5, t_scale }

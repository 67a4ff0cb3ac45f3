// Closest-hit (K1) and any-hit (K2) ray-triangle traversal over the
// cluster tables of ops/kernels/intersect_kernel.py, for Hopper (sm_90a).
//
// Replaces the TPU kernels tri_closest_hit_tables and tri_any_hit_tables of
// curry_pbrt_tpu/ops/pallas/intersect_kernel.py (kernel bodies
// _make_closest_kernel and _make_any_kernel). Same tables, same results:
//   - triangles in kd/Morton order, block_t rows per cluster, clusters in
//     front-to-back order, SUPER_G clusters per super-cluster, and
//     clusters_per_slab clusters per slab; each level carries an AABB, and
//     the AABB of an empty cluster is NaN;
//   - per ray, a front-to-back walk: slab (only when there are several),
//     super (when use_supers), cluster, each gated by the widened slab test
//     against the ray's current best t;
//   - per entered cluster, every row is tested against the best t FROZEN at
//     the start of the cluster, the tile's smallest t wins (lowest row on an
//     exact tie), and it is accepted on strict improvement — or, for the
//     first hit, at exactly t_max. This per-cluster rule, not a per-triangle
//     one, is what makes the result bit-equal to the TPU kernel's tiles.
//
// What bounds it on an H100: FP32 ALU work per (ray, triangle) test and warp
// divergence between rays that enter different clusters. The tables are a
// few KB for the Cornell scenes (tens of KB for meshes); every thread of a
// warp reads the same row at the same time, so rows come from L1 as
// broadcasts and device memory traffic is O(rays). The design keeps the
// TPU kernel's block-granular cull at thread granularity: one thread per
// ray, each with its own best t, so a ray never tests a cluster that only
// its neighbours enter. Staging the tables in shared memory, warp-level
// voting and the ray sort are left for later work.
//
// Built by ops/kernels/build.py with nvcc -fmad=false (no fast math); the
// plain PyTorch versions beside the wrappers round identically.

#include <cuda_runtime.h>

#include "intersect.cuh"

namespace curry {

struct Tables {
    const float* tris16;  // (n_clusters * block_t, 16)
    const float* caabb;   // (n_clusters, 8)
    const float* saabb;   // (n_clusters / SUPER_G, 8) when use_supers
    const float* slab;    // (n_slabs, 8)
    int block_t;
    int clusters_per_slab;
    int n_slabs;
    int use_supers;
};

// Closest-hit state of one ray across the walk.
struct Closest {
    float t_best;
    int idx;
};

__device__ __forceinline__ void closest_cluster(const Tables& tb, int c, const Ray& r,
                                                const Consts& k, Closest& st) {
    if (!box_enter(tb.caabb + (size_t)c * BOX_COLS, r, st.t_best, k.t_scale)) return;
    const float frozen = st.t_best;
    const float* rows = tb.tris16 + (size_t)c * tb.block_t * TRI_COLS;
    float t_min = FLT_MAX;
    int row = 0;  // argmin of an all-miss tile is row 0, as in the TPU kernel
    for (int i = 0; i < tb.block_t; ++i) {
        const float t = tri_test(rows + (size_t)i * TRI_COLS, r, frozen, k);
        if (t < t_min) {
            t_min = t;
            row = i;
        }
    }
    const bool better =
        (t_min < frozen) || ((t_min == frozen) && (st.idx < 0) && (t_min < FLT_MAX));
    if (better) {
        st.t_best = t_min;
        st.idx = c * tb.block_t + row;
    }
}

__global__ void tri_closest_kernel(const float* __restrict__ o, const float* __restrict__ d,
                                   const float* __restrict__ t_max, Tables tb, Consts k, int n,
                                   float* __restrict__ t_out, int* __restrict__ row_out) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const Ray r = make_ray(o + 3 * (size_t)i, d + 3 * (size_t)i);
    Closest st{t_max[i], -1};
    const int cps = tb.clusters_per_slab;
    for (int j = 0; j < tb.n_slabs; ++j) {
        if (tb.n_slabs > 1 && !box_enter(tb.slab + (size_t)j * BOX_COLS, r, st.t_best, k.t_scale))
            continue;
        const int c0 = j * cps;
        if (tb.use_supers) {
            for (int s = 0; s < cps / SUPER_G; ++s) {
                const int sg = j * (cps / SUPER_G) + s;
                if (!box_enter(tb.saabb + (size_t)sg * BOX_COLS, r, st.t_best, k.t_scale)) continue;
                for (int c_off = 0; c_off < SUPER_G; ++c_off)
                    closest_cluster(tb, c0 + s * SUPER_G + c_off, r, k, st);
            }
        } else {
            for (int c = 0; c < cps; ++c) closest_cluster(tb, c0 + c, r, k, st);
        }
    }
    t_out[i] = st.idx >= 0 ? st.t_best : FLT_MAX;
    row_out[i] = st.idx;
}

// Any-hit: true as soon as one row of an entered cluster is hit within t_max.
__device__ __forceinline__ bool any_cluster(const Tables& tb, int c, const Ray& r, float t_max,
                                            const Consts& k) {
    if (!box_enter(tb.caabb + (size_t)c * BOX_COLS, r, t_max, k.t_scale)) return false;
    const float* rows = tb.tris16 + (size_t)c * tb.block_t * TRI_COLS;
    for (int i = 0; i < tb.block_t; ++i)
        if (tri_test(rows + (size_t)i * TRI_COLS, r, t_max, k) < FLT_MAX) return true;
    return false;
}

__device__ bool any_walk(const Tables& tb, const Ray& r, float t_max, const Consts& k) {
    const int cps = tb.clusters_per_slab;
    for (int j = 0; j < tb.n_slabs; ++j) {
        if (tb.n_slabs > 1 && !box_enter(tb.slab + (size_t)j * BOX_COLS, r, t_max, k.t_scale))
            continue;
        const int c0 = j * cps;
        if (tb.use_supers) {
            for (int s = 0; s < cps / SUPER_G; ++s) {
                const int sg = j * (cps / SUPER_G) + s;
                if (!box_enter(tb.saabb + (size_t)sg * BOX_COLS, r, t_max, k.t_scale)) continue;
                for (int c_off = 0; c_off < SUPER_G; ++c_off)
                    if (any_cluster(tb, c0 + s * SUPER_G + c_off, r, t_max, k)) return true;
            }
        } else {
            for (int c = 0; c < cps; ++c)
                if (any_cluster(tb, c0 + c, r, t_max, k)) return true;
        }
    }
    return false;
}

__global__ void tri_any_kernel(const float* __restrict__ o, const float* __restrict__ d,
                               const float* __restrict__ t_max, Tables tb, Consts k, int n,
                               bool* __restrict__ hit_out) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const Ray r = make_ray(o + 3 * (size_t)i, d + 3 * (size_t)i);
    hit_out[i] = any_walk(tb, r, t_max[i], k);
}

constexpr int THREADS = 256;

Tables make_tables(const void* tris16, const void* caabb, const void* saabb, const void* slab,
                   int block_t, int clusters_per_slab, int n_slabs, int use_supers) {
    return Tables{static_cast<const float*>(tris16), static_cast<const float*>(caabb),
                  static_cast<const float*>(saabb),  static_cast<const float*>(slab),
                  block_t, clusters_per_slab, n_slabs, use_supers};
}

}  // namespace curry

// Plain C interface for ctypes. Pointers are device pointers; the launch goes
// on `stream` and does not synchronise. Returns cudaGetLastError().
extern "C" int curry_tri_closest_hit(const void* o, const void* d, const void* t_max,
                                     const void* tris16, const void* caabb, const void* saabb,
                                     const void* slab, int n, int block_t,
                                     int clusters_per_slab, int n_slabs, int use_supers,
                                     float g2, float g3, float g5, float t_scale, void* t_out,
                                     void* row_out, void* stream) {
    using namespace curry;
    const Tables tb = make_tables(tris16, caabb, saabb, slab, block_t, clusters_per_slab,
                                  n_slabs, use_supers);
    const Consts k{g2, g3, g5, t_scale};
    const int blocks = (n + THREADS - 1) / THREADS;
    tri_closest_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(o), static_cast<const float*>(d),
        static_cast<const float*>(t_max), tb, k, n, static_cast<float*>(t_out),
        static_cast<int*>(row_out));
    return static_cast<int>(cudaGetLastError());
}

extern "C" int curry_tri_any_hit(const void* o, const void* d, const void* t_max,
                                 const void* tris16, const void* caabb, const void* saabb,
                                 const void* slab, int n, int block_t, int clusters_per_slab,
                                 int n_slabs, int use_supers, float g2, float g3, float g5,
                                 float t_scale, void* hit_out, void* stream) {
    using namespace curry;
    const Tables tb = make_tables(tris16, caabb, saabb, slab, block_t, clusters_per_slab,
                                  n_slabs, use_supers);
    const Consts k{g2, g3, g5, t_scale};
    const int blocks = (n + THREADS - 1) / THREADS;
    tri_any_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(o), static_cast<const float*>(d),
        static_cast<const float*>(t_max), tb, k, n, static_cast<bool*>(hit_out));
    return static_cast<int>(cudaGetLastError());
}

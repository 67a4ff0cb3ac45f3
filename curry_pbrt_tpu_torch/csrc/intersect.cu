// Closest-hit and any-hit traversal over cluster tables, for Hopper (sm_90a):
// triangles (K1, K2; tables of ops/kernels/intersect_kernel.py) and spheres
// (K3; tables of ops/kernels/sphere_kernel.py).
//
// Replaces the TPU kernels tri_closest_hit_tables / tri_any_hit_tables of
// curry_pbrt_tpu/ops/pallas/intersect_kernel.py (kernel bodies
// _make_closest_kernel and _make_any_kernel, including the stats=True
// variant) and sphere_closest_hit_tables / sphere_any_hit_tables of
// curry_pbrt_tpu/ops/pallas/sphere_kernel.py (the same kernel bodies with
// tile_test=_sphere_tile_test). Same tables, same results:
//   - primitives in kd order, `block` rows per cluster, clusters in
//     front-to-back order, SUPER_G clusters per super-cluster, and
//     clusters_per_slab clusters per slab; each level carries an AABB, and
//     the AABB of an empty cluster is NaN;
//   - per ray, a front-to-back walk: slab (only when there are several),
//     super (when use_supers), cluster, each gated by the widened slab test
//     against the ray's current best t;
//   - per entered cluster, every row is tested against the best t FROZEN at
//     the start of the cluster, the tile's smallest t wins (lowest row on an
//     exact tie), and it is accepted on strict improvement — or, for the
//     first hit, at exactly t_max. This per-cluster rule, not a per-primitive
//     one, is what makes the result bit-equal to the TPU kernel's tiles.
// One walk, templated over the primitive test (TriPrim / SpherePrim in
// intersect.cuh), serves every kernel, so all share the acceptance rule.
//
// Stats (the closest-hit kernel's STATS template flag): per ray, the number
// of cluster tiles it entered and of those that improved its best t. The
// TPU kernel counts per 128/256-lane sub-group; here each thread is one
// ray, so the counts are per ray. The flag is a template parameter: the
// render path's instantiation carries no counters.
//
// What bounds it on an H100: FP32 ALU work per (ray, primitive) test and
// warp divergence between rays that enter different clusters. The tables
// are a few KB for the Cornell scenes and up to tens of MB for the largest
// meshes; every thread of a warp that enters a cluster reads the same row
// at the same time, so rows come from L1/L2 as broadcasts and device memory
// traffic is O(rays). The design keeps the TPU kernel's block-granular cull
// at thread granularity: one thread per ray, each with its own best t, so a
// ray never tests a cluster that only its neighbours enter. Staging the
// tables in shared memory and warp-level voting are left for later work;
// the ray sort (ops/kernels/aggregate.py) groups similar rays into warps.
//
// Built by ops/kernels/build.py with nvcc -fmad=false (no fast math, IEEE
// division and square root); the plain PyTorch versions beside the wrappers
// round identically.

#include <cuda_runtime.h>

#include "intersect.cuh"

namespace curry {

// The slab → super → cluster walk of every kernel: calls visit(c) for each
// cluster, in table order, whose slab and super boxes the ray enters, with
// bound() — the ray's bound at that moment — in each box test. A visit that
// returns true ends the walk (any hit).
template <class Bound, class Visit>
__device__ __forceinline__ void walk(const Tables& tb, const Ray& r, const Consts& k, Bound bound,
                                     Visit visit) {
    const int cps = tb.clusters_per_slab;
    const int n_sup = cps / SUPER_G;
    for (int j = 0; j < tb.n_slabs; ++j) {
        if (tb.n_slabs > 1 && !box_enter(tb.slab + (size_t)j * BOX_COLS, r, bound(), k.t_scale))
            continue;
        const int c0 = j * cps;
        if (tb.use_supers) {
            for (int s = 0; s < n_sup; ++s) {
                if (!box_enter(tb.saabb + (size_t)(j * n_sup + s) * BOX_COLS, r, bound(),
                               k.t_scale))
                    continue;
                for (int c_off = 0; c_off < SUPER_G; ++c_off)
                    if (visit(c0 + s * SUPER_G + c_off)) return;
            }
        } else {
            for (int c = 0; c < cps; ++c)
                if (visit(c0 + c)) return;
        }
    }
}

// Closest-hit state of one ray across the walk.
struct Closest {
    float t_best;
    int idx;
    int entered;   // STATS only
    int improved;  // STATS only
};

template <class Prim, bool STATS>
__device__ __forceinline__ void closest_cluster(const Tables& tb, int c, const Ray& r,
                                                const Consts& k, Closest& st) {
    if (!box_enter(tb.caabb + (size_t)c * BOX_COLS, r, st.t_best, k.t_scale)) return;
    if (STATS) ++st.entered;
    const float frozen = st.t_best;
    const float* rows = tb.prims + (size_t)c * tb.block * PRIM_COLS;
    float t_min = FLT_MAX;
    int row = 0;  // argmin of an all-miss tile is row 0, as in the TPU kernel
    for (int i = 0; i < tb.block; ++i) {
        const float t = Prim::test(rows + (size_t)i * PRIM_COLS, r, frozen, k);
        if (t < t_min) {
            t_min = t;
            row = i;
        }
    }
    const bool better =
        (t_min < frozen) || ((t_min == frozen) && (st.idx < 0) && (t_min < FLT_MAX));
    if (better) {
        st.t_best = t_min;
        st.idx = c * tb.block + row;
        if (STATS) ++st.improved;
    }
}

template <class Prim, bool STATS>
__global__ void closest_kernel(const float* __restrict__ o, const float* __restrict__ d,
                               const float* __restrict__ t_max, Tables tb, Consts k, int n,
                               float* __restrict__ t_out, int* __restrict__ row_out,
                               int* __restrict__ entered_out, int* __restrict__ improved_out) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const Ray r = make_ray(o + 3 * (size_t)i, d + 3 * (size_t)i);
    Closest st{t_max[i], -1, 0, 0};
    walk(tb, r, k, [&] { return st.t_best; },
         [&](int c) {
             closest_cluster<Prim, STATS>(tb, c, r, k, st);
             return false;
         });
    t_out[i] = st.idx >= 0 ? st.t_best : FLT_MAX;
    row_out[i] = st.idx;
    if (STATS) {
        entered_out[i] = st.entered;
        improved_out[i] = st.improved;
    }
}

// Any-hit: true as soon as one row of an entered cluster is hit within t_max.
template <class Prim>
__device__ __forceinline__ bool any_cluster(const Tables& tb, int c, const Ray& r, float t_max,
                                            const Consts& k) {
    if (!box_enter(tb.caabb + (size_t)c * BOX_COLS, r, t_max, k.t_scale)) return false;
    const float* rows = tb.prims + (size_t)c * tb.block * PRIM_COLS;
    for (int i = 0; i < tb.block; ++i)
        if (Prim::test(rows + (size_t)i * PRIM_COLS, r, t_max, k) < FLT_MAX) return true;
    return false;
}

template <class Prim>
__global__ void any_kernel(const float* __restrict__ o, const float* __restrict__ d,
                           const float* __restrict__ t_max, Tables tb, Consts k, int n,
                           bool* __restrict__ hit_out) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const Ray r = make_ray(o + 3 * (size_t)i, d + 3 * (size_t)i);
    const float tm = t_max[i];
    bool hit = false;
    walk(tb, r, k, [&] { return tm; },
         [&](int c) {
             hit = any_cluster<Prim>(tb, c, r, tm, k);
             return hit;
         });
    hit_out[i] = hit;
}

constexpr int THREADS = 256;

// Launches the closest-hit kernel over primitive type Prim. Returns
// cudaGetLastError().
template <class Prim, bool STATS>
int launch_closest(const void* o, const void* d, const void* t_max, const Tables& tb,
                   const Consts& k, int n, void* t_out, void* row_out, void* entered_out,
                   void* improved_out, void* stream) {
    const int blocks = (n + THREADS - 1) / THREADS;
    closest_kernel<Prim, STATS><<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(o), static_cast<const float*>(d),
        static_cast<const float*>(t_max), tb, k, n, static_cast<float*>(t_out),
        static_cast<int*>(row_out), static_cast<int*>(entered_out),
        static_cast<int*>(improved_out));
    return static_cast<int>(cudaGetLastError());
}

template <class Prim>
int launch_any(const void* o, const void* d, const void* t_max, const Tables& tb,
               const Consts& k, int n, void* hit_out, void* stream) {
    const int blocks = (n + THREADS - 1) / THREADS;
    any_kernel<Prim><<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(o), static_cast<const float*>(d),
        static_cast<const float*>(t_max), tb, k, n, static_cast<bool*>(hit_out));
    return static_cast<int>(cudaGetLastError());
}

}  // namespace curry

// The C interface (CURRY_TABLE_ARGS, intersect.cuh).

// Closest hit over triangles; the stats instantiation (K1b) when entered_out
// and improved_out are not null.
extern "C" int curry_tri_closest_hit(CURRY_TABLE_ARGS, void* t_out, void* row_out,
                                     void* entered_out, void* improved_out, void* stream) {
    using curry::TriPrim;
    if (entered_out != nullptr)
        return curry::launch_closest<TriPrim, true>(o, d, t_max, CURRY_TABLES, n, t_out, row_out,
                                                    entered_out, improved_out, stream);
    return curry::launch_closest<TriPrim, false>(o, d, t_max, CURRY_TABLES, n, t_out, row_out,
                                                 nullptr, nullptr, stream);
}

extern "C" int curry_tri_any_hit(CURRY_TABLE_ARGS, void* hit_out, void* stream) {
    return curry::launch_any<curry::TriPrim>(o, d, t_max, CURRY_TABLES, n, hit_out, stream);
}

extern "C" int curry_sphere_closest_hit(CURRY_TABLE_ARGS, void* t_out, void* row_out,
                                        void* stream) {
    return curry::launch_closest<curry::SpherePrim, false>(o, d, t_max, CURRY_TABLES, n, t_out,
                                                           row_out, nullptr, nullptr, stream);
}

extern "C" int curry_sphere_any_hit(CURRY_TABLE_ARGS, void* hit_out, void* stream) {
    return curry::launch_any<curry::SpherePrim>(o, d, t_max, CURRY_TABLES, n, hit_out, stream);
}

// Group-granular closest-hit and any-hit triangle traversal (K4), for
// Hopper (sm_90a): one warp walks one group of 8 rays.
//
// Replaces the TPU kernels tri_closest_hit_groups / tri_any_hit_groups of
// curry_pbrt_tpu/ops/pallas/intersect_group.py (kernel bodies
// _make_group_closest_kernel and _make_group_any_kernel, with _box8 and
// _tile8). It computes what K1 / K2 compute (intersect.cu) on the same
// TriTables — the same slab → super → cluster walk in table order, the same
// widened box test, the same per-cluster acceptance rule — and differs only
// in who tests a cluster: every ray of an 8-ray group tests it as soon as
// one ray of the group enters its box. The box test is conservative, so the
// extra tests find nothing the entering rays' walk would not, and t is
// bit-equal to K1's; rows agree up to exact-t ties.
//
// The TPU kernel puts the 8 rays on sublanes against 128 triangles on
// lanes. Here the 8-ray group is one warp:
//   - box tests: lanes 0-7 test the slab, super and cluster boxes for their
//     own ray against its current best t (dead lanes carry t_max 0 and never
//     enter; empty clusters' NaN boxes are never entered); __ballot_sync
//     decides entry for the whole group, so all 32 lanes follow one path;
//   - tile test: on entry the 32 lanes split the cluster's rows (row lane,
//     lane + 32, ...) and test each against every live ray of the group,
//     each ray with its best t frozen at the cluster's start (K1's rule),
//     through TriPrim::test (intersect.cuh), so the per-pair arithmetic is
//     K1's;
//   - reduction: a butterfly over the warp gives each ray its tile minimum,
//     reduced on (t, row) lexicographically, so the lowest row wins an exact
//     tie, as K1's in-order scan does; lane r then accepts it for ray r on
//     strict improvement, or for a first hit at exactly t_max;
//   - any hit: rays that have hit carry bound 0 in the box votes and are not
//     tested again; the group leaves as soon as no live ray is left;
//   - the tail group is padded with dead rays (t_max 0); no lane returns
//     while its warp still votes.
// The walk always has the super level: the wrapper raises unless
// clusters_per_slab is a multiple of SUPER_G and there is one super box per
// SUPER_G clusters (the TPU kernel swept clusters_per_slab // SUPER_G supers
// without that guard).
//
// What bounds it on an H100: FP32 ALU work, as for K1 — 84 operations per
// (ray, triangle) test, now for all 8 rays of every group that enters a
// cluster. The design trades more tests (group- instead of ray-granular
// culling) for no divergence inside a tile: all 32 lanes run the same row
// loop, and rows are read by neighbouring lanes from neighbouring addresses.
// The rays live in shared memory (8 per warp) and are read as broadcasts.
//
// Built by ops/kernels/build.py with nvcc -fmad=false (no fast math).

#include <cuda_runtime.h>

#include "intersect.cuh"

namespace curry {
namespace {

constexpr int GROUP = 8;  // rays per group: GROUP_R of the TPU kernel
constexpr int WARP = 32;
constexpr int WARPS_PER_BLOCK = 4;
constexpr unsigned FULL = 0xffffffffu;
constexpr int TRI_USED = 10;  // tris16 columns the triangle test reads

// True on every lane when `pred` holds on any lane.
__device__ __forceinline__ bool vote(bool pred) { return __ballot_sync(FULL, pred) != 0u; }

// Lane r < GROUP stores ray g * GROUP + r in rays[r] and returns its t_max;
// the tail group's missing rays are dead (t_max 0, a valid direction).
// Lanes >= GROUP return 0.
__device__ __forceinline__ float load_group(const float* o, const float* d, const float* t_max,
                                            int n, int g, int lane, Ray* rays) {
    float tm = 0.0f;
    if (lane < GROUP) {
        const int i = g * GROUP + lane;
        if (i < n) {
            rays[lane] = make_ray(o + 3 * (size_t)i, d + 3 * (size_t)i);
            tm = t_max[i];
        } else {
            const float dead_o[3] = {0.0f, 0.0f, 0.0f};
            const float dead_d[3] = {0.0f, 0.0f, 1.0f};
            rays[lane] = make_ray(dead_o, dead_d);
        }
    }
    __syncwarp();
    return tm;
}

// The slab → super → cluster walk of one group: visit(c) for every cluster,
// in table order, whose slab, super and own box at least one ray of the
// group enters, each ray testing against bound(), its bound at that moment
// (0 on lanes >= GROUP). With one slab the slab box is not tested; a group
// with no live ray skips the sweep. A visit that returns true ends the walk.
template <class Bound, class Visit>
__device__ __forceinline__ void group_walk(const Tables& tb, const Ray& r, const Consts& k,
                                           int lane, Bound bound, Visit visit) {
    const int cps = tb.clusters_per_slab;
    const int n_sup = cps / SUPER_G;
    const bool mine = lane < GROUP;
    for (int j = 0; j < tb.n_slabs; ++j) {
        const bool slab_in =
            tb.n_slabs > 1
                ? mine && box_enter(tb.slab + (size_t)j * BOX_COLS, r, bound(), k.t_scale)
                : bound() > 0.0f;
        if (!vote(slab_in)) continue;
        for (int s = 0; s < n_sup; ++s) {
            if (!vote(mine && box_enter(tb.saabb + (size_t)(j * n_sup + s) * BOX_COLS, r,
                                        bound(), k.t_scale)))
                continue;
            for (int c_off = 0; c_off < SUPER_G; ++c_off) {
                const int c = j * cps + s * SUPER_G + c_off;
                if (!vote(mine && box_enter(tb.caabb + (size_t)c * BOX_COLS, r, bound(),
                                            k.t_scale)))
                    continue;
                if (visit(c)) return;
            }
        }
    }
}

// Loads the triangle test's columns of one tris16 row into registers.
__device__ __forceinline__ void load_row(const float* row, float* tri) {
#pragma unroll
    for (int m = 0; m < TRI_USED; ++m) tri[m] = row[m];
}

// One entered cluster of the closest-hit walk: every live ray of the group
// tests every row against its best t frozen at the cluster's start; lane
// r < GROUP then updates ray r's (t_best, idx).
__device__ __forceinline__ void closest_tile(const Tables& tb, int c, const Ray* rays,
                                             const Consts& k, int lane, float& t_best,
                                             int& idx) {
    float frozen[GROUP], bt[GROUP];
    int br[GROUP];
#pragma unroll
    for (int q = 0; q < GROUP; ++q) {
        frozen[q] = __shfl_sync(FULL, t_best, q);
        bt[q] = FLT_MAX;
        br[q] = 0;
    }
    const float* rows = tb.prims + (size_t)c * tb.block * PRIM_COLS;
    for (int i = lane; i < tb.block; i += WARP) {
        float tri[TRI_USED];
        load_row(rows + (size_t)i * PRIM_COLS, tri);
#pragma unroll
        for (int q = 0; q < GROUP; ++q) {
            if (!(frozen[q] > 0.0f)) continue;  // a dead ray never hits (warp-uniform)
            const float t = TriPrim::test(tri, rays[q], frozen[q], k);
            if (t < bt[q]) {  // rows ascend per lane: the lane's lowest row wins a tie
                bt[q] = t;
                br[q] = i;
            }
        }
    }
    float my_t = FLT_MAX;
    int my_row = 0;
#pragma unroll
    for (int q = 0; q < GROUP; ++q) {
#pragma unroll
        for (int off = WARP / 2; off > 0; off >>= 1) {
            const float ot = __shfl_xor_sync(FULL, bt[q], off);
            const int orow = __shfl_xor_sync(FULL, br[q], off);
            if (ot < bt[q] || (ot == bt[q] && orow < br[q])) {
                bt[q] = ot;
                br[q] = orow;
            }
        }
        if (lane == q) {
            my_t = bt[q];
            my_row = br[q];
        }
    }
    if (lane < GROUP) {
        const bool better =
            (my_t < t_best) || ((my_t == t_best) && (idx < 0) && (my_t < FLT_MAX));
        if (better) {
            t_best = my_t;
            idx = c * tb.block + my_row;
        }
    }
}

__global__ void closest_group_kernel(const float* __restrict__ o, const float* __restrict__ d,
                                     const float* __restrict__ t_max, Tables tb, Consts k, int n,
                                     float* __restrict__ t_out, int* __restrict__ row_out) {
    __shared__ Ray rays_s[WARPS_PER_BLOCK][GROUP];
    const int lane = threadIdx.x % WARP;
    const int w = threadIdx.x / WARP;
    const int g = blockIdx.x * WARPS_PER_BLOCK + w;
    if (g * GROUP >= n) return;  // the whole warp: g is warp-uniform
    Ray* rays = rays_s[w];
    float t_best = load_group(o, d, t_max, n, g, lane, rays);
    const Ray r = rays[lane % GROUP];
    int idx = -1;
    group_walk(tb, r, k, lane, [&] { return t_best; },
               [&](int c) {
                   closest_tile(tb, c, rays, k, lane, t_best, idx);
                   return false;
               });
    const int i = g * GROUP + lane;
    if (lane < GROUP && i < n) {
        t_out[i] = idx >= 0 ? t_best : FLT_MAX;
        row_out[i] = idx;
    }
}

__global__ void any_group_kernel(const float* __restrict__ o, const float* __restrict__ d,
                                 const float* __restrict__ t_max, Tables tb, Consts k, int n,
                                 bool* __restrict__ hit_out) {
    __shared__ Ray rays_s[WARPS_PER_BLOCK][GROUP];
    const int lane = threadIdx.x % WARP;
    const int w = threadIdx.x / WARP;
    const int g = blockIdx.x * WARPS_PER_BLOCK + w;
    if (g * GROUP >= n) return;
    Ray* rays = rays_s[w];
    const float tm = load_group(o, d, t_max, n, g, lane, rays);
    const Ray r = rays[lane % GROUP];
    float tq[GROUP];  // every ray's t_max, on every lane
#pragma unroll
    for (int q = 0; q < GROUP; ++q) tq[q] = __shfl_sync(FULL, tm, q);
    bool hit = false;
    group_walk(tb, r, k, lane, [&] { return hit ? 0.0f : tm; },
               [&](int c) {
                   // the rays still to test: live and not yet hit (warp-uniform)
                   const unsigned todo = __ballot_sync(FULL, lane < GROUP && !hit && tm > 0.0f);
                   const float* rows = tb.prims + (size_t)c * tb.block * PRIM_COLS;
                   unsigned bits = 0u;
                   for (int i = lane; i < tb.block; i += WARP) {
                       float tri[TRI_USED];
                       load_row(rows + (size_t)i * PRIM_COLS, tri);
#pragma unroll
                       for (int q = 0; q < GROUP; ++q)
                           if (((todo >> q) & 1u) && TriPrim::test(tri, rays[q], tq[q], k) < FLT_MAX)
                               bits |= 1u << q;
                   }
                   bits = __reduce_or_sync(FULL, bits);
                   if (lane < GROUP && ((bits >> lane) & 1u)) hit = true;
                   return !vote(lane < GROUP && !hit && tm > 0.0f);  // no live ray left
               });
    const int i = g * GROUP + lane;
    if (lane < GROUP && i < n) hit_out[i] = hit;
}

int blocks_for(int n) {
    const int groups = (n + GROUP - 1) / GROUP;
    return (groups + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
}

}  // namespace
}  // namespace curry

// The C interface (CURRY_TABLE_ARGS, intersect.cuh). The walk always has the
// super level, so `use_supers` is not read; tables whose clusters_per_slab
// is not a multiple of SUPER_G are refused with cudaErrorInvalidValue.

extern "C" int curry_tri_closest_hit_groups(CURRY_TABLE_ARGS, void* t_out, void* row_out,
                                            void* stream) {
    if (clusters_per_slab % curry::SUPER_G != 0) return static_cast<int>(cudaErrorInvalidValue);
    const curry::Tables tb = curry::make_tables(prims, caabb, saabb, slab, block,
                                                clusters_per_slab, n_slabs, use_supers);
    curry::closest_group_kernel<<<curry::blocks_for(n), curry::WARPS_PER_BLOCK * curry::WARP, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(o), static_cast<const float*>(d),
        static_cast<const float*>(t_max), tb, curry::Consts{g2, g3, g5, t_scale}, n,
        static_cast<float*>(t_out), static_cast<int*>(row_out));
    return static_cast<int>(cudaGetLastError());
}

extern "C" int curry_tri_any_hit_groups(CURRY_TABLE_ARGS, void* hit_out, void* stream) {
    if (clusters_per_slab % curry::SUPER_G != 0) return static_cast<int>(cudaErrorInvalidValue);
    const curry::Tables tb = curry::make_tables(prims, caabb, saabb, slab, block,
                                                clusters_per_slab, n_slabs, use_supers);
    curry::any_group_kernel<<<curry::blocks_for(n), curry::WARPS_PER_BLOCK * curry::WARP, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(o), static_cast<const float*>(d),
        static_cast<const float*>(t_max), tb, curry::Consts{g2, g3, g5, t_scale}, n,
        static_cast<bool*>(hit_out));
    return static_cast<int>(cudaGetLastError());
}

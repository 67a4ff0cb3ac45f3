// Group-granular closest-hit and any-hit triangle traversal (K4), for
// Hopper (sm_90a): one warp walks one group of 8 consecutive rays, which
// share the walk and every row load.
//
// Replaces the TPU kernels tri_closest_hit_groups / tri_any_hit_groups of
// curry_pbrt_tpu/ops/pallas/intersect_group.py (kernel bodies
// _make_group_closest_kernel and _make_group_any_kernel, with _box8 and
// _tile8). It computes what K1 / K2 compute (intersect.cuh's rules) on the
// same TriTables — the same slab → super → cluster walk in table order, the
// same widened box test, the same per-cluster acceptance rule — and its
// results are those of the plain versions (ops/kernels/intersect_group.py),
// which keep the TPU kernel's group rule: a ray tests a cluster as soon as
// one ray of its group enters the cluster's box.
//
// The walk: lanes 0-7 test the slab, super and cluster boxes for their own
// ray against its bound at that moment (dead lanes carry 0 and never enter;
// empty clusters' NaN boxes are never entered), and __ballot_sync of the
// strict test (box_enter) decides whether the group visits, so all 32 lanes
// follow one path and the group visits exactly the clusters the group rule
// visits, in the same order. A visited cluster's rows are read once for the
// whole group.
//
// The gate: inside a visited cluster ray q tests the rows only if its own
// box test passes in the non-strict form, with a slack,
//     box_near(caabb[c], ray_q) <= t_best_q * GATE_SLACK  &&  t_best_q > 0
// (box_near, intersect.cuh: the ray's entry distance tn into the box, NaN
// for a box it never enters; GATE_SLACK = 1 + 2^-16), or its bound is +inf.
// Why the outputs are the group rule's (the plain versions'):
//   - a hit the group rule accepts for ray q in cluster c has t < t_best_q,
//     or t == t_best_q == t_max as the ray's first hit (K1's rule). So the
//     gate may skip c for q only where no row of c gives q a t <= t_best_q;
//   - a triangle lies inside its cluster's box, so its exact hit distance
//     is at least the exact tn. The computed values can cross: tn is
//     (bmin - o) * inv_d, the triangle's t comes out of the sheared space
//     with its own rounding, and for a triangle on a face of the box (an
//     axis-aligned wall) t falls up to 6 × 2^-24 relative below tn
//     (measured on walls across the rays' dominant axis and across
//     another, tests/test_torch_intersect_group.py). A gate of
//     tn <= t_best loses such a hit where t_best lies between the two
//     (coplanar triangles split over clusters give it, the same tests), and
//     a strict tn < t_best gate also loses the first hit at exactly t_max
//     where tn == t_max;
//   - the slack, 2^-16, is 40 times the widest crossing measured, and costs
//     only the clusters whose entry lies within it beyond t_best. Equality
//     with the group rule therefore rests on that bound on the rounding,
//     which is measured, not proved for every triangle; it is held bit for
//     bit on every batch the tests and chip_smoke.py run;
//   - with a bound of +inf the group rule accepts even an all-miss tile
//     (t = FLT_MAX, row 0 of the first tile tested): such a ray tests every
//     visited cluster.
// K1's per-ray walk enters a cluster only when tn < t_best, so where t falls
// below tn (the crossings above, the first hit at exactly t_max) its result
// can differ from the group rule's, and so from this kernel's.
// The gated rays are a warp-uniform bitmask from one ballot; the tile work
// is that of a per-ray walk over these tables plus the clusters whose box a
// ray enters only while its group visits them.
//
// Inside a visited cluster:
//   - rows: lane l holds rows l, l + 32, l + 64, l + 96 of the cluster (a
//     128-row chunk; larger clusters take several) in registers, their 10
//     used columns read as 16- and 8-byte loads, loaded once for all gated
//     rays;
//   - rays: the lanes take the gated rays one after another; each ray's
//     fields are read once a cluster from shared memory (a broadcast) into
//     registers, and its dominant axis, the same on every lane, makes the
//     triangle test's permutation a compile-time constant (tri_test<KZ>,
//     intersect.cuh: the same result as the run-time test);
//   - reduction: two __reduce_min_sync give each gated ray the tile's least
//     t and the lowest row holding it (the lanes scan their rows in
//     ascending order), as the plain version's first-index minimum does;
//     lane q accepts it for ray q on strict improvement, or for a first hit
//     at exactly t_max;
//   - any hit: a ray that has hit carries bound 0 in the box votes and the
//     gate, and is not tested again; the group leaves as soon as no live
//     ray is left.
// The tail group is padded with dead rays (t_max 0); no lane returns while
// its warp still votes. The walk always has the super level: the wrapper
// raises unless clusters_per_slab is a multiple of SUPER_G and there is one
// super box per SUPER_G clusters (the TPU kernel swept clusters_per_slab //
// SUPER_G supers without that guard).
//
// The first port of the TPU kernel, retired since, tested every live ray of
// the group against every visited cluster (the group rule itself), rows
// re-read for each, with a butterfly of 5 levels × 2 shuffles for each of
// the 8 rays of every visited cluster; this design measured 4.3x faster at
// a mesh bounce (PERF.md).
//
// What bounds it on an H100: FP32 ALU work, as for K1 — 84 operations per
// (ray, triangle) test — and the box votes, which only lanes 0-7 do.
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
constexpr int TRI_USED = 10;                 // tris16 columns the triangle test reads
constexpr int CHUNK_ROWS = 128;              // rows the warp holds in registers at once
constexpr int HELD = CHUNK_ROWS / WARP;      // of them, rows a lane holds
constexpr float GATE_SLACK = 1.0f + 1.0f / 65536.0f;  // the gate's slack (see the header)

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

// The slab → super → cluster walk of one group: visit(c, gate) for every
// cluster, in table order, whose slab, super and own box at least one ray of
// the group enters (box_enter), each ray testing against bound(), its bound
// at that moment (0 on lanes >= GROUP); `gate` has bit q set when ray q's
// own non-strict test of the cluster's box, with GATE_SLACK, passes (see the
// header). With one slab the slab box is not tested; a group with no live ray
// skips the sweep. A visit that returns true ends the walk.
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
                const float* box = tb.caabb + (size_t)c * BOX_COLS;
                const float b = bound();
                // box_enter(box, r, b) == tn < b && b > 0 (intersect.cuh)
                const float tn = mine ? box_near(box, r, k.t_scale) : __int_as_float(0x7fc00000);
                if (!vote(tn < b && b > 0.0f)) continue;
                const unsigned gate =
                    __ballot_sync(FULL, (tn <= b * GATE_SLACK || isinf(b)) && b > 0.0f);
                if (visit(c, gate)) return;
            }
        }
    }
}

// ---------------------------------------------------------------------------
// the gated rays of a group over rows held in registers

// Rows base + lane + 32 j (j < HELD) of one cluster into registers; a row at
// or past `block` is marked padding (valid column -1: the test misses).
__device__ __forceinline__ void load_held(const float* rows, int base, int block, int lane,
                                          float (&p)[HELD][TRI_USED]) {
#pragma unroll
    for (int j = 0; j < HELD; ++j) {
        const int i = base + lane + WARP * j;
        if (i < block)
            TriPrim::load(rows + (size_t)i * PRIM_COLS, p[j]);
        else
            p[j][9] = -1.0f;
    }
}

// This lane's held rows against ray r with bound `bound`, the ray's dominant
// axis KZ at compile time: the least t and its row into (bt, br), rows
// ascending, so the lane's lowest row wins a tie.
template <int KZ>
__device__ __forceinline__ void test_held(const float (&p)[HELD][TRI_USED], int base, int lane,
                                          const Ray& r, float bound, const Consts& k, float& bt,
                                          int& br) {
#pragma unroll
    for (int j = 0; j < HELD; ++j) {
        const float t = tri_test<KZ, true>(p[j], r, bound, k);
        if (t < bt) {
            bt = t;
            br = base + lane + WARP * j;
        }
    }
}

// test_held with r.kz, the same on every lane, as the compile-time axis.
__device__ __forceinline__ void test_held_kz(const float (&p)[HELD][TRI_USED], int base, int lane,
                                             const Ray& r, float bound, const Consts& k,
                                             float& bt, int& br) {
    if (r.kz == 0)
        test_held<0>(p, base, lane, r, bound, k, bt, br);
    else if (r.kz == 1)
        test_held<1>(p, base, lane, r, bound, k, bt, br);
    else
        test_held<2>(p, base, lane, r, bound, k, bt, br);
}

// The tile's (t, row) over the warp, on every lane: the least t, then the
// lowest row among the lanes that hold it, keyed by t's bits, which order as
// the floats do on a triangle hit's t > 0 and a miss's FLT_MAX (the warp
// walk's warp_min, intersect_warp.cu). An all-miss tile gives (FLT_MAX, 0).
__device__ __forceinline__ void warp_min(float& bt, int& br) {
    const unsigned key = __float_as_uint(bt);
    const unsigned k_min = __reduce_min_sync(FULL, key);
    br = static_cast<int>(__reduce_min_sync(FULL, key == k_min ? static_cast<unsigned>(br) : ~0u));
    bt = __uint_as_float(k_min);
}

__global__ void __launch_bounds__(WARPS_PER_BLOCK * WARP)
    closest_group_kernel(const float* __restrict__ o, const float* __restrict__ d,
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
    group_walk(tb, r, k, lane, [&] { return t_best; }, [&](int c, unsigned gate) {
        const float* rows = tb.prims + (size_t)c * tb.block * PRIM_COLS;
        float tile_t = FLT_MAX;  // on lane q: ray q's tile minimum
        int tile_row = 0;
        for (int base = 0; base < tb.block; base += CHUNK_ROWS) {
            float p[HELD][TRI_USED];
            load_held(rows, base, tb.block, lane, p);
            for (unsigned todo = gate; todo; todo &= todo - 1u) {
                const int q = __ffs(todo) - 1;
                const float frozen = __shfl_sync(FULL, t_best, q);  // at the cluster's start
                float bt = FLT_MAX;
                int br = 0;
                const Ray rq = rays[q];  // one broadcast read a cluster
                test_held_kz(p, base, lane, rq, frozen, k, bt, br);
                warp_min(bt, br);
                if (lane == q && bt < tile_t) {  // chunks ascend: an earlier row wins a tie
                    tile_t = bt;
                    tile_row = br;
                }
            }
        }
        if ((gate >> lane) & 1u) {
            const bool better =
                (tile_t < t_best) || ((tile_t == t_best) && (idx < 0) && (tile_t < FLT_MAX));
            if (better) {
                t_best = tile_t;
                idx = c * tb.block + tile_row;
            }
        }
        return false;
    });
    const int i = g * GROUP + lane;
    if (lane < GROUP && i < n) {
        t_out[i] = idx >= 0 ? t_best : FLT_MAX;
        row_out[i] = idx;
    }
}

__global__ void __launch_bounds__(WARPS_PER_BLOCK * WARP)
    any_group_kernel(const float* __restrict__ o, const float* __restrict__ d,
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
    bool hit = false;
    group_walk(tb, r, k, lane, [&] { return hit ? 0.0f : tm; }, [&](int c, unsigned gate) {
        const float* rows = tb.prims + (size_t)c * tb.block * PRIM_COLS;
        // no chunk once every gated ray has hit (80 registers and a 12-byte
        // spill; without this stop 90 registers, no spill, and 4% slower)
        for (int base = 0; base < tb.block && gate; base += CHUNK_ROWS) {
            float p[HELD][TRI_USED];
            load_held(rows, base, tb.block, lane, p);
            for (unsigned todo = gate; todo; todo &= todo - 1u) {
                const int q = __ffs(todo) - 1;
                float bt = FLT_MAX;
                int br = 0;
                const Ray rq = rays[q];
                test_held_kz(p, base, lane, rq, __shfl_sync(FULL, tm, q), k, bt, br);
                if (vote(bt < FLT_MAX)) {
                    if (lane == q) hit = true;
                    gate &= ~(1u << q);  // tested no more
                }
            }
        }
        return !vote(lane < GROUP && !hit && tm > 0.0f);  // no live ray left
    });
    const int i = g * GROUP + lane;
    if (lane < GROUP && i < n) hit_out[i] = hit;
}

int blocks_for(int n) {
    const int groups = (n + GROUP - 1) / GROUP;
    return (groups + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
}

template <class Kernel, class... Out>
int launch(Kernel kernel, const void* o, const void* d, const void* t_max, const Tables& tb,
           const Consts& k, int n, void* stream, Out*... out) {
    kernel<<<blocks_for(n), WARPS_PER_BLOCK * WARP, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(o), static_cast<const float*>(d),
        static_cast<const float*>(t_max), tb, k, n, out...);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace curry

// The C interface (CURRY_TABLE_ARGS, intersect.cuh). The walk always has the
// super level, so `use_supers` is not read; tables whose clusters_per_slab
// is not a multiple of SUPER_G are refused with cudaErrorInvalidValue.

#define CURRY_GROUP_GUARD \
    if (clusters_per_slab % curry::SUPER_G != 0) return static_cast<int>(cudaErrorInvalidValue)

extern "C" int curry_tri_closest_hit_groups(CURRY_TABLE_ARGS, void* t_out, void* row_out,
                                            void* stream) {
    CURRY_GROUP_GUARD;
    return curry::launch(curry::closest_group_kernel, o, d, t_max, CURRY_TABLES, n, stream,
                         static_cast<float*>(t_out), static_cast<int*>(row_out));
}

extern "C" int curry_tri_any_hit_groups(CURRY_TABLE_ARGS, void* hit_out, void* stream) {
    CURRY_GROUP_GUARD;
    return curry::launch(curry::any_group_kernel, o, d, t_max, CURRY_TABLES, n, stream,
                         static_cast<bool*>(hit_out));
}

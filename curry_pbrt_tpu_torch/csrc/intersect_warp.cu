// Warp-cooperative closest-hit and any-hit traversal over cluster tables,
// for Hopper (sm_90a): the 32 lanes of a warp walk one ray together, its
// lanes on the rows of each entered cluster. One walk, templated over the
// primitive (TriPrim / SpherePrim, intersect.cuh), serves triangles — K1,
// with its stats variant K1b, and K2 — and spheres (K3).
//
// Replaces the TPU kernels tri_closest_hit_tables / tri_any_hit_tables of
// curry_pbrt_tpu/ops/pallas/intersect_kernel.py (:709 and :760; kernel bodies
// _make_closest_kernel, with stats=True, and _make_any_kernel) and
// sphere_closest_hit_tables / sphere_any_hit_tables of
// curry_pbrt_tpu/ops/pallas/sphere_kernel.py (:216 and :256; the same bodies
// with tile_test=_sphere_tile_test), on the same tables, with the same rules
// (intersect.cuh): the slab → super → cluster walk in table order, each
// box gated by the widened slab test against the ray's bound at that moment
// (the dead-lane gate t_best > 0 included; NaN boxes of empty clusters are
// never entered); every row of an entered cluster tested against the best t
// frozen at the cluster's start; the tile's smallest t, lowest row on an
// exact tie, accepted on strict improvement or, for the first hit, at
// exactly t_max. So t is bit-equal to the plain version's, sign included,
// rows equal up to exact-t ties, stats equal.
//
// What bounds it on an H100: FP32 ALU work per entered tile (block rows of
// the 84-operation watertight triangle test or the 73-operation sphere test,
// built with -fmad=false, so no FMA) and the L2 traffic of the rows (every
// table of the bench scenes fits the 50 MB L2). The first port, a walk of
// one thread per ray (retired since), reached 37% of the card's f32 rate on coherent camera rays but 2.6-4.8% on
// incoherent bounce rays: one thread per ray, so a warp whose 32 rays enter
// different clusters runs the union of their clusters one after another,
// each lane reading its own 64-byte rows; and a warp with one live ray holds
// the card for its whole walk. This design:
//   - lanes on rows: in an entered cluster lane l tests rows l, l + 32, ...
//     (2 rows a lane at 64 rows a cluster, 4 at 128) against the frozen
//     bound, reading each row's used columns (10 of a triangle row, 14 of a
//     sphere row) as 16- and 8-byte loads, neighbouring lanes on
//     neighbouring rows; two __reduce_min_sync (and for spheres one shuffle)
//     then give the warp the tile's (t, row) (warp_min), and every lane
//     applies the acceptance rule to the same result. The warp runs one instruction
//     stream per ray, so there is no divergence, and the triangle test's
//     dominant axis is a compile-time constant (no selects);
//   - live rays only: each warp loads the t_max of 32 consecutive rays at
//     once, ballots t_max > 0 and walks the live rays one after another
//     (their ray set-up through __shfl_sync); a dead ray is written
//     (FLT_MAX, -1) / false without a walk;
//   - box tests across lanes, exactly: at each level the lanes test up to 32
//     boxes at once against the bound at that moment, a ballot gives the
//     candidates, and the walk visits them in table order. Each lane keeps
//     its box's entry distance (box_near, intersect.cuh), so the re-test of
//     a candidate against the current bound, whenever the bound has shrunk
//     since the batch, is one shuffle and one comparison. The box test is
//     monotone in the bound, so a box that fails the batch fails every later
//     test: the visits, the entered and improved counts and the result are
//     the serial walk's.
// The boxes are read from global memory (L1/L2): staged in shared memory they
// measured no faster on the card. The launch plan (ops/kernels/
// intersect_kernel.py) sends triangle tables of 8 rows a cluster (the
// Cornell scenes: coherent rays over a handful of clusters, where 24 of this
// walk's 32 lanes would idle) to the small-table walk of intersect_small.cu.
//
// Built by ops/kernels/build.py with nvcc -fmad=false (no fast math, IEEE
// division and square root); the plain PyTorch versions round identically.

#include <cuda_runtime.h>

#include "intersect.cuh"

namespace curry {
namespace {

constexpr int WARP = 32;
constexpr int THREADS = 512;   // 16 warps per block
constexpr int MIN_BLOCKS = 2;  // per SM: at most 64 registers a thread
constexpr unsigned FULL = 0xffffffffu;

// Calls visit(i) for every box i of [first, first + count) that the ray
// enters, in order, each against bound() at the moment it is reached — the
// serial walk's test — from batch tests of 32 boxes at a time. A visit that
// returns true ends the level (and returns true).
template <class Bound, class Visit>
__device__ __forceinline__ bool level(const float* boxes, int first, int count, const Ray& r,
                                      const Consts& k, int lane, Bound bound, Visit visit) {
    for (int base = 0; base < count; base += WARP) {
        const float b0 = bound();
        // this lane's box: its entry distance, NaN where it is never entered
        const float tn = base + lane < count
                             ? box_near(boxes + (size_t)(first + base + lane) * BOX_COLS, r,
                                        k.t_scale)
                             : __int_as_float(0x7fc00000);
        unsigned cand = __ballot_sync(FULL, tn < b0 && b0 > 0.0f);  // box_enter against b0
        while (cand) {
            const int l = __ffs(cand) - 1;
            cand &= cand - 1u;
            const float b = bound();  // the bound only shrinks: re-test when it has
            if (b != b0 && !(__shfl_sync(FULL, tn, l) < b)) continue;
            if (visit(first + base + l)) return true;
        }
    }
    return false;
}

// The slab → super → cluster walk of one ray by one warp: visit(c) for each
// cluster a serial walk of the ray (the plain version's _walk with the
// cluster's own box test) enters, in the same order. With one slab the slab box is not tested.
template <class Bound, class Visit>
__device__ __forceinline__ void walk(const Tables& tb, const Ray& r, const Consts& k, int lane,
                                     Bound bound, Visit visit) {
    const int cps = tb.clusters_per_slab;
    const int n_sup = cps / SUPER_G;
    auto slab = [&](int j) {
        if (tb.use_supers)
            return level(tb.saabb, j * n_sup, n_sup, r, k, lane, bound, [&](int s) {
                return level(tb.caabb, s * SUPER_G, SUPER_G, r, k, lane, bound, visit);
            });
        return level(tb.caabb, j * cps, cps, r, k, lane, bound, visit);
    };
    if (tb.n_slabs > 1)
        level(tb.slab, 0, tb.n_slabs, r, k, lane, bound, slab);
    else
        slab(0);
}

// This lane's rows lane, lane + 32, ... of one cluster against the bound:
// the smallest t and its row into (bt, br), rows ascending, so the lane's
// lowest row wins a tie (ANY: stop at the first hit). KZ is the ray's
// dominant axis where the test uses it (Prim::BY_AXIS), else -1.
template <class Prim, int KZ, bool ANY>
__device__ __forceinline__ void scan_rows(const float* rows, int block, int lane, const Ray& r,
                                          float bound, const Consts& k, float& bt, int& br) {
    for (int i = lane; i < block; i += WARP) {
        float p[Prim::COLS];
        Prim::load(rows + (size_t)i * PRIM_COLS, p);
        const float t = Prim::template test_kz<KZ>(p, r, bound, k);
        if (t < bt) {
            bt = t;
            br = i;
            if (ANY) return;
        }
    }
}

// scan_rows with the ray's dominant axis as a compile-time constant where
// the test uses it: r.kz is the same on every lane, so the branch does not
// diverge.
template <class Prim, bool ANY>
__device__ __forceinline__ void scan_tile(const float* rows, int block, int lane, const Ray& r,
                                          float bound, const Consts& k, float& bt, int& br) {
    if constexpr (Prim::BY_AXIS) {
        if (r.kz == 0)
            scan_rows<Prim, 0, ANY>(rows, block, lane, r, bound, k, bt, br);
        else if (r.kz == 1)
            scan_rows<Prim, 1, ANY>(rows, block, lane, r, bound, k, bt, br);
        else
            scan_rows<Prim, 2, ANY>(rows, block, lane, r, bound, k, bt, br);
    } else {
        scan_rows<Prim, -1, ANY>(rows, block, lane, r, bound, k, bt, br);
    }
}

// The tile's (t, row) over the warp, on every lane: the least t, then the
// lowest row among the lanes that hold it, keyed by t's bits, which order as
// the floats do on the t > 0 of a hit and the FLT_MAX of a miss. Where the
// test can return -0.0 (Prim::NEG_ZERO, spheres), whose raw bits would order
// above FLT_MAX's, the key is the bits with the sign cleared — monotone on
// t >= -0.0, and tying -0.0 with +0.0 as the plain version's comparisons
// do — and t, its sign included, comes from the winner's own lane
// (row % 32). An all-miss tile gives (FLT_MAX, 0): lanes without a hit keep
// row 0.
template <class Prim>
__device__ __forceinline__ void warp_min(float& bt, int& br) {
    const unsigned key = __float_as_uint(bt) & (Prim::NEG_ZERO ? 0x7fffffffu : ~0u);
    const unsigned k_min = __reduce_min_sync(FULL, key);
    br = static_cast<int>(
        __reduce_min_sync(FULL, key == k_min ? static_cast<unsigned>(br) : ~0u));
    if constexpr (Prim::NEG_ZERO)
        bt = __shfl_sync(FULL, bt, br % WARP);
    else
        bt = __uint_as_float(k_min);
}

// What a warp's walk of one ray gives, the same on every lane.
struct Result {
    float t;
    int row;
    int entered;
    int improved;
};

// The schedule both kernels share: each warp takes 32 consecutive rays,
// walks the live ones (t_max > 0) one after another with
// walk_ray(r, t_max, lane) → Result, and hands each result to its ray's
// lane; write(i, result) stores ray i's output (dead rays get dead).
template <class Prim, class WalkRay, class Write>
__device__ __forceinline__ void schedule(const float* __restrict__ o, const float* __restrict__ d,
                                         const float* __restrict__ t_max, int n,
                                         const Result& dead, WalkRay walk_ray, Write write) {
    const int lane = threadIdx.x % WARP;
    const int first = (blockIdx.x * (blockDim.x / WARP) + threadIdx.x / WARP) * WARP;
    if (first >= n) return;  // the whole warp
    const int i = first + lane;
    const float tm = i < n ? t_max[i] : 0.0f;
    const bool live = tm > 0.0f;
    Ray mine{};
    if (live) mine = make_ray(o + 3 * (size_t)i, d + 3 * (size_t)i);
    Result res = dead;
    for (unsigned todo = __ballot_sync(FULL, live); todo; todo &= todo - 1u) {
        const int src = __ffs(todo) - 1;
        const Result out = walk_ray(Prim::shfl(mine, src), __shfl_sync(FULL, tm, src), lane);
        if (lane == src) res = out;
    }
    if (i < n) write(i, res);
}

template <class Prim, bool STATS>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    closest_warp_kernel(const float* __restrict__ o, const float* __restrict__ d,
                        const float* __restrict__ t_max, Tables tb, Consts k, int n,
                        float* __restrict__ t_out, int* __restrict__ row_out,
                        int* __restrict__ entered_out, int* __restrict__ improved_out) {
    auto walk_ray = [&](const Ray& r, float tm, int lane) {
        float t_best = tm;
        int idx = -1, entered = 0, improved = 0;
        walk(tb, r, k, lane, [&] { return t_best; }, [&](int c) {
            if (STATS) ++entered;
            const float frozen = t_best;
            float bt = FLT_MAX;
            int br = 0;  // argmin of an all-miss tile is row 0, as in the TPU kernel
            scan_tile<Prim, false>(tb.prims + (size_t)c * tb.block * PRIM_COLS, tb.block, lane,
                                   r, frozen, k, bt, br);
            warp_min<Prim>(bt, br);
            if ((bt < frozen) || ((bt == frozen) && (idx < 0) && (bt < FLT_MAX))) {
                t_best = bt;
                idx = c * tb.block + br;
                if (STATS) ++improved;
            }
            return false;
        });
        return Result{idx >= 0 ? t_best : FLT_MAX, idx, entered, improved};
    };
    schedule<Prim>(o, d, t_max, n, Result{FLT_MAX, -1, 0, 0}, walk_ray,
                   [&](int i, const Result& res) {
                       t_out[i] = res.t;
                       row_out[i] = res.row;
                       if (STATS) {
                           entered_out[i] = res.entered;
                           improved_out[i] = res.improved;
                       }
                   });
}

template <class Prim>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    any_warp_kernel(const float* __restrict__ o, const float* __restrict__ d,
                    const float* __restrict__ t_max, Tables tb, Consts k, int n,
                    bool* __restrict__ hit_out) {
    // the bound stays t_max: every batch test is exact; row = 1 marks a hit
    auto walk_ray = [&](const Ray& r, float tm, int lane) {
        bool hit = false;
        walk(tb, r, k, lane, [&] { return tm; }, [&](int c) {
            float bt = FLT_MAX;
            int br = 0;
            scan_tile<Prim, true>(tb.prims + (size_t)c * tb.block * PRIM_COLS, tb.block, lane, r,
                                  tm, k, bt, br);
            hit = __ballot_sync(FULL, bt < FLT_MAX) != 0u;  // -0.0 is a hit
            return hit;
        });
        return Result{0.0f, hit ? 1 : 0, 0, 0};
    };
    schedule<Prim>(o, d, t_max, n, Result{0.0f, 0, 0, 0}, walk_ray,
                   [&](int i, const Result& res) { hit_out[i] = res.row != 0; });
}

int blocks_for(int n) { return (n + THREADS - 1) / THREADS; }

// Launches the closest-hit kernel over primitive type Prim; the stats
// instantiation when entered_out is not null. Returns cudaGetLastError().
template <class Prim, bool STATS>
int launch_closest(const void* o, const void* d, const void* t_max, const Tables& tb,
                   const Consts& k, int n, void* t_out, void* row_out, void* entered_out,
                   void* improved_out, void* stream) {
    closest_warp_kernel<Prim, STATS>
        <<<blocks_for(n), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float*>(o), static_cast<const float*>(d),
            static_cast<const float*>(t_max), tb, k, n, static_cast<float*>(t_out),
            static_cast<int*>(row_out), static_cast<int*>(entered_out),
            static_cast<int*>(improved_out));
    return static_cast<int>(cudaGetLastError());
}

template <class Prim>
int launch_any(const void* o, const void* d, const void* t_max, const Tables& tb,
               const Consts& k, int n, void* hit_out, void* stream) {
    any_warp_kernel<Prim><<<blocks_for(n), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(o), static_cast<const float*>(d),
        static_cast<const float*>(t_max), tb, k, n, static_cast<bool*>(hit_out));
    return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace curry

// The C interface (CURRY_TABLE_ARGS, intersect.cuh). n must be below
// 2^31 - 32.

// Closest hit over triangles; the stats instantiation (K1b) when
// entered_out and improved_out are not null.
extern "C" int curry_tri_closest_hit_warp(CURRY_TABLE_ARGS, void* t_out, void* row_out,
                                          void* entered_out, void* improved_out, void* stream) {
    using curry::TriPrim;
    if (entered_out != nullptr)
        return curry::launch_closest<TriPrim, true>(o, d, t_max, CURRY_TABLES, n, t_out, row_out,
                                                    entered_out, improved_out, stream);
    return curry::launch_closest<TriPrim, false>(o, d, t_max, CURRY_TABLES, n, t_out, row_out,
                                                 nullptr, nullptr, stream);
}

extern "C" int curry_tri_any_hit_warp(CURRY_TABLE_ARGS, void* hit_out, void* stream) {
    return curry::launch_any<curry::TriPrim>(o, d, t_max, CURRY_TABLES, n, hit_out, stream);
}

extern "C" int curry_sphere_closest_hit_warp(CURRY_TABLE_ARGS, void* t_out, void* row_out,
                                             void* stream) {
    return curry::launch_closest<curry::SpherePrim, false>(o, d, t_max, CURRY_TABLES, n, t_out,
                                                           row_out, nullptr, nullptr, stream);
}

extern "C" int curry_sphere_any_hit_warp(CURRY_TABLE_ARGS, void* hit_out, void* stream) {
    return curry::launch_any<curry::SpherePrim>(o, d, t_max, CURRY_TABLES, n, hit_out, stream);
}

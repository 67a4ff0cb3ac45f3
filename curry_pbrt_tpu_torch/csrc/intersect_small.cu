// Closest-hit (K1, with its stats variant K1b) and any-hit (K2) triangle
// traversal over small cluster tables, for Hopper (sm_90a): the small-scene
// plan's tables (ops/kernels/aggregate.py plan_tri_kernel: at most 512
// triangles in clusters of 8 rows, one slab, no supers — the Cornell
// scenes), staged in shared memory once per CTA, walked one thread per live
// ray, the live rays of a CTA binned by dominant axis so that a warp's rays
// share the triangle test's permutation.
//
// Replaces the TPU kernels tri_closest_hit_tables / tri_any_hit_tables of
// curry_pbrt_tpu/ops/pallas/intersect_kernel.py (:709 and :760; kernel bodies
// _make_closest_kernel, with stats=True, and _make_any_kernel) on those
// tables, with the same rules (intersect.cuh): the clusters in table order,
// each gated by the widened slab test against the ray's bound at that moment
// (the dead-lane gate included; NaN boxes of empty clusters are never entered);
// every row of an entered cluster tested against the best t frozen at the
// cluster's start; the tile's smallest t, lowest row on an exact tie,
// accepted on strict improvement or, for the first hit, at exactly t_max. So
// t is bit-equal to the plain version's, rows equal up to exact-t ties and
// (entered, improved) equal: each ray makes the plain version's tests in
// its order.
//
// What bounds it on an H100: FP32 ALU work per entered tile (8 rows of the
// 84-operation watertight test, built with -fmad=false, so no FMA). The
// first port, a walk of one thread per ray (retired since), reached 14% (K1) and 10% (K2) of its bound at the
// headline's 4,194,304-ray shape, held back by: the dominant axis as a run-
// time value per thread (9 three-way selects a row, NaN-checking maxima in
// the error bounds); warps whose rays enter different clusters running the
// union of them; dead rays paying the full ray set-up (6 divisions) before
// their t_max was read; and rows read with scalar loads. This design:
//   - the table in shared memory: each CTA stages the 10 used columns of
//     every row (as 48-byte rows) and every cluster box (32 bytes) once, and
//     reads them as broadcasts, 16 bytes at a time;
//   - a block-local partition: each CTA takes a run of THREADS x scan
//     consecutive rays (scan rays a thread, 1-4, so that a 4M-ray call
//     still has thousands of CTAs), reads t_max first, writes a dead ray's
//     outputs at once with no ray set-up, and stable-partitions the live
//     rays in shared memory by the dominant axis of |d| (BINS = 3 bins) by
//     ballot / popcount counts and one exclusive scan by warp 0. The CTA's
//     threads then walk the live rays in bin order, so each warp walks rays
//     that share the dominant axis, all but the warps that straddle a bin
//     boundary. Results go back to each ray's own index;
//   - the dominant axis at compile time: a warp whose rays share it walks
//     them through tri_test<KZ, true> (no selects, fmaxf in the error
//     bounds; bit-equal by intersect.cuh's argument); a warp that straddles
//     a bin boundary (or, where a CTA has few live rays, holds rays of
//     several bins) walks them through tri_test<-1, true>, the axis a
//     run-time value, rather than once per axis;
//   - one thread per ray over the cluster boxes, each box tested as the walk
//     reaches it in box_near's form (one NaN flag instead of twelve NaN
//     checks): box_near(box) < t_best is box_enter on a live ray, whose
//     t_best stays > 0.
// What each element is worth on the headline's calls: PERF.md, measured by
// tools/probe_small_walk.py.
// The launch plan (ops/kernels/intersect_kernel.py launch_plan) sends tables
// of at most 8 rows a cluster here; the wrapper refuses tables with more
// than one slab, with supers, or larger than MAX_TABLE_BYTES staged, and the
// entry points return cudaErrorInvalidValue for them.
//
// Built by ops/kernels/build.py with nvcc -fmad=false (no fast math, IEEE
// division and square root); the plain PyTorch versions round identically.

#include <cuda_runtime.h>

#include "intersect.cuh"

namespace curry {
namespace {

constexpr int WARP = 32;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / WARP;
constexpr int MAX_SCAN = 4;      // rays a thread reads in the partition
constexpr int MIN_CTAS = 1024;   // scan grows only while a call keeps this many CTAs
constexpr int BINS = 3;          // the dominant axis of |d|
constexpr int ROW = 12;          // floats of a staged row: p0, p1, p2, valid, 2 unused
constexpr int ROW_QUADS = ROW / 4;
constexpr int BOX = BOX_COLS;    // floats of a staged box: bmin, bmax, 2 unused
constexpr int BOX_QUADS = BOX / 4;
constexpr int MAX_BLOCK = 8;     // rows a cluster
constexpr int MAX_TABLE_BYTES = 40960;  // staged rows and boxes: with the order list and
                                       // the counts, within 48 KB
constexpr int COUNTS = BINS * MAX_SCAN * WARPS;
constexpr unsigned FULL = 0xffffffffu;

// One staged row's used columns, as two 16-byte and one 8-byte load.
__device__ __forceinline__ void load_row(const float* row, float* p) {
    const float4 a = reinterpret_cast<const float4*>(row)[0];
    const float4 b = reinterpret_cast<const float4*>(row)[1];
    const float2 c = reinterpret_cast<const float2*>(row)[4];
    p[0] = a.x, p[1] = a.y, p[2] = a.z, p[3] = a.w;
    p[4] = b.x, p[5] = b.y, p[6] = b.z, p[7] = b.w;
    p[8] = c.x, p[9] = c.y;
}

__device__ __forceinline__ void load_box(const float* box, float* b) {
    const float4 lo = reinterpret_cast<const float4*>(box)[0];
    const float4 hi = reinterpret_cast<const float4*>(box)[1];
    b[0] = lo.x, b[1] = lo.y, b[2] = lo.z, b[3] = lo.w;
    b[4] = hi.x, b[5] = hi.y, b[6] = hi.z, b[7] = hi.w;
}

// A live ray's bin: the dominant axis of |d| (make_ray's kz, the first
// maximum).
__device__ __forceinline__ int axis_bin(float dx, float dy, float dz) {
    const float ax = fabsf(dx), ay = fabsf(dy), az = fabsf(dz);
    return (ax >= ay && ax >= az) ? 0 : (ay >= az ? 1 : 2);
}

// What one ray's walk gives.
struct Hit {
    float t;
    int row;
    int entered;
    int improved;
};

// The closest-hit walk of one ray over the staged table, dominant axis KZ
// (-1: r.kz at run time).
template <int KZ, bool STATS>
__device__ __forceinline__ Hit closest_ray(const float* rows, const float* boxes, int n_clusters,
                                           int block, const Ray& r, float t_max, const Consts& k) {
    float t_best = t_max;
    int idx = -1, entered = 0, improved = 0;
    for (int c = 0; c < n_clusters; ++c) {
        float b[BOX];
        load_box(boxes + c * BOX, b);
        if (!(box_near(b, r, k.t_scale) < t_best)) continue;
        if (STATS) ++entered;
        const float frozen = t_best;
        const float* tile = rows + c * block * ROW;
        float t_min = FLT_MAX;
        int row = 0;  // argmin of an all-miss tile is row 0, as in the TPU kernel
        for (int i = 0; i < block; ++i) {
            float p[TriPrim::COLS];
            load_row(tile + i * ROW, p);
            const float t = tri_test<KZ, true>(p, r, frozen, k);
            if (t < t_min) {
                t_min = t;
                row = i;
            }
        }
        if ((t_min < frozen) || ((t_min == frozen) && (idx < 0) && (t_min < FLT_MAX))) {
            t_best = t_min;
            idx = c * block + row;
            if (STATS) ++improved;
        }
    }
    return Hit{idx >= 0 ? t_best : FLT_MAX, idx, entered, improved};
}

// The any-hit walk of one ray: true at the first row hit within t_max.
// KZ as for closest_ray.
template <int KZ>
__device__ __forceinline__ bool any_ray(const float* rows, const float* boxes, int n_clusters,
                                        int block, const Ray& r, float t_max, const Consts& k) {
    for (int c = 0; c < n_clusters; ++c) {
        float b[BOX];
        load_box(boxes + c * BOX, b);
        if (!(box_near(b, r, k.t_scale) < t_max)) continue;
        const float* tile = rows + c * block * ROW;
        for (int i = 0; i < block; ++i) {
            float p[TriPrim::COLS];
            load_row(tile + i * ROW, p);
            if (tri_test<KZ, true>(p, r, t_max, k) < FLT_MAX) return true;
        }
    }
    return false;
}

// The walks with the ray's dominant axis kz as a compile-time constant, or,
// for kz = -1, as r.kz at run time.
template <bool STATS>
__device__ __forceinline__ Hit closest_by_axis(int kz, const float* rows, const float* boxes,
                                               int n_clusters, int block, const Ray& r,
                                               float t_max, const Consts& k) {
    switch (kz) {
        case 0: return closest_ray<0, STATS>(rows, boxes, n_clusters, block, r, t_max, k);
        case 1: return closest_ray<1, STATS>(rows, boxes, n_clusters, block, r, t_max, k);
        case 2: return closest_ray<2, STATS>(rows, boxes, n_clusters, block, r, t_max, k);
        default: return closest_ray<-1, STATS>(rows, boxes, n_clusters, block, r, t_max, k);
    }
}

__device__ __forceinline__ bool any_by_axis(int kz, const float* rows, const float* boxes,
                                            int n_clusters, int block, const Ray& r, float t_max,
                                            const Consts& k) {
    switch (kz) {
        case 0: return any_ray<0>(rows, boxes, n_clusters, block, r, t_max, k);
        case 1: return any_ray<1>(rows, boxes, n_clusters, block, r, t_max, k);
        case 2: return any_ray<2>(rows, boxes, n_clusters, block, r, t_max, k);
        default: return any_ray<-1>(rows, boxes, n_clusters, block, r, t_max, k);
    }
}

struct Out {
    float* t;
    int* row;
    int* entered;
    int* improved;
    bool* hit;
};

// Exclusive prefix sum of s[0, len) in place, by the 32 lanes of one warp;
// the total goes to s[len].
__device__ __forceinline__ void exclusive_scan(int* s, int len, int lane) {
    const int per = (len + WARP - 1) / WARP;
    const int lo = lane * per;
    int local = 0;
    for (int j = 0; j < per; ++j)
        if (lo + j < len) local += s[lo + j];
    int incl = local;
    for (int off = 1; off < WARP; off <<= 1) {
        const int v = __shfl_up_sync(FULL, incl, off);
        if (lane >= off) incl += v;
    }
    int run = incl - local;
    for (int j = 0; j < per; ++j) {
        if (lo + j < len) {
            const int c = s[lo + j];
            s[lo + j] = run;
            run += c;
        }
    }
    if (lane == WARP - 1) s[len] = incl;
}

template <bool ANY, bool STATS>
__global__ void __launch_bounds__(THREADS)
    small_kernel(const float* __restrict__ o, const float* __restrict__ d,
                 const float* __restrict__ t_max, const float* __restrict__ prims,
                 const float* __restrict__ caabb, int n_clusters, int block, Consts k, int n,
                 int scan, Out out) {
    // dynamic: the rows (n_rows x ROW floats), the boxes (n_clusters x BOX),
    // then the order list (THREADS x scan ints)
    extern __shared__ float4 smem[];
    __shared__ int s_cnt[COUNTS + 1];
    const int n_rows = n_clusters * block;
    const float* rows = reinterpret_cast<const float*>(smem);
    const float* boxes = rows + n_rows * ROW;
    int* order = reinterpret_cast<int*>(smem + n_rows * ROW_QUADS + n_clusters * BOX_QUADS);
    const int tid = threadIdx.x, lane = tid % WARP, warp = tid / WARP;

    // stage the table: 3 of a row's 4 16-byte quarters, both of a box's
    const int row_quads = n_rows * ROW_QUADS;
    for (int e = tid; e < row_quads + n_clusters * BOX_QUADS; e += THREADS) {
        smem[e] = e < row_quads
                      ? __ldg(reinterpret_cast<const float4*>(prims) +
                              (size_t)(e / ROW_QUADS) * (PRIM_COLS / 4) + e % ROW_QUADS)
                      : __ldg(reinterpret_cast<const float4*>(caabb) + (e - row_quads));
    }

    // the partition: dead rays written now; each live ray's bin and its rank
    // among the live rays of its bin in its warp and round q
    const long long base = (long long)blockIdx.x * THREADS * scan;
    const unsigned below = (1u << lane) - 1u;
    int bin[MAX_SCAN], rank[MAX_SCAN];
#pragma unroll
    for (int q = 0; q < MAX_SCAN; ++q) {
        bin[q] = -1;
        rank[q] = 0;
        if (q >= scan) continue;  // the same on every thread
        const long long i = base + q * THREADS + tid;
        const float tm = i < n ? __ldg(t_max + i) : 0.0f;
        if (tm > 0.0f) {
            bin[q] = axis_bin(__ldg(d + 3 * i), __ldg(d + 3 * i + 1), __ldg(d + 3 * i + 2));
        } else if (i < n) {
            if (ANY) {
                out.hit[i] = false;
            } else {
                out.t[i] = FLT_MAX;
                out.row[i] = -1;
                if (STATS) out.entered[i] = out.improved[i] = 0;
            }
        }
#pragma unroll
        for (int b = 0; b < BINS; ++b) {
            const unsigned m = __ballot_sync(FULL, bin[q] == b);
            if (bin[q] == b) rank[q] = __popc(m & below);
            if (lane == 0) s_cnt[(b * scan + q) * WARPS + warp] = __popc(m);
        }
    }
    __syncthreads();
    // counts in (bin, q, warp) order → each group's first slot: the live
    // rays ordered by bin, then by ray index
    if (warp == 0) exclusive_scan(s_cnt, BINS * scan * WARPS, lane);
    __syncthreads();
#pragma unroll
    for (int q = 0; q < MAX_SCAN; ++q)
        if (bin[q] >= 0) order[s_cnt[(bin[q] * scan + q) * WARPS + warp] + rank[q]] = q * THREADS + tid;
    __syncthreads();

    const int n_live = s_cnt[BINS * scan * WARPS];
    for (int j = tid; j < n_live; j += THREADS) {
        const long long i = base + order[j];
        const Ray r = make_ray(o + 3 * i, d + 3 * i);
        const float tm = __ldg(t_max + i);
        // the axis at compile time where every lane of the warp shares it
        const unsigned active = __activemask();
        const int kz = __match_any_sync(active, r.kz) == active ? r.kz : -1;
        if (ANY) {
            out.hit[i] = any_by_axis(kz, rows, boxes, n_clusters, block, r, tm, k);
        } else {
            const Hit h = closest_by_axis<STATS>(kz, rows, boxes, n_clusters, block, r, tm, k);
            out.t[i] = h.t;
            out.row[i] = h.row;
            if (STATS) {
                out.entered[i] = h.entered;
                out.improved[i] = h.improved;
            }
        }
    }
}

// Launches the walk over the staged table; returns cudaGetLastError(), or
// cudaErrorInvalidValue for tables the walk does not take.
template <bool ANY, bool STATS>
int launch(const void* o, const void* d, const void* t_max, const Tables& tb, const Consts& k,
           int n, const Out& out, void* stream) {
    const int n_clusters = tb.clusters_per_slab;
    const long long table_bytes =
        (long long)n_clusters * (tb.block * ROW + BOX) * (long long)sizeof(float);
    if (tb.n_slabs != 1 || tb.use_supers || tb.block < 1 || tb.block > MAX_BLOCK ||
        table_bytes > MAX_TABLE_BYTES)
        return static_cast<int>(cudaErrorInvalidValue);
    const int fill = n / (THREADS * MIN_CTAS);
    const int scan = fill < 1 ? 1 : (fill > MAX_SCAN ? MAX_SCAN : fill);
    const long long per_cta = (long long)THREADS * scan;
    const int ctas = static_cast<int>((n + per_cta - 1) / per_cta);
    const size_t smem = table_bytes + per_cta * sizeof(int);
    small_kernel<ANY, STATS><<<ctas, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(o), static_cast<const float*>(d),
        static_cast<const float*>(t_max), tb.prims, tb.caabb, n_clusters, tb.block, k, n, scan,
        out);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace curry

// The C interface (CURRY_TABLE_ARGS, intersect.cuh), as intersect_warp.cu's
// entry points; saabb and slab are not read (one slab, no supers).

// Closest hit; the stats instantiation (K1b) when entered_out and
// improved_out are not null.
extern "C" int curry_tri_closest_hit_small(CURRY_TABLE_ARGS, void* t_out, void* row_out,
                                           void* entered_out, void* improved_out, void* stream) {
    const curry::Out out{static_cast<float*>(t_out), static_cast<int*>(row_out),
                         static_cast<int*>(entered_out), static_cast<int*>(improved_out),
                         nullptr};
    if (entered_out != nullptr)
        return curry::launch<false, true>(o, d, t_max, CURRY_TABLES, n, out, stream);
    return curry::launch<false, false>(o, d, t_max, CURRY_TABLES, n, out, stream);
}

extern "C" int curry_tri_any_hit_small(CURRY_TABLE_ARGS, void* hit_out, void* stream) {
    const curry::Out out{nullptr, nullptr, nullptr, nullptr, static_cast<bool*>(hit_out)};
    return curry::launch<true, false>(o, d, t_max, CURRY_TABLES, n, out, stream);
}

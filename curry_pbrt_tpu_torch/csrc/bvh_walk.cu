// Closest-hit and any-hit traversal of the flat threaded BVH, for Hopper
// (sm_90a): the live-ray walk, one thread per LIVE ray over the nodes' hit /
// miss links with no stack, each node one 32-byte row.
//
// Replaces the JAX package's bvh_traverse (curry_pbrt_tpu/ops/bvh.py:298), a
// jnp lax.while_loop over per-lane node pointers, not a Pallas kernel; its
// plain PyTorch version is ops/bvh.py's bvh_traverse, the same lockstep loop
// on the live rays. Same BVH (ops/bvh.py DeviceBVH), same rules, same
// results:
//   - a ray with t_max <= 0 (an integrator's dead lane) is not walked: it
//     reports t = t_max, ref -1, no hit;
//   - the slab test of the JAX package's _slab_test: 1/d with d == 0 → 1e-30,
//     near / far picked by the sign of d, the far distances widened by
//     (1 + 2γ₃), NaN-propagating max / min over the axes, and enter on
//     tn <= tf, tn < t_best and tf > 0;
//   - in an entered leaf, its <= LEAF_SIZE slots in order, each tested against
//     the running t_best and accepted on strict t < t_best; an any-hit ray
//     stops after the leaf of its first hit;
//   - the leaf tests are intersect.cuh's tri_test and sphere_test, which are
//     ops/intersect.py's watertight_core and sphere_quadratic (the ray taken
//     into the sphere's object space by the fixed-order sums of _mat3_vec)
//     operation for operation.
// A hit is accepted only where the test returned a t below FLT_MAX, the
// plain version's `ok`, so a ray whose t_max is above FLT_MAX gets no hit
// from a failed test.
//
// What bounds it on an H100: the dependent loads of the walk (each step
// reads its node before it knows the next one; the tables stay in L2), FP32
// work per node (a 25-operation slab test) and per leaf primitive test (84
// for a triangle, 73 for a sphere), and, at the render chunk, the bytes of
// the dead lanes (their t_max read, their outputs written). The first design
// (retired since; this one measured 1.8x faster at a mesh bounce, PERF.md)
// started one thread per lane over six node arrays: at a mesh bounce 2.7% of
// the lanes are live, so nearly every warp carried one live ray and held its
// SM for that ray's whole walk; each node step waited on six loads from six
// arrays; and small batches left SMs idle. This design:
//   - live rays only, with no host sync: a first pass over the lanes, four
//     a thread as 16-byte loads and stores, writes every lane's outputs as a
//     dead lane's and appends the live lanes' indices to a list (a ballot per
//     lane of the four and one atomicAdd on a device counter per warp, each
//     lane's slot the popcount of the live lanes below it); the walk then
//     runs one thread per live ray, on a grid sized to the card (its SMs
//     times the blocks that fit on one), each thread striding through the
//     list up to the count it reads from device memory, and overwrites the
//     live lanes' outputs. The order of the list varies from run to run; no
//     ray's result depends on it. The two passes are two launches of 128
//     threads a block (one cooperative launch with a grid-wide barrier
//     between them, and 64 or 256 threads, measured no faster);
//   - one 32-byte node row (DeviceBVH.nodes, ops/bvh.py pack_nodes): words
//     0-3 bmin xyz and the miss link, words 4-7 bmax xyz and first << 3 |
//     count. The builder's hit link is the next node for an internal node
//     and the miss link for a leaf piece (the packer checks it), so it is not
//     stored. A node step is two 16-byte read-only loads of one sector, and
//     the rows of both nodes a step can go to are loaded before its slab
//     test, so the next step's loads are in flight during this one.
//
// Built by ops/kernels/build.py with nvcc -fmad=false (no fast math, IEEE
// division and square root), so it rounds as the plain version does.

#include <cuda_runtime.h>

#include <atomic>

#include "intersect.cuh"

namespace {

using curry::Consts;
using curry::nan_max;
using curry::nan_min;
using curry::Ray;

constexpr int LEAF_SIZE = 4;
constexpr int ROW_COLS = 16;
constexpr int WARP = 32;
constexpr int COUNT_BITS = 3;  // first << COUNT_BITS | count in a node row's word 7
constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 128;      // a block, both passes
constexpr int MAX_DEVICES = 64;  // the live-ray walk's grid cached per device below this ordinal

// The primitive rows a leaf's slots index.
struct Prims {
    const int* refs;  // (K,) tri index, or n_tris + sphere index
    const float* tris16;
    const float* sph16;
    int n_tris;
};

__device__ __forceinline__ bool slab_enter(const float* mn, const float* mx, const Ray& r,
                                           float t_best, float t_scale) {
    const bool nx = r.dx < 0.0f, ny = r.dy < 0.0f, nz = r.dz < 0.0f;
    const float t0x = ((nx ? mx[0] : mn[0]) - r.ox) * r.ix;
    const float t0y = ((ny ? mx[1] : mn[1]) - r.oy) * r.iy;
    const float t0z = ((nz ? mx[2] : mn[2]) - r.oz) * r.iz;
    const float t1x = ((nx ? mn[0] : mx[0]) - r.ox) * r.ix * t_scale;
    const float t1y = ((ny ? mn[1] : mx[1]) - r.oy) * r.iy * t_scale;
    const float t1z = ((nz ? mn[2] : mx[2]) - r.oz) * r.iz * t_scale;
    const float tn = nan_max(t0x, nan_max(t0y, t0z));
    const float tf = nan_min(t1x, nan_min(t1y, t1z));
    return (tn <= tf) && (tn < t_best) && (tf > 0.0f);
}

// One primitive against the ray: its t, or FLT_MAX where there is no hit.
__device__ __forceinline__ float prim_test(const Prims& p, int ref, const Ray& r, float t_best,
                                           const Consts& k) {
    if (ref < p.n_tris) return curry::tri_test(p.tris16 + (size_t)ref * ROW_COLS, r, t_best, k);
    return curry::sphere_test(p.sph16 + (size_t)(ref - p.n_tris) * ROW_COLS, r, t_best, k);
}

// An entered leaf's slots, in order.
__device__ __forceinline__ void leaf(const Prims& p, int first, int count, const Ray& r,
                                     const Consts& k, float& t_best, int& ref_best) {
    for (int s = 0; s < LEAF_SIZE && s < count; ++s) {
        const int ref = __ldg(p.refs + first + s);
        const float t = prim_test(p, ref, r, t_best, k);
        if (t < t_best && t < FLT_MAX) {
            t_best = t;
            ref_best = ref;
        }
    }
}

// One node row: bmin xyz and the miss link's bits; bmax xyz and the bits of
// first << COUNT_BITS | count.
struct Row {
    float4 lo, hi;
};

__device__ __forceinline__ Row load_row(const float4* __restrict__ nodes, int ptr) {
    return Row{__ldg(nodes + 2 * (size_t)ptr), __ldg(nodes + 2 * (size_t)ptr + 1)};
}

// The walk of one live ray from the root over (M, 2) float4 node rows. Both
// rows the step can go to — the next node (an internal node's hit link) and
// the miss link — are loaded before the slab test, so their loads overlap
// the test and the leaf instead of following them.
template <bool ANY>
__device__ __forceinline__ void walk_rows(const float4* __restrict__ nodes, const Prims& p,
                                          const Ray& r, const Consts& k, float& t_best,
                                          int& ref_best) {
    int ptr = 0;
    Row c = load_row(nodes, 0);
    while (ptr >= 0) {
        const int packed = __float_as_int(c.hi.w);
        const int first = packed >> COUNT_BITS;  // -1 on an internal node
        const int miss = __float_as_int(c.lo.w);
        const Row down_row = load_row(nodes, first < 0 ? ptr + 1 : ptr);
        const Row miss_row = load_row(nodes, miss >= 0 ? miss : ptr);
        const float mn[3] = {c.lo.x, c.lo.y, c.lo.z}, mx[3] = {c.hi.x, c.hi.y, c.hi.z};
        const bool enter = slab_enter(mn, mx, r, t_best, k.t_scale);
        if (enter && first >= 0) leaf(p, first, packed & ((1 << COUNT_BITS) - 1), r, k, t_best,
                                      ref_best);
        // hit link: the next node of an internal node, the miss link of a leaf
        const bool down = enter && first < 0;
        ptr = down ? ptr + 1 : miss;
        c = down ? down_row : miss_row;
        if (ANY && ref_best >= 0) ptr = -1;
    }
}

// Pass 1 over lanes 4q .. 4q + 3 for q = start, start + stride, ... (stride
// a multiple of 32, so the lanes of a warp stay together): every lane's
// outputs written as if it were dead (t = t_max, ref -1, no hit; the walk
// overwrites the live ones), and each live lane's index appended to `live`
// — one ballot per lane of a quad, one atomicAdd per warp. t_out / ref_out
// or hit_out; all 16-byte aligned.
template <bool ANY>
__device__ __forceinline__ void compact(const float* __restrict__ t_max, int n,
                                        int* __restrict__ live, int* __restrict__ n_live,
                                        float* __restrict__ t_out, int* __restrict__ ref_out,
                                        bool* __restrict__ hit_out, long long start,
                                        long long stride) {
    const int lane = threadIdx.x & (WARP - 1);
    const long long quads = ((long long)n + 3) / 4;
    for (long long q = start; q - lane < quads; q += stride) {  // the same trip count on all lanes
        const long long i0 = 4 * q;
        float tm[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        if (i0 + 3 < n) {
            const float4 v = __ldg(reinterpret_cast<const float4*>(t_max) + q);
            tm[0] = v.x, tm[1] = v.y, tm[2] = v.z, tm[3] = v.w;
            if (ANY) {
                reinterpret_cast<char4*>(hit_out)[q] = make_char4(0, 0, 0, 0);
            } else {
                reinterpret_cast<float4*>(t_out)[q] = v;
                reinterpret_cast<int4*>(ref_out)[q] = make_int4(-1, -1, -1, -1);
            }
        } else {
            for (long long i = i0; i < n; ++i) {
                tm[i - i0] = t_max[i];
                if (ANY) {
                    hit_out[i] = false;
                } else {
                    t_out[i] = tm[i - i0];
                    ref_out[i] = -1;
                }
            }
        }
        unsigned mask[4];
        int total = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            mask[j] = __ballot_sync(FULL, tm[j] > 0.0f);  // NaN is dead, as in the plain version
            total += __popc(mask[j]);
        }
        if (total == 0) continue;
        int base = 0;
        if (lane == 0) base = atomicAdd(n_live, total);
        base = __shfl_sync(FULL, base, 0);
        const unsigned below = (1u << lane) - 1u;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            if (tm[j] > 0.0f) live[base + __popc(mask[j] & below)] = static_cast<int>(i0 + j);
            base += __popc(mask[j]);
        }
    }
}

// Pass 2: the live rays live[start], live[start + stride], ... below count.
template <bool ANY>
__device__ __forceinline__ void walk_live(const float* __restrict__ o,
                                          const float* __restrict__ d,
                                          const float* __restrict__ t_max,
                                          const float4* __restrict__ nodes, const Prims& p,
                                          const Consts& k, const int* live, int count,
                                          float* __restrict__ t_out, int* __restrict__ ref_out,
                                          bool* __restrict__ hit_out, long long start,
                                          long long stride) {
    for (long long j = start; j < count; j += stride) {
        const int i = __ldcg(live + j);  // written by the lane pass: not __ldg
        float t_best = t_max[i];
        int ref_best = -1;
        const Ray r = curry::make_ray(o + 3 * (size_t)i, d + 3 * (size_t)i);
        walk_rows<ANY>(nodes, p, r, k, t_best, ref_best);
        if (ANY) {
            hit_out[i] = ref_best >= 0;
        } else {
            t_out[i] = t_best;  // t_max where there is no hit, as the plain version
            ref_out[i] = ref_best;
        }
    }
}

struct LiveArgs {
    const float* o;
    const float* d;
    const float* t_max;
    const float4* nodes;
    Prims p;
    Consts k;
    int n;
    int* live;     // (n,) scratch
    int* n_live;   // (1,) zeroed by the caller
    float* t_out;  // closest: t_out, ref_out; any: hit_out
    int* ref_out;
    bool* hit_out;
};

__device__ __forceinline__ long long thread_index() {
    return (long long)blockIdx.x * blockDim.x + threadIdx.x;
}

__device__ __forceinline__ long long grid_threads() {
    return (long long)gridDim.x * blockDim.x;
}

template <bool ANY>
__global__ void compact_kernel(LiveArgs a) {
    compact<ANY>(a.t_max, a.n, a.live, a.n_live, a.t_out, a.ref_out, a.hit_out, thread_index(),
                 grid_threads());
}

template <bool ANY>
__global__ void walk_kernel(LiveArgs a) {
    walk_live<ANY>(a.o, a.d, a.t_max, a.nodes, a.p, a.k, a.live, __ldcg(a.n_live), a.t_out,
                   a.ref_out, a.hit_out, thread_index(), grid_threads());
}

// The lane pass, one thread a quad of lanes, then the walk on a grid of the
// SMs times the blocks that fit on one.
template <bool ANY>
int launch_live(LiveArgs a, cudaStream_t stream) {
    // SMs << 10 | blocks an SM, queried once per device
    static std::atomic<int> fits[MAX_DEVICES];
    int dev = 0, sms = 0, fit = 0;
    cudaError_t err = cudaGetDevice(&dev);
    std::atomic<int>* cached = dev < MAX_DEVICES ? &fits[dev] : nullptr;
    const int known = cached ? cached->load(std::memory_order_relaxed) : 0;
    if (known > 0) {
        sms = known >> 10;
        fit = known & 1023;
    } else {
        if (err == cudaSuccess)
            err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        if (err == cudaSuccess)
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, walk_kernel<ANY>, THREADS,
                                                                0);
        if (err != cudaSuccess) return static_cast<int>(err);
        if (fit < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
        if (cached) cached->store(sms << 10 | fit, std::memory_order_relaxed);
    }
    const int lane_blocks = static_cast<int>((((long long)a.n + 3) / 4 + THREADS - 1) / THREADS);
    compact_kernel<ANY><<<lane_blocks, THREADS, 0, stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    walk_kernel<ANY><<<sms * fit, THREADS, 0, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
}

Prims make_prims(const void* refs, const void* tris16, const void* sph16, int n_tris) {
    return Prims{static_cast<const int*>(refs), static_cast<const float*>(tris16),
                 static_cast<const float*>(sph16), n_tris};
}

}  // namespace

// Plain C interface for ctypes. Pointers are device pointers; the launches
// go on `stream` and do not synchronise. Each returns cudaGetLastError() (or
// the launch's own error). n must be below 2^31 - 32.

// The live-ray walk: nodes the (M, 8) rows, 32-byte aligned; t_max and the
// outputs 16-byte aligned; live an (n,) int32 scratch list and n_live one
// int32, zeroed, on the same stream.
#define CURRY_BVH_LIVE_ARGS                                                                      \
    const void *o, const void *d, const void *t_max, const void *nodes, const void *refs,        \
        const void *tris16, const void *sph16, int n, int n_tris, float g2, float g3, float g5, \
        float t_scale, void *live, void *n_live

static LiveArgs live_args(const void* o, const void* d, const void* t_max, const void* nodes,
                          const void* refs, const void* tris16, const void* sph16, int n,
                          int n_tris, float g2, float g3, float g5, float t_scale, void* live,
                          void* n_live) {
    return LiveArgs{static_cast<const float*>(o),
                    static_cast<const float*>(d),
                    static_cast<const float*>(t_max),
                    static_cast<const float4*>(nodes),
                    make_prims(refs, tris16, sph16, n_tris),
                    Consts{g2, g3, g5, t_scale},
                    n,
                    static_cast<int*>(live),
                    static_cast<int*>(n_live),
                    nullptr,
                    nullptr,
                    nullptr};
}

extern "C" int curry_bvh_closest_hit(CURRY_BVH_LIVE_ARGS, void* t_out, void* ref_out,
                                     void* stream) {
    LiveArgs a = live_args(o, d, t_max, nodes, refs, tris16, sph16, n, n_tris, g2, g3, g5,
                           t_scale, live, n_live);
    a.t_out = static_cast<float*>(t_out);
    a.ref_out = static_cast<int*>(ref_out);
    return launch_live<false>(a, static_cast<cudaStream_t>(stream));
}

extern "C" int curry_bvh_any_hit(CURRY_BVH_LIVE_ARGS, void* hit_out, void* stream) {
    LiveArgs a = live_args(o, d, t_max, nodes, refs, tris16, sph16, n, n_tris, g2, g3, g5,
                           t_scale, live, n_live);
    a.hit_out = static_cast<bool*>(hit_out);
    return launch_live<true>(a, static_cast<cudaStream_t>(stream));
}

// The texel gather's backward: a sorted segment sum, for Hopper (sm_90a).
//
// Replaces no TPU kernel. The JAX package's eval_texref gathers texture
// rows with jnp indexing and leaves the VJP, a scatter-add, to XLA. In the
// port the gather's backward was PyTorch's index_put_(accumulate=True): it
// sorts the ids, then hands each run of equal ids to one thread per channel,
// which adds the whole run in series. In an inverse-rendering step one
// texel (the one uv = (0, 0) maps to, which every dead or untextured lane
// reads) holds a quarter to a half of a bounce's 4,194,304 rows, so that one
// thread's walk, a chain of dependent loads, set the step's time.
//
// What it computes: given the ids stably sorted (`ids`, int32) with their
// permutation (`perm`, int64) and the gradient rows (`grad`, (n, 3) f32),
//
//     out[t, c] = Σ_{i : ids[i] = t} grad[perm[i], c]
//
// into `out` (n_texels, 3), which the caller zeroes (a texel no row names
// stays 0).
//
// What bounds it on an H100: bytes, about 24 a row (a 4-byte id, an 8-byte
// permutation entry, a 12-byte gradient row read through it); the adds are
// three a row. The design keeps each CTA's work fixed and the order of
// every sum fixed, whatever the duplication:
//   - a CTA takes a fixed tile of TILE sorted rows, ROWS consecutive rows a
//     thread; each thread loads its ids and gathers its gradient rows;
//   - a segment is a run of equal ids. Each thread sums its rows in order
//     into the segment open at its first row and those that start in it;
//     a segmented scan over the threads (shuffles within a warp, then the
//     warps' totals through shared memory, in warp order) gives each
//     thread the sum of the rows before it in its first row's segment;
//   - the thread that holds a segment's last row of the tile writes it. A
//     segment inside the tile goes straight to its texel, which no other
//     CTA writes. The segment that holds the tile's first row and the one
//     that holds its last go to the tile's two carry rows (id, sum) instead
//     (a tile of one segment writes it to the first and a zero to the
//     second);
//   - the carries, 2 a tile, are again sorted by id, and the same kernel
//     sums them, tile by tile, until one tile is left, whose segments all
//     go to their texels: 4,194,304 rows take three launches (2,048 tiles,
//     then 2, then 1).
// No thread walks more than its ROWS rows and no float atomics are used,
// so a texel's sum has one order, and the result is bit-equal from run to
// run. It differs from a serial sum in that order alone (float32 throughout).

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS = 8;                 // sorted rows a thread
constexpr int TILE = THREADS * ROWS;    // sorted rows a CTA
constexpr unsigned FULL = 0xffffffffu;

// An element of the segmented scan over a run of rows: whether a segment
// starts inside it, and the sum of its rows from the last such start (from
// its first row where none does).
struct Part {
    int start;
    float x, y, z;
};

// a, then b: b's sum where a segment starts in b, else a's sum plus b's.
__device__ __forceinline__ Part combine(const Part& a, const Part& b) {
    if (b.start) return b;
    return Part{a.start, a.x + b.x, a.y + b.y, a.z + b.z};
}

__device__ __forceinline__ Part shfl_up(const Part& p, int off) {
    return Part{__shfl_up_sync(FULL, p.start, off), __shfl_up_sync(FULL, p.x, off),
                __shfl_up_sync(FULL, p.y, off), __shfl_up_sync(FULL, p.z, off)};
}

// One tile of the sorted rows [0, n): GATHER reads row i's values at
// vals[3 perm[i]], else at vals[3 i] (the carries of the level below). With
// more than one CTA, each CTA writes its two carries at carry_ids[2 b],
// carry_vals[3 (2 b)] and the next row.
template <bool GATHER>
__global__ void __launch_bounds__(THREADS)
    texel_grad_kernel(const int* __restrict__ ids, const long long* __restrict__ perm,
                      const float* __restrict__ vals, int n, int n_texels,
                      float* __restrict__ out, int* __restrict__ carry_ids,
                      float* __restrict__ carry_vals) {
    __shared__ Part warp_total[WARPS];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int base = blockIdx.x * TILE;
    const int end = min(base + TILE, n);
    const int r0 = base + threadIdx.x * ROWS;

    // this thread's rows: ids, values, and whether a segment starts at each
    // (st[j] for row r0 + j; the tile's first row starts none, so that the
    // scan runs back to it; st[ROWS] is the next thread's first row)
    int id[ROWS];
    float vx[ROWS], vy[ROWS], vz[ROWS];
    bool st[ROWS + 1];
    int prev = (r0 > base && r0 < end) ? __ldg(ids + r0 - 1) : 0;
    Part own{0, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
        const int r = r0 + j;
        id[j] = 0;
        vx[j] = vy[j] = vz[j] = 0.0f;
        st[j] = false;
        if (r < end) {
            id[j] = __ldg(ids + r);
            const long long src = GATHER ? __ldg(perm + r) : (long long)r;
            vx[j] = __ldg(vals + 3 * src);
            vy[j] = __ldg(vals + 3 * src + 1);
            vz[j] = __ldg(vals + 3 * src + 2);
            st[j] = r > base && id[j] != prev;
            prev = id[j];
            if (st[j]) own = Part{1, 0.0f, 0.0f, 0.0f};
            own.x += vx[j];
            own.y += vy[j];
            own.z += vz[j];
        }
    }
    st[ROWS] = r0 + ROWS < end && __ldg(ids + r0 + ROWS) != prev;

    // exclusive segmented scan of the threads' parts, in thread order
    Part inc = own;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        const Part p = shfl_up(inc, off);
        if (lane >= off) inc = combine(p, inc);
    }
    if (lane == 31) warp_total[warp] = inc;
    Part exc = shfl_up(inc, 1);
    if (lane == 0) exc = Part{0, 0.0f, 0.0f, 0.0f};
    __syncthreads();
    Part before{0, 0.0f, 0.0f, 0.0f};  // the warps before this one, in order
    for (int w = 0; w < warp; ++w) before = combine(before, warp_total[w]);
    const Part in = combine(before, exc);

    // walk the rows: the thread that holds a segment's last row writes it
    float ax = in.x, ay = in.y, az = in.z;
    bool first = !in.start;  // the open segment holds the tile's first row
    const bool one_tile = gridDim.x == 1;
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
        const int r = r0 + j;
        if (r >= end) break;
        if (st[j]) {
            ax = ay = az = 0.0f;
            first = false;
        }
        ax += vx[j];
        ay += vy[j];
        az += vz[j];
        const bool last = r == end - 1;
        if (!last && !st[j + 1]) continue;
        if (one_tile || (!first && !last)) {
            if (id[j] >= 0 && id[j] < n_texels) {
                out[3 * (long long)id[j]] = ax;
                out[3 * (long long)id[j] + 1] = ay;
                out[3 * (long long)id[j] + 2] = az;
            }
            continue;
        }
        const int c = 2 * blockIdx.x + (first ? 0 : 1);
        carry_ids[c] = id[j];
        carry_vals[3 * c] = ax;
        carry_vals[3 * c + 1] = ay;
        carry_vals[3 * c + 2] = az;
        if (first && last) {  // one segment: its sum is the first carry
            carry_ids[c + 1] = id[j];
            carry_vals[3 * c + 3] = 0.0f;
            carry_vals[3 * c + 4] = 0.0f;
            carry_vals[3 * c + 5] = 0.0f;
        }
    }
}

int tiles_of(int n) { return (n + TILE - 1) / TILE; }

}  // namespace

// Carry rows the sums of n sorted rows need: 2 a tile at every level but
// the last; the wrapper sizes its scratch by it.
extern "C" int curry_texel_grad_carry_rows(int n) {
    int rows = 0;
    for (int tiles = tiles_of(n); tiles > 1; tiles = tiles_of(2 * tiles)) rows += 2 * tiles;
    return rows;
}

// Plain C interface for ctypes: device pointers; the launches go on
// `stream` and do not synchronise. ids (n,) int32 sorted, perm (n,) int64,
// grad (n, 3) f32 contiguous, out (n_texels, 3) f32 zeroed; carry_ids
// (carry_rows,) int32 and carry_vals (carry_rows, 3) f32 scratch, at least
// curry_texel_grad_carry_rows(n) rows, or cudaErrorInvalidValue. Returns
// the first launch error, else cudaGetLastError().
extern "C" int curry_texel_grad(const void* ids, const void* perm, const void* grad, int n,
                                int n_texels, void* out, void* carry_ids, void* carry_vals,
                                int carry_rows, void* stream) {
    if (n < 0 || n_texels < 0 || carry_rows < curry_texel_grad_carry_rows(n))
        return static_cast<int>(cudaErrorInvalidValue);
    if (n == 0) return static_cast<int>(cudaSuccess);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    int* cids = static_cast<int*>(carry_ids);
    float* cvals = static_cast<float*>(carry_vals);
    float* o = static_cast<float*>(out);
    int tiles = tiles_of(n);
    texel_grad_kernel<true><<<tiles, THREADS, 0, s>>>(
        static_cast<const int*>(ids), static_cast<const long long*>(perm),
        static_cast<const float*>(grad), n, n_texels, o, cids, cvals);
    cudaError_t err = cudaGetLastError();
    for (int at = 0; tiles > 1 && err == cudaSuccess;) {
        const int rows = 2 * tiles;  // the carries of the level just launched, at `at`
        tiles = tiles_of(rows);
        texel_grad_kernel<false><<<tiles, THREADS, 0, s>>>(
            cids + at, nullptr, cvals + 3 * (long long)at, rows, n_texels, o, cids + at + rows,
            cvals + 3 * (long long)(at + rows));
        err = cudaGetLastError();
        at += rows;
    }
    return static_cast<int>(err);
}

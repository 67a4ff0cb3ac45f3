// The slab-grid probe (P), for Hopper (sm_90a).
//
// Replaces the TPU kernel of tools/probe_slab_grid.py (`kernel`, launched
// by `run`): over a (ray blocks × slabs) grid it computes, for every ray i
// of the (4, block_rays · n_blocks) ray array,
//
//     out[i] = Σ_j ( tab[8 j, 0] · Σ slabs[j · slab_rows : (j + 1) · slab_rows, :] + rays[0, i] )
//
// with tab (8 · n_slabs, 4) and slabs (slab_rows · n_slabs, 8). On the TPU it
// probed the structure of the streamed intersector: a per-slab scalar table
// in SMEM, a slab block streamed on the inner grid axis, and an output block
// revisited across that axis as an accumulator. On Hopper blocks run in
// parallel and nothing carries across them, so the inner axis becomes a loop
// over slabs inside each thread, in slab order, in registers.
//
// What bounds it on an H100: bytes — one read of row 0 of the rays and one
// write of the output per ray, against two adds per (ray, slab). The design
// (`slab_grid_kernel`):
//   - the slab sums are a prologue of each CTA, one warp per slab: lane l
//     adds the slab's values l, l + 32, ... in order, then a fixed butterfly
//     (xor 16, 8, 4, 2, 1) adds the lanes, so every CTA gets the same bits;
//     the scaled sums go to shared memory;
//   - one grid sized to the card (the SMs × the CTAs that fit on one), each
//     thread striding over quads of rays: a 16-byte streaming load of row 0,
//     four sums over the slabs in registers, a 16-byte streaming store.
// The plain version (tools/probe_slab_grid.slab_grid_plain) adds in the same
// order, so the two are bit-equal under -fmad=false.
//
// The first port, `slab_grid_baseline_kernel`, is kept as the A/B
// baseline: one CTA per block of block_rays rays, each re-summing every slab
// serially in n_slabs threads before a barrier, 4-byte loads and stores.

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_DEVICES = 64;
constexpr int MAX_SHARED = 48 * 1024;

// Σ of the len floats at sl, by one warp in the fixed order above (every
// lane returns the same value).
__device__ __forceinline__ float warp_slab_sum(const float* __restrict__ sl, int len, int lane) {
    float acc = 0.0f;
    for (int e = lane; e < len; e += 32) acc += __ldg(sl + e);
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    return acc;
}

__global__ void __launch_bounds__(THREADS)
    slab_grid_kernel(const float* __restrict__ tab, const float* __restrict__ rays,
                     const float* __restrict__ slabs, int n_slabs, int slab_rows, int n,
                     float* __restrict__ out) {
    extern __shared__ float scaled[];  // (n_slabs,): tab[8 j, 0] · Σ slab j
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int len = slab_rows * 8;
    for (int j = warp; j < n_slabs; j += THREADS / 32) {
        const float s = warp_slab_sum(slabs + (size_t)j * len, len, lane);
        if (lane == 0) scaled[j] = __ldg(tab + (size_t)j * 8 * 4) * s;
    }
    __syncthreads();
    const size_t stride = (size_t)gridDim.x * THREADS;
    const float4* r4 = reinterpret_cast<const float4*>(rays);
    float4* o4 = reinterpret_cast<float4*>(out);
    for (size_t q = (size_t)blockIdx.x * THREADS + threadIdx.x; q < (size_t)n / 4; q += stride) {
        const float4 r = __ldcs(r4 + q);
        float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        for (int j = 0; j < n_slabs; ++j) {
            const float s = scaled[j];
            acc.x += s + r.x;
            acc.y += s + r.y;
            acc.z += s + r.z;
            acc.w += s + r.w;
        }
        __stcs(o4 + q, acc);
    }
}

__global__ void slab_grid_baseline_kernel(const float* __restrict__ tab,
                                          const float* __restrict__ rays,
                                          const float* __restrict__ slabs, int n_slabs,
                                          int slab_rows, int n, float* __restrict__ out) {
    extern __shared__ float scaled_sum[];  // (n_slabs,): tab[8 j, 0] · Σ slab j
    for (int j = threadIdx.x; j < n_slabs; j += blockDim.x) {
        const float* sl = slabs + (size_t)j * slab_rows * 8;
        float acc = 0.0f;
        for (int e = 0; e < slab_rows * 8; ++e) acc += sl[e];
        scaled_sum[j] = tab[(size_t)j * 8 * 4] * acc;
    }
    __syncthreads();
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const float ray = rays[i];
    float acc = 0.0f;
    for (int j = 0; j < n_slabs; ++j) acc += scaled_sum[j] + ray;
    out[i] = acc;
}

// SMs × the CTAs of slab_grid_kernel that fit on one SM, cached per device
// (the launch goes on the current device).
cudaError_t card_blocks(int* blocks) {
    static std::atomic<int> fits[MAX_DEVICES];
    int dev = 0, sms = 0, fit = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    std::atomic<int>* cached = dev < MAX_DEVICES ? &fits[dev] : nullptr;
    const int known = cached ? cached->load(std::memory_order_relaxed) : 0;
    if (known > 0) {
        *blocks = known;
        return cudaSuccess;
    }
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, slab_grid_kernel, THREADS, 0);
    if (err != cudaSuccess) return err;
    if (fit < 1) return cudaErrorInvalidConfiguration;
    *blocks = sms * fit;
    if (cached) cached->store(*blocks, std::memory_order_relaxed);
    return cudaSuccess;
}

bool bad_shape(int n_slabs, int slab_rows, int block_rays, int n) {
    return block_rays <= 0 || block_rays > 1024 || n < 0 || n % block_rays != 0 || n_slabs < 0 ||
           slab_rows <= 0 || (size_t)n_slabs * sizeof(float) > (size_t)MAX_SHARED;
}

}  // namespace

// Plain C interface for ctypes: device pointers; the launch goes on `stream`
// and does not synchronise. `rays` is the (4, n) array, of which row 0 is
// read; n = block_rays · n_blocks (block_rays is the TPU grid's block, kept
// as the shape contract). The kernel moves rays in quads: n a multiple of 4
// and `rays` and `out` 16-byte aligned, or cudaErrorInvalidValue. Returns
// cudaGetLastError().
extern "C" int curry_slab_grid(const void* tab, const void* rays, const void* slabs, int n_slabs,
                               int slab_rows, int block_rays, int n, void* out, void* stream) {
    if (bad_shape(n_slabs, slab_rows, block_rays, n) || n % 4 != 0 ||
        ((reinterpret_cast<std::uintptr_t>(rays) | reinterpret_cast<std::uintptr_t>(out)) % 16))
        return static_cast<int>(cudaErrorInvalidValue);
    if (n == 0) return static_cast<int>(cudaSuccess);
    int blocks = 0;
    cudaError_t err = card_blocks(&blocks);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long need = ((long long)n / 4 + THREADS - 1) / THREADS;
    if (need < blocks) blocks = static_cast<int>(need);
    slab_grid_kernel<<<blocks, THREADS, (size_t)n_slabs * sizeof(float),
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(tab), static_cast<const float*>(rays),
        static_cast<const float*>(slabs), n_slabs, slab_rows, n, static_cast<float*>(out));
    return static_cast<int>(cudaGetLastError());
}

// The baseline (the first port), the same interface: one CTA per block_rays rays.
extern "C" int curry_slab_grid_baseline(const void* tab, const void* rays, const void* slabs,
                                        int n_slabs, int slab_rows, int block_rays, int n,
                                        void* out, void* stream) {
    if (bad_shape(n_slabs, slab_rows, block_rays, n)) return static_cast<int>(cudaErrorInvalidValue);
    if (n == 0) return static_cast<int>(cudaSuccess);
    slab_grid_baseline_kernel<<<n / block_rays, block_rays, n_slabs * sizeof(float),
                                static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(tab), static_cast<const float*>(rays),
        static_cast<const float*>(slabs), n_slabs, slab_rows, n, static_cast<float*>(out));
    return static_cast<int>(cudaGetLastError());
}

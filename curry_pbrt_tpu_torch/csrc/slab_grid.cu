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
// parallel and nothing carries across them, so the inner axis becomes a
// loop: one CTA per block of block_rays rays reduces each slab's values
// once into shared memory, and each thread accumulates its ray over the
// slabs, in slab order, in a register and writes once.
//
// What bounds it on an H100: bytes — one read of row 0 of the rays and one
// write of the output per ray, against two adds per (ray, slab).

#include <cuda_runtime.h>

namespace {

__global__ void slab_grid_kernel(const float* __restrict__ tab, const float* __restrict__ rays,
                                 const float* __restrict__ slabs, int n_slabs, int slab_rows,
                                 int n, float* __restrict__ out) {
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

}  // namespace

// Plain C interface for ctypes: device pointers; the launch goes on `stream`
// and does not synchronise. `rays` is the (4, n) array, of which row 0 is
// read; n = block_rays · n_blocks. Returns cudaGetLastError().
extern "C" int curry_slab_grid(const void* tab, const void* rays, const void* slabs, int n_slabs,
                               int slab_rows, int block_rays, int n, void* out, void* stream) {
    if (block_rays <= 0 || block_rays > 1024 || n % block_rays != 0)
        return static_cast<int>(cudaErrorInvalidValue);
    slab_grid_kernel<<<n / block_rays, block_rays, n_slabs * sizeof(float),
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(tab), static_cast<const float*>(rays),
        static_cast<const float*>(slabs), n_slabs, slab_rows, n, static_cast<float*>(out));
    return static_cast<int>(cudaGetLastError());
}

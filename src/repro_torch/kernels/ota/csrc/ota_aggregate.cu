// OTA-MAC edge aggregation (paper Eq. 8) for NVIDIA Hopper (sm_90a).
//
//   out[b, j] = (sum_n h[b, n] * g[b, n, j]) / n_true + w[b, j]
//
// Replaces the Pallas TPU kernel src/repro/kernels/ota/kernel.py::_ota_kernel
// (pallas_call in ota_edge_aggregate_kernel). The wrapper
// (repro_torch/kernels/ota/ops.py) folds the edge-noise scale into `w` and
// passes the TRUE node count; one launch covers every trajectory b of a
// Monte Carlo step, the counterpart of the TPU kernel under exec's vmap.
//
// Bound: memory. Each gradient element is read once and used for 2 flops,
// so the least time is bytes / 3.35 TB/s with
//   bytes = B*N*d*sizeof(g) + 4*B*N (gains) + 4*B*d (noise) + B*d*sizeof(out).
// At the engine's LARGE shape (B=1024, N=4096, d=24, f32) that is ~0.125 ms
// per launch; at the paper's operating point (B=4, N=500, d=90) ~0.2 us,
// i.e. launch-bound.
//
// Design (simple and exact first):
//   * one thread block per (trajectory b, tile of 32 columns); 256 threads
//     arranged as 32 columns x 8 node groups, so a warp reads 32
//     neighbouring columns of one node row;
//   * each thread sums its node subset n = grp, grp+8, ... in a fixed order
//     in a register (f32, bf16 inputs converted with __bfloat162float);
//   * a fixed-order tree over the 8 groups in shared memory combines them:
//     no atomics, so results are identical from run to run;
//   * the kernel masks ragged N and d itself (the wrapper does not pad, where
//     the TPU wrapper padded to (8, 128) tiles).
// Later work: split N across blocks when B * ceil(d/32) underfills the 132
// SMs, 16-byte loads, and fusing the gradient computation into the reduction.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kCols = 32;   // columns per block: one warp wide
constexpr int kGroups = 8;  // node groups per block (power of two)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename GT, typename OT>
__global__ void __launch_bounds__(kCols * kGroups)
    ota_aggregate_kernel(const GT* __restrict__ g, const float* __restrict__ h,
                         const float* __restrict__ w, OT* __restrict__ out,
                         int n_nodes, int dim, int col_tiles, float n_true) {
  __shared__ float partial[kGroups][kCols + 1];
  const int b = blockIdx.x / col_tiles;
  const int col = (blockIdx.x % col_tiles) * kCols + threadIdx.x;
  const int grp = threadIdx.y;
  const GT* gb = g + static_cast<size_t>(b) * n_nodes * dim;
  const float* hb = h + static_cast<size_t>(b) * n_nodes;

  float acc = 0.0f;
  if (col < dim) {
    for (int n = grp; n < n_nodes; n += kGroups) {
      acc = fmaf(hb[n], to_f32(gb[static_cast<size_t>(n) * dim + col]), acc);
    }
  }
  partial[grp][threadIdx.x] = acc;
  __syncthreads();
#pragma unroll
  for (int stride = kGroups / 2; stride > 0; stride >>= 1) {
    if (grp < stride) {
      partial[grp][threadIdx.x] += partial[grp + stride][threadIdx.x];
    }
    __syncthreads();
  }
  if (grp == 0 && col < dim) {
    const size_t o = static_cast<size_t>(b) * dim + col;
    store(out + o, partial[0][threadIdx.x] / n_true + w[o]);
  }
}

template <typename GT, typename OT>
void launch(const void* g, const void* h, const void* w, void* out, int batch,
            int n_nodes, int dim, int n_true, cudaStream_t stream) {
  const int col_tiles = (dim + kCols - 1) / kCols;
  const dim3 block(kCols, kGroups);
  const dim3 grid(static_cast<unsigned>(batch) * col_tiles);
  ota_aggregate_kernel<GT, OT><<<grid, block, 0, stream>>>(
      static_cast<const GT*>(g), static_cast<const float*>(h),
      static_cast<const float*>(w), static_cast<OT*>(out), n_nodes, dim,
      col_tiles, static_cast<float>(n_true));
}

}  // namespace

// g: (batch, n_nodes, dim) f32 (g_bf16 = 0) or bf16 (g_bf16 = 1);
// h: (batch, n_nodes) f32; w: (batch, dim) f32, already scaled;
// out: (batch, dim) f32 (out_bf16 = 0) or bf16. All contiguous, on the
// current device. Returns cudaGetLastError() after the launch.
extern "C" int ota_aggregate(const void* g, const void* h, const void* w,
                             void* out, int batch, int n_nodes, int dim,
                             int n_true, int g_bf16, int out_bf16,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (g_bf16) {
    if (out_bf16) {
      launch<__nv_bfloat16, __nv_bfloat16>(g, h, w, out, batch, n_nodes, dim,
                                           n_true, s);
    } else {
      launch<__nv_bfloat16, float>(g, h, w, out, batch, n_nodes, dim, n_true,
                                   s);
    }
  } else {
    if (out_bf16) {
      launch<float, __nv_bfloat16>(g, h, w, out, batch, n_nodes, dim, n_true,
                                   s);
    } else {
      launch<float, float>(g, h, w, out, batch, n_nodes, dim, n_true, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ota_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

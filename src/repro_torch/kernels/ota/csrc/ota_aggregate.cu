// OTA-MAC edge aggregation (paper Eq. 8) for NVIDIA Hopper (sm_90a).
//
//   out[b, m, j] = (sum_n h[b, m, n] * g[b, n, j]) / n_true[b] + w[b, m, j]
//
// Replaces the Pallas TPU kernel src/repro/kernels/ota/kernel.py::_ota_kernel
// (pallas_call in ota_edge_aggregate_kernel). The wrapper
// (repro_torch/kernels/ota/ops.py) folds the edge-noise scale into `w` and
// passes each trajectory's TRUE node count as a (B,) f32 device tensor, or
// none, meaning the node-axis length for every trajectory. A node-count
// sweep pads its rows to one N with zero gains and zero gradients, so the
// padded sum is exact and the 1/N is the row's own. One launch covers every
// trajectory b of a Monte Carlo step and every receive antenna m of it
// (M = 1 for a single-antenna edge), the counterpart of the TPU kernel under
// exec's vmaps over trajectories and antennas (where the TPU kernel divides
// by one static N).
//
// Bound: memory. Each gradient element is read once (whatever M: the M
// antennas of a trajectory read one copy of g[b]) and used for 2M flops, so
// the least time is bytes / 3.35 TB/s with
//   bytes = B*N*d*sizeof(g) + 4*B*M*N (gains) + 4*B*M*d (noise)
//           + B*M*d*sizeof(out) + 4*B (counts, when given).
// At the engine's LARGE shape (B=1024, N=4096, d=24, M=1, f32) that is
// ~0.125 ms per launch; with M=16 antennas ~0.201 ms; at the paper's
// operating point (B=4, N=500, d=90) ~0.2 us, i.e. launch-bound.
//
// Design (simple and exact first):
//   * one thread block per ((trajectory b, antenna m), tile of 32 columns);
//     256 threads arranged as 32 columns x 8 node groups, so a warp reads
//     32 neighbouring columns of one node row. The (b, m) pairs run along
//     grid x with the antennas of one trajectory adjacent, so the M blocks
//     reading g[b] run together and all but the first read it from L2: g
//     is read from HBM about once, never copied M-fold. M = 1 is the
//     single-antenna edge: the bits of the kernel before the antenna axis
//     and its time or less, 0.1528 ms at LARGE against 0.1536 (with counts
//     0.1539 against 0.1597) on an H100, 700 W (tools/ota_antennas_ab.py). At
//     (1024, 16, 4096, 24) it takes 0.988 ms, 20 % of the 0.2013 ms bound
//     and 3.1x the einsum's 0.319 ms: each block streams g[b] from L2;
//   * each thread sums its node subset n = grp, grp+8, ... in a fixed order
//     in a register (f32, bf16 inputs converted with __bfloat162float);
//   * a fixed-order tree over the 8 groups in shared memory combines them:
//     no atomics, so results are identical from run to run, and one
//     antenna's result has the bits of a single-antenna launch on its gains;
//   * with counts (kCounts), each storing thread reads its trajectory's
//     count after the reduction and divides by it, so a count of N gives
//     the bits of a launch without counts. A launch without counts takes
//     the instantiation that divides by a float parameter: with the count
//     pointer in the kernel, ptxas schedules the node loop's loads
//     differently, 1-4 % slower at (3072 or 1024, 4096, 24) on an H100
//     (tools/ota_counts_ab.py);
//   * the kernel masks ragged N and d itself (the wrapper does not pad, where
//     the TPU wrapper padded to (8, 128) tiles).
// Later work: one block for all M antennas of a trajectory (g read once into
// registers, M accumulators), split N across blocks when B * M * ceil(d/32)
// underfills the 132 SMs, 16-byte loads, and fusing the gradient
// computation into the reduction.
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

template <typename GT, typename OT, bool kCounts>
__global__ void __launch_bounds__(kCols * kGroups)
    ota_aggregate_kernel(const GT* __restrict__ g, const float* __restrict__ h,
                         const float* __restrict__ w,
                         const float* __restrict__ n_true,
                         OT* __restrict__ out, int n_nodes, int dim,
                         int n_ant, float n_static) {
  __shared__ float partial[kGroups][kCols + 1];
  const int bm = blockIdx.x;  // the (trajectory, antenna) pair b * M + m
  const int b = bm / n_ant;
  const int col = blockIdx.y * kCols + threadIdx.x;
  const int grp = threadIdx.y;
  const GT* gb = g + static_cast<size_t>(b) * n_nodes * dim;
  const float* hb = h + static_cast<size_t>(bm) * n_nodes;

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
    const size_t o = static_cast<size_t>(bm) * dim + col;
    const float count = kCounts ? n_true[b] : n_static;
    store(out + o, partial[0][threadIdx.x] / count + w[o]);
  }
}

template <typename GT, typename OT>
void launch(const void* g, const void* h, const void* w, const void* n_true,
            void* out, int batch, int n_ant, int n_nodes, int dim,
            cudaStream_t stream) {
  const dim3 block(kCols, kGroups);
  const dim3 grid(static_cast<unsigned>(batch) * n_ant,
                  (dim + kCols - 1) / kCols);
  const auto kernel = n_true != nullptr ? ota_aggregate_kernel<GT, OT, true>
                                        : ota_aggregate_kernel<GT, OT, false>;
  kernel<<<grid, block, 0, stream>>>(
      static_cast<const GT*>(g), static_cast<const float*>(h),
      static_cast<const float*>(w), static_cast<const float*>(n_true),
      static_cast<OT*>(out), n_nodes, dim, n_ant,
      static_cast<float>(n_nodes));
}

}  // namespace

// g: (batch, n_nodes, dim) f32 (g_bf16 = 0) or bf16 (g_bf16 = 1);
// h: (batch, n_ant, n_nodes) f32; w: (batch, n_ant, dim) f32, already
// scaled; n_true: (batch,) f32 node counts, or null for n_nodes everywhere;
// out: (batch, n_ant, dim) f32 (out_bf16 = 0) or bf16. All contiguous, on
// the current device; batch * n_ant < 2^31 and ceil(dim / 32) <= 65535 (the
// wrapper checks). Returns cudaGetLastError() after the launch.
extern "C" int ota_aggregate(const void* g, const void* h, const void* w,
                             const void* n_true, void* out, int batch,
                             int n_ant, int n_nodes, int dim, int g_bf16,
                             int out_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (g_bf16) {
    if (out_bf16) {
      launch<__nv_bfloat16, __nv_bfloat16>(g, h, w, n_true, out, batch, n_ant,
                                           n_nodes, dim, s);
    } else {
      launch<__nv_bfloat16, float>(g, h, w, n_true, out, batch, n_ant,
                                   n_nodes, dim, s);
    }
  } else {
    if (out_bf16) {
      launch<float, __nv_bfloat16>(g, h, w, n_true, out, batch, n_ant,
                                   n_nodes, dim, s);
    } else {
      launch<float, float>(g, h, w, n_true, out, batch, n_ant, n_nodes, dim,
                           s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ota_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

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
// Bound: memory. Each gradient element is read once (whatever M) and used
// for 2M flops, so the least time is bytes / 3.35 TB/s with
//   bytes = B*N*d*sizeof(g) + 4*B*M*N (gains) + 4*B*M*d (noise)
//           + B*M*d*sizeof(out) + 4*B (counts, when given).
// At the engine's LARGE shape (B=1024, N=4096, d=24, M=1, f32) that is
// ~0.125 ms per launch; with M=16 antennas (LARGE MRC) ~0.201 ms; at the
// paper's operating point (B=4, N=500, d=90) ~0.2 us, i.e. launch-bound.
//
// Design:
//   * one thread block per (trajectory b, chunk of kChunk antennas, column
//     tile). kChunk is a template constant: 1 for a single antenna, else 8
//     (the lanes past M masked), M > 8 taking several chunks: LARGE MRC's
//     16 antennas are two blocks per trajectory, the second reading g[b]
//     mostly from L2. Each thread keeps kChunk x kVec f32 accumulators in
//     registers: it reads each of its g[b, n, col] once and uses it for
//     every antenna of the chunk. The chunk's gains are staged in shared
//     memory as hs[node][antenna] rows, a pass of 4096 / kChunk nodes at a
//     time (16-byte loads of 4 nodes of one antenna where N % 4 == 0), so
//     a thread reads a node's 8 gains as two LDS.128s;
//   * the block's threads are 8 node groups x `tile_lanes` column lanes,
//     the lanes of a group covering a tile of ceil(d / tiles) columns (or
//     column pairs, kVec = 2, for chunks of 8 at even d: one gain read
//     then feeds two columns): at d = 24 every lane works and one step of
//     the 8 groups reads 8 whole rows of g, contiguous in memory (the
//     kernel before this one ran 32-column tiles, idling 8 of 32 lanes);
//   * registers decide the waves (`Tune`): LARGE's 1,024 trajectories fit
//     one wave of 8 blocks an SM only at <= 40 registers (one antenna) or
//     <= 80 (chunks of 8);
//   * each (antenna, column) keeps the order of the kernel before the
//     antenna axis: node group grp sums n = grp, grp+8, ... in sequence
//     with fmaf, a fixed-order tree over the 8 groups (4, then 2, then 1
//     apart) combines them in shared memory, and the count divides after
//     the reduction. So each antenna has the bits of a single-antenna
//     launch on its gains, and M = 1 the bits of the kernel before, in the
//     count-free and the count instantiations; no atomics, so results are
//     identical from run to run;
//   * with counts (kCounts), each storing thread reads its trajectory's
//     count after the reduction and divides by it, so a count of N gives
//     the bits of a launch without counts. A launch without counts takes
//     the instantiation that divides by a float parameter (with the count
//     pointer read at the top, ptxas scheduled the node loop's loads
//     differently, 1-4 % slower on an H100: tools/ota_counts_ab.py);
//   * the kernel masks ragged N, d and M itself (the wrapper does not pad,
//     where the TPU wrapper padded to (8, 128) tiles).
// Times on an NVIDIA H100 80GB HBM3 at 700.00 W (tools/ota_antennas_ab.py,
// bare launches in turns against the kernel before, which ran one block per
// (b, m, 32 columns), so each of a trajectory's M blocks streamed g[b] from
// L2): at (1024, 16, 4096, 24) 0.287 ms, 70 % of the 0.2013 ms bound,
// against 0.987 and the einsum's 0.323; at LARGE 0.148 against 0.152 (with
// counts 0.148 against 0.153); the LARGE sweep with counts 0.421 against
// 0.437 (90 % of its bound); fig3's launches within the noise. PERF.md's K1
// row keeps each run's numbers.
// Later work: one block for 16 antennas with g staged through shared
// memory (cp.async loads in flight cost no registers, so 32 accumulators
// a column pair fit), split N across blocks (under a fixed combine order)
// where B * chunks * tiles underfills the 132 SMs, skip a padded sweep's
// rows past each trajectory's count, and fuse the gradient into the
// reduction.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kGroups = 8;       // node groups per block (power of two)
constexpr int kMaxLanes = 32;    // column lanes per group
constexpr int kMaxThreads = kGroups * kMaxLanes;

// Staged gains of a chunk: hs[j * stride + a] for node j of the pass and
// antenna a. The rows of 8 are whole 16 bytes (LDS.128), padded to 12
// floats so the 16-byte staging stores of a warp put at most two to a bank.
template <int kChunk>
struct Stage {
  static constexpr int kStride = kChunk == 8 ? 12 : kChunk;
  static constexpr int kNodes = 4096 / kChunk;  // nodes per pass
  static constexpr int kReduce = 4 * kChunk * 2 * kMaxLanes;
  static constexpr int kFloats =
      kNodes * kStride > kReduce ? kNodes * kStride : kReduce;
};

// Gradient loads a thread keeps in flight, and the blocks of 256 threads
// an SM must hold, which caps the registers: 40 for one antenna of f32
// gradients, so that 8 blocks of 192 threads (d = 24) hold LARGE's 1,024
// trajectories in one wave (bf16 gradients, off the engine's path, spilled
// there and take 48); 80 for 8 antennas (16 accumulators a column pair, 8
// loads in flight), so 8 blocks of 96 threads fit an SM. A chunk of 16
// antennas (32 accumulators a column pair) spilled under 80 registers and
// lost an SM's eighth block above it (tools/ota_chunk_levers.py times
// both).
template <typename GT, int kChunk>
struct Tune {
  static constexpr int kUnroll = kChunk == 8 ? 8 : 4;
  static constexpr int kMinBlocks =
      kChunk == 1 ? (sizeof(GT) == 4 ? 6 : 5) : 3;
};

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// kVec consecutive gradient columns at p, as f32.
template <int kVec>
__device__ __forceinline__ void load_g(const float* p, float (&v)[kVec]) {
  if constexpr (kVec == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x;
    v[1] = x.y;
  } else {
    v[0] = *p;
  }
}
template <int kVec>
__device__ __forceinline__ void load_g(const __nv_bfloat16* p,
                                       float (&v)[kVec]) {
  if constexpr (kVec == 2) {
    const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(p);
    v[0] = __bfloat162float(x.x);
    v[1] = __bfloat162float(x.y);
  } else {
    v[0] = __bfloat162float(*p);
  }
}

// The chunk's kChunk gains of one staged node row.
template <int kChunk>
__device__ __forceinline__ void load_h(const float* row,
                                       float (&v)[kChunk]) {
  if constexpr (kChunk == 1) {
    v[0] = row[0];
  } else {
#pragma unroll
    for (int q = 0; q < kChunk / 4; ++q) {
      const float4 x = reinterpret_cast<const float4*>(row)[q];
      v[4 * q] = x.x;
      v[4 * q + 1] = x.y;
      v[4 * q + 2] = x.z;
      v[4 * q + 3] = x.w;
    }
  }
}

// acc[a][v] += hs[a] * g[v], one fmaf each, in the node order of the caller.
template <int kChunk, int kVec>
__device__ __forceinline__ void fma_node(const float* row,
                                         const float (&gv)[kVec],
                                         float (&acc)[kChunk][kVec]) {
  float hv[kChunk];
  load_h<kChunk>(row, hv);
#pragma unroll
  for (int a = 0; a < kChunk; ++a) {
#pragma unroll
    for (int v = 0; v < kVec; ++v) acc[a][v] = fmaf(hv[a], gv[v], acc[a][v]);
  }
}

template <typename GT, typename OT, bool kCounts, int kChunk, int kVec>
__global__ void __launch_bounds__(kMaxThreads, Tune<GT, kChunk>::kMinBlocks)
    ota_aggregate_kernel(const GT* __restrict__ g, const float* __restrict__ h,
                         const float* __restrict__ w,
                         const float* __restrict__ n_true,
                         OT* __restrict__ out, int n_nodes, int dim,
                         int n_ant, int n_chunks, int tile_lanes, int h_vec4,
                         float n_static) {
  using St = Stage<kChunk>;
  constexpr int kS = St::kStride;
  constexpr int kUnroll = Tune<GT, kChunk>::kUnroll;
  __shared__ __align__(16) float smem[St::kFloats];
  const int b = blockIdx.x / n_chunks;
  const int m0 = (blockIdx.x % n_chunks) * kChunk;
  const int n_valid = min(kChunk, n_ant - m0);  // antennas of this chunk
  const int grp = threadIdx.x / tile_lanes;     // >= kGroups: padding
  const int lane = threadIdx.x % tile_lanes;
  const int col = (blockIdx.y * tile_lanes + lane) * kVec;
  const bool active = grp < kGroups && col < dim;
  const int g_step = kGroups * dim;  // a group's next node

  float acc[kChunk][kVec];
#pragma unroll
  for (int a = 0; a < kChunk; ++a) {
#pragma unroll
    for (int v = 0; v < kVec; ++v) acc[a][v] = 0.0f;
  }
  for (int n0 = 0; n0 < n_nodes; n0 += St::kNodes) {
    const int len = min(St::kNodes, n_nodes - n0);
    const float* hb = h + (static_cast<size_t>(b) * n_ant + m0) * n_nodes;
    __syncthreads();  // the previous pass's gains are read
    if (kChunk > 1 && h_vec4) {
      // 4 nodes of one antenna per 16-byte load, antennas across lanes
      for (int e = threadIdx.x; e < (len / 4) * kChunk; e += blockDim.x) {
        const int a = e % kChunk, q = e / kChunk;
        float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (a < n_valid) {
          x = *reinterpret_cast<const float4*>(
              hb + static_cast<size_t>(a) * n_nodes + n0 + 4 * q);
        }
        float* r = smem + 4 * q * kS + a;
        r[0] = x.x;
        r[kS] = x.y;
        r[2 * kS] = x.z;
        r[3 * kS] = x.w;
      }
    } else {
      for (int e = threadIdx.x; e < len * kChunk; e += blockDim.x) {
        const int a = e / len, j = e % len;  // nodes across lanes
        smem[j * kS + a] =
            a < n_valid ? hb[static_cast<size_t>(a) * n_nodes + n0 + j]
                        : 0.0f;
      }
    }
    __syncthreads();
    if (active) {
      // this group's nodes of the pass: j = grp, grp + 8, ... < len
      const int cnt = grp < len ? (len - grp + kGroups - 1) / kGroups : 0;
      const GT* gp =
          g + (static_cast<size_t>(b) * n_nodes + n0 + grp) * dim + col;
      const float* hs = smem + grp * kS;
      int i = 0;
      for (; i + kUnroll <= cnt; i += kUnroll) {
        float gv[kUnroll][kVec];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) load_g<kVec>(gp + u * g_step, gv[u]);
        gp += kUnroll * g_step;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          fma_node<kChunk, kVec>(hs + (i + u) * kGroups * kS, gv[u], acc);
        }
      }
      for (; i < cnt; ++i, gp += g_step) {
        float gv[kVec];
        load_g<kVec>(gp, gv);
        fma_node<kChunk, kVec>(hs + i * kGroups * kS, gv, acc);
      }
    }
  }

  // the fixed tree over the 8 groups: group grp adds group grp + stride
  __syncthreads();  // the last pass's gains are read
  const int vals = kChunk * kVec * tile_lanes;
#pragma unroll
  for (int stride = kGroups / 2; stride > 0; stride >>= 1) {
    if (active && grp >= stride && grp < 2 * stride) {
      float* r = smem + (grp - stride) * vals + lane;
#pragma unroll
      for (int a = 0; a < kChunk; ++a) {
#pragma unroll
        for (int v = 0; v < kVec; ++v) {
          r[(a * kVec + v) * tile_lanes] = acc[a][v];
        }
      }
    }
    __syncthreads();
    if (active && grp < stride) {
      const float* r = smem + grp * vals + lane;
#pragma unroll
      for (int a = 0; a < kChunk; ++a) {
#pragma unroll
        for (int v = 0; v < kVec; ++v) {
          acc[a][v] += r[(a * kVec + v) * tile_lanes];
        }
      }
    }
    __syncthreads();
  }
  if (active && grp == 0) {
    const float count = kCounts ? n_true[b] : n_static;
#pragma unroll
    for (int a = 0; a < kChunk; ++a) {
      if (a < n_valid) {
        const size_t o =
            (static_cast<size_t>(b) * n_ant + m0 + a) * dim + col;
#pragma unroll
        for (int v = 0; v < kVec; ++v) {
          store(out + o + v, acc[a][v] / count + w[o + v]);
        }
      }
    }
  }
}

template <typename GT, typename OT, int kChunk, int kVec>
void launch_chunk(const void* g, const void* h, const void* w,
                  const void* n_true, void* out, int batch, int n_ant,
                  int n_nodes, int dim, cudaStream_t stream) {
  const int lanes = (dim + kVec - 1) / kVec;  // columns (or pairs)
  const int tiles = (lanes + kMaxLanes - 1) / kMaxLanes;
  const int tile_lanes = (lanes + tiles - 1) / tiles;
  const int threads = (kGroups * tile_lanes + 31) / 32 * 32;
  const int n_chunks = (n_ant + kChunk - 1) / kChunk;
  const int h_vec4 =
      n_nodes % 4 == 0 && reinterpret_cast<uintptr_t>(h) % 16 == 0;
  const dim3 grid(static_cast<unsigned>(batch) * n_chunks, tiles);
  const auto kernel =
      n_true != nullptr ? ota_aggregate_kernel<GT, OT, true, kChunk, kVec>
                        : ota_aggregate_kernel<GT, OT, false, kChunk, kVec>;
  kernel<<<grid, threads, 0, stream>>>(
      static_cast<const GT*>(g), static_cast<const float*>(h),
      static_cast<const float*>(w), static_cast<const float*>(n_true),
      static_cast<OT*>(out), n_nodes, dim, n_ant, n_chunks, tile_lanes,
      h_vec4, static_cast<float>(n_nodes));
}

template <typename GT, typename OT>
void launch(const void* g, const void* h, const void* w, const void* n_true,
            void* out, int batch, int n_ant, int n_nodes, int dim,
            cudaStream_t stream) {
  // column pairs where a chunk of 8 antennas reuses each gain read for
  // two columns: even d and a pair-aligned g
  const bool pairs = dim % 2 == 0 &&
                     reinterpret_cast<uintptr_t>(g) % (2 * sizeof(GT)) == 0;
  if (n_ant <= 1) {
    launch_chunk<GT, OT, 1, 1>(g, h, w, n_true, out, batch, n_ant, n_nodes,
                               dim, stream);
  } else if (pairs) {
    launch_chunk<GT, OT, 8, 2>(g, h, w, n_true, out, batch, n_ant, n_nodes,
                               dim, stream);
  } else {
    launch_chunk<GT, OT, 8, 1>(g, h, w, n_true, out, batch, n_ant, n_nodes,
                               dim, stream);
  }
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

// Shared-memory cost of 128-bit loads on one card, for the register tiles of
// src/repro_torch/kernels/attention/csrc/flash_attention.cu and the row
// loads of src/repro_torch/kernels/wkv/csrc/wkv6.cu.
//
//   mkdir -p build && nvcc -gencode arch=compute_90a,code=sm_90a -O3 \
//       -o build/lds128_cost tools/lds128_cost.cu && build/lds128_cost
//
// Part 1: SM cycles per warp-wide LDS.128 (ld.volatile.shared.v4.f32, so
// none is merged away) for address patterns named by how many distinct
// 16-byte addresses each quarter-warp (8 lanes) reads; then 64- and 32-bit
// loads (ld.volatile.shared.v2.f32, .f32) with every lane on one address,
// the broadcast the WKV kernel's row loads make.
// Part 2: SM cycles per warp per chunk of the kernel's QK^T loop (an 8 x 8
// register tile, d in chunks of 4: 8 Q and 8 K float4 loads, 256 FFMAs),
// against the same FFMAs on registers alone and the same loads alone (64
// cycles is the FFMA peak: an SM issues 4 warp FFMAs a cycle).
// Both parts run 264 blocks of 128 threads with 106,496 bytes of shared
// memory each (two blocks per SM, as the kernel at d = 64) and convert
// CUDA-event times to cycles at 1980 MHz on 132 SMs (the H100 SXM's clock
// and SM count). Prints one line per measurement.
#include <cuda_runtime.h>

#include <cstdio>

namespace {

constexpr int kBlocks = 264;
constexpr int kThreads = 128;
constexpr int kSmem = 106496;
constexpr int kS = 68;  // the kernel's row stride at d = 64 (floats)
constexpr double kCyclesPerMs = 1.98e6 * 132;

// Element offset read by `lane` under each pattern.
__device__ int pattern_offset(int pattern, int lane) {
  const int quarter = lane / 8, l = lane % 8;
  switch (pattern) {
    case 0: return 0;                          // 1 address for the warp
    case 1: return quarter * kS;               // 1 per quarter (the Q rows)
    case 2: return (quarter * 2 + l % 2) * kS; // 2 per quarter
    case 3: return (l % 4) * kS;               // 4 per quarter
    case 4: return l * kS;                     // 8 rows per quarter (K rows)
    case 5: return l * 4;                      // 8 float4 in a row (V row)
    default: return lane * 4;                  // 32 float4 in a row
  }
}

constexpr const char* kPatterns[] = {
    "1 address per warp", "1 address per quarter-warp",
    "2 addresses per quarter-warp", "4 addresses per quarter-warp",
    "8 rows per quarter-warp", "8 float4 of one row per quarter-warp",
    "32 float4 of one row"};

// kWords floats per load: 4 (LDS.128), 2 (LDS.64) or 1 (LDS.32)
template <int kWords>
__global__ void __launch_bounds__(kThreads)
    lds_pattern(float* out, int pattern, int iters) {
  extern __shared__ __align__(16) float smem[];
  for (int i = threadIdx.x; i < kSmem / 4; i += kThreads) smem[i] = i;
  __syncthreads();
  const float* base = smem + (threadIdx.x / 32) * 16 +
                      pattern_offset(pattern, threadIdx.x % 32);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int it = 0; it < iters; ++it) {
    const unsigned a = static_cast<unsigned>(
        __cvta_generic_to_shared(base + (it & 3) * 4));
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if constexpr (kWords == 4) {
        asm volatile("ld.volatile.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
                     : "=f"(x.x), "=f"(x.y), "=f"(x.z), "=f"(x.w)
                     : "r"(a));
      } else if constexpr (kWords == 2) {
        asm volatile("ld.volatile.shared.v2.f32 {%0, %1}, [%2];"
                     : "=f"(x.x), "=f"(x.y)
                     : "r"(a));
      } else {
        asm volatile("ld.volatile.shared.f32 %0, [%1];" : "=f"(x.x) : "r"(a));
      }
      acc.x += x.x;
      if constexpr (kWords >= 2) acc.y += x.y;
      if constexpr (kWords == 4) {
        acc.z += x.z;
        acc.w += x.w;
      }
    }
  }
  out[blockIdx.x * kThreads + threadIdx.x] = acc.x + acc.y + acc.z + acc.w;
}

// kMode 0: FFMAs on registers; 1: the QK^T chunk; 2: its loads alone
template <int kMode>
__global__ void __launch_bounds__(kThreads)
    tile_chunk(float* out, int iters) {
  extern __shared__ __align__(16) float smem[];
  for (int i = threadIdx.x; i < kSmem / 4; i += kThreads) smem[i] = i * 1e-6f;
  __syncthreads();
  const int lane = threadIdx.x % 8, rg = threadIdx.x / 8;
  const float* q_base = smem + rg * kS;
  const float* k_base = smem + 128 * kS + lane * kS;
  float s[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
  }
  float4 qr[8], kr[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    qr[i] = make_float4(threadIdx.x * 1e-3f, i, 1.f, 2.f);
    kr[i] = make_float4(i, blockIdx.x * 1e-3f, 3.f, 4.f);
  }
  for (int it = 0; it < iters; ++it) {
#pragma unroll 1
    for (int d = 0; d < 64; d += 4) {
      float4 qf[8], kf[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if constexpr (kMode == 0) {
          qf[i] = qr[i];
          kf[i] = kr[i];
          qr[i].x += 1e-7f;
        } else {
          qf[i] = *reinterpret_cast<const float4*>(q_base + 16 * i * kS + d);
          kf[i] = *reinterpret_cast<const float4*>(k_base + 8 * i * kS + d);
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if constexpr (kMode == 2) {
          s[i][0] += qf[i].x + qf[i].y + qf[i].z + qf[i].w;
          s[i][1] += kf[i].x + kf[i].y + kf[i].z + kf[i].w;
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            s[i][j] = fmaf(qf[i].x, kf[j].x, s[i][j]);
            s[i][j] = fmaf(qf[i].y, kf[j].y, s[i][j]);
            s[i][j] = fmaf(qf[i].z, kf[j].z, s[i][j]);
            s[i][j] = fmaf(qf[i].w, kf[j].w, s[i][j]);
          }
        }
      }
    }
  }
  float t = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) t += s[i][j];
  }
  out[blockIdx.x * kThreads + threadIdx.x] = t;
}

template <class Launch>
float time_ms(Launch launch) {
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  launch();  // warm-up
  cudaEventRecord(a);
  launch();
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, a, b);
  cudaEventDestroy(a);
  cudaEventDestroy(b);
  return ms;
}

}  // namespace

int main() {
  float* out = nullptr;
  if (cudaMalloc(&out, kBlocks * kThreads * sizeof(float)) != cudaSuccess) {
    std::printf("lds128_cost: no CUDA device\n");
    return 2;
  }
  cudaFuncSetAttribute(lds_pattern<4>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  cudaFuncSetAttribute(lds_pattern<2>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  cudaFuncSetAttribute(lds_pattern<1>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  cudaFuncSetAttribute(tile_chunk<0>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  cudaFuncSetAttribute(tile_chunk<1>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  cudaFuncSetAttribute(tile_chunk<2>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  const int iters = 20000;
  const double warp_loads = double(kBlocks) * 4 * iters * 8;
  for (int p = 0; p < 7; ++p) {
    const float ms = time_ms([&] {
      lds_pattern<4><<<kBlocks, kThreads, kSmem>>>(out, p, iters);
    });
    std::printf("LDS.128, %s: %.2f SM cycles per warp load\n", kPatterns[p],
                ms * kCyclesPerMs / warp_loads);
  }
  const float ms64 = time_ms([&] {
    lds_pattern<2><<<kBlocks, kThreads, kSmem>>>(out, 0, iters);
  });
  std::printf("LDS.64, %s: %.2f SM cycles per warp load\n", kPatterns[0],
              ms64 * kCyclesPerMs / warp_loads);
  const float ms32 = time_ms([&] {
    lds_pattern<1><<<kBlocks, kThreads, kSmem>>>(out, 0, iters);
  });
  std::printf("LDS.32, %s: %.2f SM cycles per warp load\n", kPatterns[0],
              ms32 * kCyclesPerMs / warp_loads);
  const char* modes[] = {"256 FFMAs on registers", "QK^T chunk (16 LDS.128 "
                         "+ 256 FFMAs)", "its 16 LDS.128 alone"};
  const int chunk_iters = 2000;
  const double warp_chunks = double(kBlocks) * 4 * chunk_iters * 16;
  const float ms[3] = {
      time_ms([&] { tile_chunk<0><<<kBlocks, kThreads, kSmem>>>(out,
                                                                chunk_iters); }),
      time_ms([&] { tile_chunk<1><<<kBlocks, kThreads, kSmem>>>(out,
                                                                chunk_iters); }),
      time_ms([&] { tile_chunk<2><<<kBlocks, kThreads, kSmem>>>(out,
                                                                chunk_iters); })};
  for (int m = 0; m < 3; ++m) {
    std::printf("8 x 8 tile, %s: %.2f SM cycles per warp chunk\n", modes[m],
                ms[m] * kCyclesPerMs / warp_chunks);
  }
  const cudaError_t err = cudaDeviceSynchronize();
  if (err != cudaSuccess) {
    std::printf("lds128_cost: %s\n", cudaGetErrorString(err));
    return 1;
  }
  cudaFree(out);
  return 0;
}

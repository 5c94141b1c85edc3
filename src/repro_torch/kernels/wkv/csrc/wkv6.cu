// RWKV6 (Finch) WKV recurrence with data-dependent decay for NVIDIA Hopper
// (sm_90a). Per (batch, head), with the (D, D) f32 state S (rows are
// k-channels, columns v-channels):
//
//   o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
//   S_t = diag(w_t) S_{t-1} + k_t^T v_t
//
// Replaces the Pallas TPU kernel src/repro/kernels/wkv/kernel.py::_wkv_kernel
// (pallas_call in wkv6_kernel) together with its wrapper's padding of T to
// the chunk (with w = 1) and broadcast of u over the batch (ops.py): the
// loop runs exactly T steps, and each block reads u[head] itself.
//
// Bound: operations. The function needs, for each (t, i, j), the k v
// product, an FMA into o and an FMA for the decay: 5 flops. The bonus term
// sum_i r_i u_i k_i v_j is v_j times one dot product per step, so it needs
// 5 flops per (t, i) (the dot product, then one FMA into each o_j), not
// per (t, i, j); this kernel spends one more FMA per (t, i, j) on it.
// Against that: five (T, D) rows of r, k, v, w and o per head and one
// (D, D) state read and written. At the rwkv6-7b prefill (B, H, T, D) =
// (4, 64, 2048, 64) in bf16 that is 10.9 GFLOP over 344 MB, so the least
// time is the flops at the H100's f32 rate outside the tensor cores (67
// TFLOP/s): 0.163 ms, against 0.103 ms for the bytes. A decode step
// (T = 1) moves only the state and is bound by its bytes (and in practice
// by the launch).
//
// Design (simple and exact first):
//   * one block of D threads per (batch, head); thread j owns column j of
//     S and keeps it in D registers for the whole sequence, so the state
//     never leaves the chip between steps;
//   * r_t, k_t, v_t and w_t of kChunk steps at a time are widened to f32
//     into shared memory (thread j loads element j of each row: coalesced),
//     so one __syncthreads pair covers kChunk steps; u[head] is staged once;
//   * o_t[j] = sum_i r_i (S_ij + u_i k_i v_j) is summed over i in a fixed
//     order by the one thread that owns column j: no atomics, no reduction
//     across threads, so runs are repeatable bit for bit;
//   * r, k, v, w and o are addressed through (batch, head, time) strides,
//     so they can be the (B, T, H, D) projections seen as (B, H, T, D) and
//     o can be written in (B, T, H, D) memory, with no transpose copies;
//   * the final state goes to a buffer the caller gives, which may be s0
//     itself: a thread reads its whole column before it writes any of it,
//     and no other thread touches that column, so decode updates a layer's
//     slice of the stacked state in place.
// Shared memory: 4 * (4 * kChunk * D + D) bytes, 33,024 at D = 64.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kChunk = 32;  // time steps staged per __syncthreads pair

struct Params {
  const void* r;
  const void* k;
  const void* v;
  const void* w;
  const float* u;   // (heads, D)
  const float* s0;  // (batch, heads, D, D), or nullptr: S starts at zero
  float* s_out;     // (batch, heads, D, D); may equal s0
  void* o;
  int64_t r_sb, r_sh, r_st;  // element strides: batch, head, time
  int64_t k_sb, k_sh, k_st;
  int64_t v_sb, v_sh, v_st;
  int64_t w_sb, w_sh, w_st;
  int64_t o_sb, o_sh, o_st;
  int heads;
  int steps;  // T
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T, int D>
__global__ void __launch_bounds__(D) wkv6_kernel(const Params p) {
  __shared__ __align__(16) float s_r[kChunk][D];
  __shared__ __align__(16) float s_k[kChunk][D];
  __shared__ __align__(16) float s_v[kChunk][D];
  __shared__ __align__(16) float s_w[kChunk][D];
  __shared__ __align__(16) float s_u[D];

  const int j = threadIdx.x;  // this thread's v-column
  const int bh = blockIdx.x;
  const int b = bh / p.heads;
  const int h = bh % p.heads;
  const T* r = static_cast<const T*>(p.r) + b * p.r_sb + h * p.r_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* w = static_cast<const T*>(p.w) + b * p.w_sb + h * p.w_sh;
  T* o = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;
  const int64_t state = static_cast<int64_t>(bh) * D * D;

  float s[D];  // column j of S
#pragma unroll
  for (int i = 0; i < D; ++i) {
    s[i] = p.s0 != nullptr ? p.s0[state + i * D + j] : 0.0f;
  }
  s_u[j] = p.u[h * D + j];

  for (int t0 = 0; t0 < p.steps; t0 += kChunk) {
    const int n = min(kChunk, p.steps - t0);
    __syncthreads();  // the previous chunk's readers are done (and s_u set)
    for (int c = 0; c < n; ++c) {
      const int64_t t = t0 + c;
      s_r[c][j] = to_f32(r[t * p.r_st + j]);
      s_k[c][j] = to_f32(k[t * p.k_st + j]);
      s_v[c][j] = to_f32(v[t * p.v_st + j]);
      s_w[c][j] = to_f32(w[t * p.w_st + j]);
    }
    __syncthreads();
    for (int c = 0; c < n; ++c) {
      const float vj = s_v[c][j];
      float acc = 0.0f;
#pragma unroll
      for (int i = 0; i < D; ++i) {
        const float kv = s_k[c][i] * vj;
        acc = fmaf(s_r[c][i], fmaf(s_u[i], kv, s[i]), acc);
        s[i] = fmaf(s_w[c][i], s[i], kv);
      }
      store(o + (t0 + c) * p.o_st + j, acc);
    }
  }

#pragma unroll
  for (int i = 0; i < D; ++i) p.s_out[state + i * D + j] = s[i];
}

template <typename T, int D>
int launch(const Params& p, int batch, cudaStream_t stream) {
  wkv6_kernel<T, D><<<batch * p.heads, D, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_dim(const Params& p, int batch, int head_dim,
                 cudaStream_t stream) {
  switch (head_dim) {
    case 16: return launch<T, 16>(p, batch, stream);
    case 32: return launch<T, 32>(p, batch, stream);
    case 64: return launch<T, 64>(p, batch, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// r, k, v, w: (batch, heads, steps, head_dim), all f32 (bf16 = 0) or all
// bf16 (bf16 = 1), unit stride along head_dim and the element strides
// `strides` = {r_b, r_h, r_t, k_b, k_h, k_t, v_b, v_h, v_t, w_b, w_h, w_t,
// o_b, o_h, o_t}; o: like r, in the same dtype; u: (heads, head_dim) f32;
// s0 (or null: zeros) and s_out: contiguous (batch, heads, head_dim,
// head_dim) f32, s_out may be s0. head_dim in {16, 32, 64}. Returns a CUDA
// error code (0 on success): cudaGetLastError() after the launch.
extern "C" int wkv6_forward(const void* r, const void* k, const void* v,
                            const void* w, const float* u, const float* s0,
                            float* s_out, void* o, const int64_t* strides,
                            int batch, int heads, int steps, int head_dim,
                            int bf16, void* stream) {
  Params p;
  p.r = r;
  p.k = k;
  p.v = v;
  p.w = w;
  p.u = u;
  p.s0 = s0;
  p.s_out = s_out;
  p.o = o;
  p.r_sb = strides[0];
  p.r_sh = strides[1];
  p.r_st = strides[2];
  p.k_sb = strides[3];
  p.k_sh = strides[4];
  p.k_st = strides[5];
  p.v_sb = strides[6];
  p.v_sh = strides[7];
  p.v_st = strides[8];
  p.w_sb = strides[9];
  p.w_sh = strides[10];
  p.w_st = strides[11];
  p.o_sb = strides[12];
  p.o_sh = strides[13];
  p.o_st = strides[14];
  p.heads = heads;
  p.steps = steps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) return dispatch_dim<__nv_bfloat16>(p, batch, head_dim, s);
  return dispatch_dim<float>(p, batch, head_dim, s);
}

extern "C" const char* wkv6_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

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
// Design:
//   * one block of D threads per (batch, head); thread j owns column j of
//     S and keeps it in D registers for the whole sequence, so the state
//     never leaves the chip between steps. Each column's per-step sequence
//     is kept exactly: for i = 0 .. D-1 in order, kv = k_i v_j,
//     acc = fma(r_i, fma(u_i, kv, s_i), acc), s_i = fma(w_i, s_i, kv).
//     Summing o in another order moves rwkv6-7b's f32 whole-model route
//     gap (32 recurrent layers) against the 1e-4 bar that chip_smoke.py
//     holds it to; with the order kept, this kernel gives the bits of the
//     plain per-column loop it replaced, and runs stay repeatable bit for
//     bit (no atomics, no reduction across threads);
//   * the work is 4 FP instructions per (t, i) and thread, and at B H =
//     256 blocks of 64 threads an SM holds 4 warps, one per scheduler, so
//     nothing hides a stall: the design removes them instead;
//   * staging: r, k, v and w of kChunk steps are copied raw (16-byte
//     cp.async) into one staging buffer while the previous chunk is
//     computed, then widened once to f32 planes (an exact conversion):
//     per chunk one wait and two barriers, and no global latency exposed
//     after the first chunk (the loop it replaces waited for each step's
//     loads in turn, ~40 % of its time);
//   * loads: r, k, w and u of a step are read 4 rows at a time as float4
//     broadcasts (every lane reads one address): one LDS.128 per row. A
//     warp's LDS.128 takes ~2.1 SM cycles on the H100 whatever its
//     pattern (tools/lds128_cost.cu), so the SM's 4 warps need ~8.5 cycles
//     of shared memory per row against 4 issue cycles of FP work: shared
//     memory bounds the loop. Holding u in registers would need only 3
//     loads per 4 rows, but ptxas then issues each load just before its
//     use, and the exposed latency costs more than the loads saved
//     (tools/wkv6_levers.py times both);
//   * a full chunk runs a fixed-trip step loop unrolled by 2, so step
//     t + 1's loads and products start under step t's chain (ptxas then
//     keeps the loads of a whole step in flight: 254 registers, no
//     spills); the ragged last chunk (and decode, T = 1) runs the same
//     step in a rolled loop;
//   * r, k, v, w and o are addressed through (batch, head, time) strides,
//     so they can be the (B, T, H, D) projections seen as (B, H, T, D) and
//     o can be written in (B, T, H, D) memory, with no transpose copies.
//     A view whose base or (batch, head, time) strides are off 16 bytes
//     runs the element-copy instantiation (kVec16 = false: plain loads and
//     stores into the same staging buffer), which gives the same bits;
//   * the final state goes to a buffer the caller gives, which may be s0
//     itself: a thread reads its whole column before it writes any of it,
//     and no other thread touches that column, so decode updates a layer's
//     slice of the stacked state in place;
//   * for training, given a checkpoint buffer (ckpt, not null), each thread
//     also writes its column of the state S_{t0} at the start of every
//     chunk (t0 = 0, kChunk, ...), before the chunk's steps: (batch * heads,
//     ceil(T / kChunk), D, D) f32, what the hand-written backward
//     (wkv6_bwd.cu) restarts each chunk from. The stores lie outside the
//     step loop and change no arithmetic: o and the final state keep their
//     bits. They are an instantiation of their own (kCkpt): a null ckpt
//     runs the kernel compiled without them, since with the stores in the
//     one kernel ptxas allocated its registers otherwise (244, not 254, at
//     bf16 D = 64) and the serving prefill took 2.6 % longer on an H100.
// Shared memory (dynamic): the staging buffer (4 kChunk D elements), the
// r, k, w and v planes (4 kChunk D floats) and u: 49,408 bytes at D = 64 in
// bf16, 65,792 in f32, so two blocks fit on an SM.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kChunk = 32;  // time steps staged per wait

struct Params {
  const void* r;
  const void* k;
  const void* v;
  const void* w;
  const float* u;   // (heads, D)
  const float* s0;  // (batch, heads, D, D), or nullptr: S starts at zero
  float* s_out;     // (batch, heads, D, D); may equal s0
  float* ckpt;      // (batch * heads, ceil(steps / kChunk), D, D), or null
  void* o;
  int64_t r_sb, r_sh, r_st;  // element strides: batch, head, time
  int64_t k_sb, k_sh, k_st;
  int64_t v_sb, v_sh, v_st;
  int64_t w_sb, w_sh, w_st;
  int64_t o_sb, o_sh, o_st;
  int heads;
  int steps;  // T
};

template <typename T, int D>
struct Smem {
  alignas(16) T raw[4][kChunk][D];  // r, k, v, w of the next chunk, as read
  alignas(16) float r[kChunk][D];   // the current chunk, widened
  alignas(16) float k[kChunk][D];
  alignas(16) float w[kChunk][D];
  alignas(16) float v[kChunk][D];
  alignas(16) float u[D];
};

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Four consecutive staged elements, widened to f32 (exact).
__device__ __forceinline__ float4 widen4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 widen4(const __nv_bfloat16* p) {
  const __nv_bfloat162* q = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 a = __bfloat1622float2(q[0]);
  const float2 b = __bfloat1622float2(q[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Stage steps t0 .. t0 + n - 1 of r, k, v and w (src[q] at time stride
// st[q]) into sm.raw: 16-byte asynchronous copies (kVec16), or one element
// per thread and row, loaded and stored.
template <typename T, int D, bool kVec16>
__device__ __forceinline__ void stage(Smem<T, D>& sm, const T* const (&src)[4],
                                      const int64_t (&st)[4], int64_t t0,
                                      int n, int j) {
  if constexpr (kVec16) {
    constexpr int kPerCopy = 16 / sizeof(T);
    constexpr int kRowCopies = D / kPerCopy;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll 1
      for (int e = j; e < n * kRowCopies; e += D) {
        const int c = e / kRowCopies;
        const int x = (e % kRowCopies) * kPerCopy;
        cp_async16(&sm.raw[q][c][x], src[q] + (t0 + c) * st[q] + x);
      }
    }
    cp_async_commit();
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll 4
      for (int c = 0; c < n; ++c) {
        sm.raw[q][c][j] = src[q][(t0 + c) * st[q] + j];
      }
    }
  }
}

// Widen the n staged steps into the f32 planes, 4 elements per thread and
// iteration.
template <typename T, int D>
__device__ __forceinline__ void widen(Smem<T, D>& sm, int n, int j) {
  constexpr int kGroups = D / 4;
  float* const plane[4] = {&sm.r[0][0], &sm.k[0][0], &sm.v[0][0],
                           &sm.w[0][0]};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
#pragma unroll 1
    for (int e = j; e < n * kGroups; e += D) {
      const int c = e / kGroups;
      const int x = (e % kGroups) * 4;
      *reinterpret_cast<float4*>(plane[q] + c * D + x) =
          widen4(&sm.raw[q][c][x]);
    }
  }
}

// One (t, i) of column j, in the order every step keeps.
__device__ __forceinline__ void update(float r, float k, float w, float u,
                                       float vj, float& s, float& acc) {
  const float kv = k * vj;
  acc = fmaf(r, fmaf(u, kv, s), acc);
  s = fmaf(w, s, kv);
}

// One step of column j: returns o_t[j] and advances s. r, k, w: the step's
// rows of the planes; u: u[head] in shared memory.
template <int D>
__device__ __forceinline__ float step(const float* r, const float* k,
                                      const float* w, const float* u,
                                      float vj, float (&s)[D]) {
  float acc = 0.0f;
#pragma unroll
  for (int i = 0; i < D; i += 4) {
    const float4 r4 = *reinterpret_cast<const float4*>(r + i);
    const float4 k4 = *reinterpret_cast<const float4*>(k + i);
    const float4 w4 = *reinterpret_cast<const float4*>(w + i);
    const float4 u4 = *reinterpret_cast<const float4*>(u + i);
    update(r4.x, k4.x, w4.x, u4.x, vj, s[i], acc);
    update(r4.y, k4.y, w4.y, u4.y, vj, s[i + 1], acc);
    update(r4.z, k4.z, w4.z, u4.z, vj, s[i + 2], acc);
    update(r4.w, k4.w, w4.w, u4.w, vj, s[i + 3], acc);
  }
  return acc;
}

template <typename T, int D, bool kVec16, bool kCkpt>
__global__ void __launch_bounds__(D) wkv6_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  Smem<T, D>& sm = *reinterpret_cast<Smem<T, D>*>(smem);

  const int j = threadIdx.x;  // this thread's v-column
  const int bh = blockIdx.x;
  const int b = bh / p.heads;
  const int h = bh % p.heads;
  const T* const src[4] = {
      static_cast<const T*>(p.r) + b * p.r_sb + h * p.r_sh,
      static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh,
      static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh,
      static_cast<const T*>(p.w) + b * p.w_sb + h * p.w_sh};
  const int64_t st[4] = {p.r_st, p.k_st, p.v_st, p.w_st};
  T* o = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;
  const int64_t state = static_cast<int64_t>(bh) * D * D;
  const int steps = p.steps;

  // the first chunk lands while the state column is read
  if (steps > 0) stage<T, D, kVec16>(sm, src, st, 0, min(kChunk, steps), j);
  float s[D];  // column j of S
#pragma unroll
  for (int i = 0; i < D; ++i) {
    s[i] = p.s0 != nullptr ? p.s0[state + i * D + j] : 0.0f;
  }
  sm.u[j] = p.u[h * D + j];

  for (int t0 = 0; t0 < steps; t0 += kChunk) {
    const int n = min(kChunk, steps - t0);
    if constexpr (kCkpt) {
      float* const dst = p.ckpt + (static_cast<int64_t>(bh) *
                                       ((steps + kChunk - 1) / kChunk) +
                                   t0 / kChunk) * D * D + j;
#pragma unroll
      for (int i = 0; i < D; ++i) dst[i * D] = s[i];
    }
    cp_async_wait_all();
    __syncthreads();  // the chunk has landed; the last one's readers are done
    widen<T, D>(sm, n, j);
    __syncthreads();  // the planes are ready and the staging buffer is free
    if (t0 + kChunk < steps) {
      stage<T, D, kVec16>(sm, src, st, t0 + kChunk,
                          min(kChunk, steps - t0 - kChunk), j);
    }
    T* const ot = o + t0 * p.o_st + j;
    const auto one_step = [&](int c) {
      store(ot + c * p.o_st,
            step<D>(sm.r[c], sm.k[c], sm.w[c], sm.u, sm.v[c][j], s));
    };
    if (n == kChunk) {
#pragma unroll 2
      for (int c = 0; c < kChunk; ++c) one_step(c);
    } else {
#pragma unroll 1
      for (int c = 0; c < n; ++c) one_step(c);
    }
  }

#pragma unroll
  for (int i = 0; i < D; ++i) p.s_out[state + i * D + j] = s[i];
}

template <typename T, int D, bool kVec16, bool kCkpt>
int launch_ckpt(const Params& p, int batch, cudaStream_t stream) {
  constexpr int bytes = sizeof(Smem<T, D>);
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_kernel<T, D, kVec16, kCkpt>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  wkv6_kernel<T, D, kVec16, kCkpt><<<batch * p.heads, D, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D, bool kVec16>
int launch(const Params& p, int batch, cudaStream_t stream) {
  if (p.ckpt != nullptr) {
    return launch_ckpt<T, D, kVec16, true>(p, batch, stream);
  }
  return launch_ckpt<T, D, kVec16, false>(p, batch, stream);
}

template <typename T, bool kVec16>
int dispatch_dim(const Params& p, int batch, int head_dim,
                 cudaStream_t stream) {
  switch (head_dim) {
    case 16: return launch<T, 16, kVec16>(p, batch, stream);
    case 32: return launch<T, 32, kVec16>(p, batch, stream);
    case 64: return launch<T, 64, kVec16>(p, batch, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int dispatch_copy(const Params& p, int batch, int head_dim, int copy_bytes,
                  cudaStream_t stream) {
  if (copy_bytes == 16) return dispatch_dim<T, true>(p, batch, head_dim,
                                                     stream);
  if (copy_bytes == static_cast<int>(sizeof(T))) {
    return dispatch_dim<T, false>(p, batch, head_dim, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int smem_bytes(int head_dim) {
  switch (head_dim) {
    case 16: return sizeof(Smem<T, 16>);
    case 32: return sizeof(Smem<T, 32>);
    case 64: return sizeof(Smem<T, 64>);
    default: return 0;
  }
}

}  // namespace

// r, k, v, w: (batch, heads, steps, head_dim), all f32 (bf16 = 0) or all
// bf16 (bf16 = 1), unit stride along head_dim and the element strides
// `strides` = {r_b, r_h, r_t, k_b, k_h, k_t, v_b, v_h, v_t, w_b, w_h, w_t,
// o_b, o_h, o_t}; o: like r, in the same dtype; u: (heads, head_dim) f32;
// s0 (or null: zeros) and s_out: contiguous (batch, heads, head_dim,
// head_dim) f32, s_out may be s0. head_dim in {16, 32, 64}. copy_bytes
// picks how r, k, v and w are staged (the wrapper chooses,
// kernel.copy_bytes): 16 needs 16-byte-aligned base addresses and (batch,
// head, time) strides of whole 16 bytes wherever the dimension is longer
// than 1; the element size (4 for f32, 2 for bf16) takes any such view;
// both give the same bits. ckpt, when not null, receives the state at the
// start of every chunk of kChunk steps (wkv6_ckpt_steps): a contiguous f32
// (batch * heads, ceil(steps / kChunk), head_dim, head_dim) buffer.
// Returns a CUDA error code (0 on success): cudaErrorInvalidValue for an
// unsupported head_dim or copy width, else cudaFuncSetAttribute's or
// cudaGetLastError() after the launch.
extern "C" int wkv6_forward(const void* r, const void* k, const void* v,
                            const void* w, const float* u, const float* s0,
                            float* s_out, void* o, const int64_t* strides,
                            int batch, int heads, int steps, int head_dim,
                            int bf16, void* stream, int copy_bytes,
                            float* ckpt) {
  Params p;
  p.r = r;
  p.k = k;
  p.v = v;
  p.w = w;
  p.u = u;
  p.s0 = s0;
  p.s_out = s_out;
  p.ckpt = ckpt;
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
  if (bf16) {
    return dispatch_copy<__nv_bfloat16>(p, batch, head_dim, copy_bytes, s);
  }
  return dispatch_copy<float>(p, batch, head_dim, copy_bytes, s);
}

// Dynamic shared memory per block for a head_dim (0 if unsupported).
extern "C" int wkv6_smem_bytes(int head_dim, int bf16) {
  return bf16 ? smem_bytes<__nv_bfloat16>(head_dim)
              : smem_bytes<float>(head_dim);
}

// Steps between two states of the checkpoint buffer.
extern "C" int wkv6_ckpt_steps() { return kChunk; }

extern "C" const char* wkv6_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

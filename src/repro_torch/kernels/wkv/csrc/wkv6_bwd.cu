// Backward of the RWKV6 (Finch) WKV recurrence for NVIDIA Hopper (sm_90a).
// Per (batch, head), with the (D, D) f32 state S (rows are k-channels,
// columns v-channels) and the forward
//
//   o_t = r_t (S_{t-1} + diag(u) k_t^T v_t),   S_t = diag(w_t) S_{t-1} + k_t^T v_t,
//
// the gradients from do_t and dS_T (ds_fin), walking t = T .. 1 with
// dS_t the gradient of S_t:
//
//   dr_t[i] = sum_j do_t[j] S_{t-1}[i][j] + u[i] k_t[i] (v_t . do_t)
//   dk_t[i] = sum_j dS_t[i][j] v_t[j] + r_t[i] u[i] (v_t . do_t)
//   dv_t[j] = sum_i (dS_t[i][j] + r_t[i] u[i] do_t[j]) k_t[i]
//   dw_t[i] = sum_j dS_t[i][j] S_{t-1}[i][j]
//   du[i]  += r_t[i] k_t[i] (v_t . do_t)
//   dS_{t-1}[i][j] = w_t[i] dS_t[i][j] + r_t[i] do_t[j],   ds0 = dS_0.
//
// Replaces no TPU kernel: the JAX package differentiates its WKV through
// jax.vjp of the checkpointed scan src/repro/kernels/wkv/ref.py::wkv6_ref
// (64-step chunks, each recomputed in the backward) and has no backward
// Pallas kernel. This kernel is the backward of K3 (wkv6.cu, which
// replaces src/repro/kernels/wkv/kernel.py::_wkv_kernel) in the port's
// torch.autograd.Function (kernels/wkv/ops.py).
//
// Bound: operations. Per (t, i, j) the function needs the state S_{t-1}
// (recomputed: the k v product and the decay FMA, 3 flops), then the four
// sums of dr, dk, dv and dw and the dS update (2 flops each): 13 flops.
// At rwkv6-7b's training shape (B, H, T, D) = (8, 64, 256, 64) that is
// 7.0 GFLOP, 0.105 ms at the H100's 67 TFLOP/s f32 rate outside the tensor
// cores, against ~0.03 ms for the ~110 MB the inputs and gradients move.
//
// Design (simple first; the states of a chunk go through device memory):
//   * one block of D threads per (batch, head); thread i owns ROW i of S
//     and of dS: dr, dk, dw and du are then sums within the thread, and
//     only dv sums across threads (a column sum through shared memory,
//     padded to D + 1 floats a row so neither the writes nor the reads
//     conflict), in the fixed order i = 0 .. D-1: runs repeat bit for bit;
//   * the forward (wkv6.cu) writes the state at the start of every chunk
//     of kChunk = 32 steps; the backward takes the chunks in reverse. For
//     each: r, k, v, w and do of its steps are staged into f32 planes in
//     shared memory (element i of each row by thread i, coalesced); the
//     thread restarts its row of S from the chunk's checkpoint and walks
//     the chunk forward with the forward's own FMA (s = fma(w, s, k v): the
//     forward's bits), writing each S_{t-1} into a per-block scratch buffer
//     in device memory (float4 per thread, laid out [step][j / 4][i] so a
//     warp's stores and loads are contiguous); then it walks the chunk
//     backward, reading S_{t-1} back, with dS in registers;
//   * sums over j run in order j = 0 .. D-1 with FMAs, 4 columns per
//     shared float4 broadcast; dv's term r u do k is folded into the
//     column sum (each element (dS + r u do) k, one FMA);
//   * r, k, v, w, do and the four outputs are addressed through (batch,
//     head, time) strides, as in wkv6.cu; du is written per (batch, head)
//     and summed over the batch by the wrapper (u is shared by the batch).
// Memory: the scratch holds kChunk states per block (512 KB at D = 64),
// written once and read once: 4.3 GB at the training shape, ~1.3 ms at
// the card's 3.35 TB/s, so this first version is bound by that traffic,
// not by its bound's flops (2.26 ms measured on an H100, 4.7 % of the
// bound). Shared memory (dynamic): five planes of kChunk D floats, the
// padded D x (D + 1) column-sum buffer and u: 57,856 bytes at D = 64.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kChunk = 32;  // steps between two checkpoints (wkv6.cu's)

struct Params {
  const void* in[5];  // r, k, v, w, do
  void* out[4];       // dr, dk, dv, dw
  int64_t sb[9], sh[9], st[9];  // element strides (batch, head, time):
                                // in[0..4], then out[0..3]
  const float* u;       // (heads, D)
  const float* ckpt;    // (batch * heads, ceil(steps / kChunk), D, D)
  const float* ds_fin;  // (batch * heads, D, D), or null: zeros
  float* scratch;       // (batch * heads, kChunk, D, D)
  float* du;            // (batch * heads, D)
  float* ds0;           // (batch * heads, D, D), or null: not written
  int heads;
  int steps;
};

template <int D>
struct Smem {
  alignas(16) float plane[5][kChunk][D];  // r, k, v, w, do of the chunk
  alignas(16) float u[D];
  float red[D][D + 1];  // (dS_t[i][j] + r u do[j]) k_i, row i by thread i
};

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T, int D>
__global__ void __launch_bounds__(D) wkv6_bwd_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  Smem<D>& sm = *reinterpret_cast<Smem<D>*>(smem);
  float(&r_pl)[kChunk][D] = sm.plane[0];
  float(&k_pl)[kChunk][D] = sm.plane[1];
  float(&v_pl)[kChunk][D] = sm.plane[2];
  float(&w_pl)[kChunk][D] = sm.plane[3];
  float(&g_pl)[kChunk][D] = sm.plane[4];

  const int i = threadIdx.x;  // this thread's row of S and dS
  const int bh = blockIdx.x;
  const int b = bh / p.heads;
  const int h = bh % p.heads;
  const T* src[5];
#pragma unroll
  for (int q = 0; q < 5; ++q) {
    src[q] = static_cast<const T*>(p.in[q]) + b * p.sb[q] + h * p.sh[q];
  }
  T* dst[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    dst[q] = static_cast<T*>(p.out[q]) + b * p.sb[5 + q] + h * p.sh[5 + q];
  }
  const int steps = p.steps;
  const int n_ckpt = (steps + kChunk - 1) / kChunk;
  const int64_t state = static_cast<int64_t>(bh) * D * D;
  float4* const scratch =
      reinterpret_cast<float4*>(p.scratch + static_cast<int64_t>(bh) *
                                                kChunk * D * D);
  const float u_i = p.u[h * D + i];
  sm.u[i] = u_i;

  float ds[D];  // row i of dS
#pragma unroll
  for (int j = 0; j < D; ++j) {
    ds[j] = p.ds_fin != nullptr ? p.ds_fin[state + i * D + j] : 0.0f;
  }
  float du = 0.0f;

  for (int c = n_ckpt - 1; c >= 0; --c) {
    const int t0 = c * kChunk;
    const int n = min(kChunk, steps - t0);
    __syncthreads();  // the previous chunk's readers are done
#pragma unroll
    for (int q = 0; q < 5; ++q) {
#pragma unroll 4
      for (int cc = 0; cc < n; ++cc) {
        sm.plane[q][cc][i] = load(src[q] + (t0 + cc) * p.st[q] + i);
      }
    }
    __syncthreads();  // the planes are ready

    // restart row i of S from the chunk's checkpoint and walk forward,
    // keeping S_{t-1} of every step of the chunk in the scratch buffer
    {
      float s[D];
      const float4* ck = reinterpret_cast<const float4*>(
          p.ckpt + (static_cast<int64_t>(bh) * n_ckpt + c) * D * D + i * D);
#pragma unroll
      for (int q = 0; q < D / 4; ++q) {
        const float4 x = ck[q];
        s[4 * q] = x.x;
        s[4 * q + 1] = x.y;
        s[4 * q + 2] = x.z;
        s[4 * q + 3] = x.w;
      }
#pragma unroll 1
      for (int cc = 0; cc < n; ++cc) {
        float4* row = scratch + static_cast<int64_t>(cc) * (D / 4) * D + i;
#pragma unroll
        for (int q = 0; q < D / 4; ++q) {
          row[q * D] = make_float4(s[4 * q], s[4 * q + 1], s[4 * q + 2],
                                   s[4 * q + 3]);
        }
        const float w_i = w_pl[cc][i];
        const float k_i = k_pl[cc][i];
#pragma unroll
        for (int q = 0; q < D / 4; ++q) {
          const float4 v4 = *reinterpret_cast<const float4*>(&v_pl[cc][4 * q]);
          s[4 * q] = fmaf(w_i, s[4 * q], k_i * v4.x);
          s[4 * q + 1] = fmaf(w_i, s[4 * q + 1], k_i * v4.y);
          s[4 * q + 2] = fmaf(w_i, s[4 * q + 2], k_i * v4.z);
          s[4 * q + 3] = fmaf(w_i, s[4 * q + 3], k_i * v4.w);
        }
      }
    }

    // the chunk's steps in reverse, dS in registers
#pragma unroll 1
    for (int cc = n - 1; cc >= 0; --cc) {
      const float r_i = r_pl[cc][i];
      const float k_i = k_pl[cc][i];
      const float w_i = w_pl[cc][i];
      const float ruk = r_i * u_i * k_i;
      const float4* row = scratch + static_cast<int64_t>(cc) * (D / 4) * D + i;
      float x = 0.0f;    // sum_j do[j] S_{t-1}[i][j]
      float y = 0.0f;    // sum_j dS_t[i][j] v[j]
      float z = 0.0f;    // sum_j dS_t[i][j] S_{t-1}[i][j]
      float vdo = 0.0f;  // v . do
#pragma unroll
      for (int q = 0; q < D / 4; ++q) {
        const float4 sp = row[q * D];
        const float4 g4 = *reinterpret_cast<const float4*>(&g_pl[cc][4 * q]);
        const float4 v4 = *reinterpret_cast<const float4*>(&v_pl[cc][4 * q]);
        const float spj[4] = {sp.x, sp.y, sp.z, sp.w};
        const float gj[4] = {g4.x, g4.y, g4.z, g4.w};
        const float vj[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = 4 * q + e;
          x = fmaf(gj[e], spj[e], x);
          y = fmaf(ds[j], vj[e], y);
          z = fmaf(ds[j], spj[e], z);
          vdo = fmaf(vj[e], gj[e], vdo);
          sm.red[i][j] = fmaf(ds[j], k_i, ruk * gj[e]);
          ds[j] = fmaf(w_i, ds[j], r_i * gj[e]);  // now dS_{t-1}
        }
      }
      const int64_t t = t0 + cc;
      store(dst[0] + t * p.st[5] + i, fmaf(u_i * k_i, vdo, x));  // dr
      store(dst[1] + t * p.st[6] + i, fmaf(r_i * u_i, vdo, y));  // dk
      store(dst[3] + t * p.st[8] + i, z);                        // dw
      du = fmaf(r_i * k_i, vdo, du);
      __syncthreads();  // every row of red is written
      float col = 0.0f;  // dv[i]: thread i sums column i over the rows
#pragma unroll 8
      for (int ii = 0; ii < D; ++ii) col += sm.red[ii][i];
      store(dst[2] + t * p.st[7] + i, col);
      __syncthreads();  // red is free for the next step
    }
  }

  p.du[static_cast<int64_t>(bh) * D + i] = du;
  if (p.ds0 != nullptr) {
    float4* out = reinterpret_cast<float4*>(p.ds0 + state + i * D);
#pragma unroll
    for (int q = 0; q < D / 4; ++q) {
      out[q] = make_float4(ds[4 * q], ds[4 * q + 1], ds[4 * q + 2],
                           ds[4 * q + 3]);
    }
  }
}

template <typename T, int D>
int launch(const Params& p, int batch, cudaStream_t stream) {
  constexpr int bytes = sizeof(Smem<D>);
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_bwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  wkv6_bwd_kernel<T, D><<<batch * p.heads, D, bytes, stream>>>(p);
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

// r, k, v, w, dout: (batch, heads, steps, head_dim), all f32 (bf16 = 0) or
// all bf16 (bf16 = 1), unit stride along head_dim; dr, dk, dv, dw: the same
// shape and dtype; `strides` = the (batch, head, time) element strides of
// r, k, v, w, dout, dr, dk, dv, dw in that order (27 values). u: (heads,
// head_dim) f32; ckpt: wkv6_forward's checkpoints of the same call (the
// state at the start of every chunk of wkv6_bwd_ckpt_steps() steps); ds_fin
// (or null: zeros), ds0 (or null: not written): contiguous (batch, heads,
// head_dim, head_dim) f32; scratch: contiguous f32 of batch * heads *
// wkv6_bwd_ckpt_steps() * head_dim^2 elements; du: (batch, heads, head_dim)
// f32, each (batch, head)'s sum over time. head_dim in {16, 32, 64} (and
// 16-byte-aligned ckpt, scratch and ds0). Returns a CUDA error code (0 on
// success).
extern "C" int wkv6_backward(const void* r, const void* k, const void* v,
                             const void* w, const void* dout, const float* u,
                             const float* ckpt, const float* ds_fin,
                             float* scratch, void* dr, void* dk, void* dv,
                             void* dw, float* du, float* ds0,
                             const int64_t* strides, int batch, int heads,
                             int steps, int head_dim, int bf16,
                             void* stream) {
  Params p;
  p.in[0] = r;
  p.in[1] = k;
  p.in[2] = v;
  p.in[3] = w;
  p.in[4] = dout;
  p.out[0] = dr;
  p.out[1] = dk;
  p.out[2] = dv;
  p.out[3] = dw;
  for (int q = 0; q < 9; ++q) {
    p.sb[q] = strides[3 * q];
    p.sh[q] = strides[3 * q + 1];
    p.st[q] = strides[3 * q + 2];
  }
  p.u = u;
  p.ckpt = ckpt;
  p.ds_fin = ds_fin;
  p.scratch = scratch;
  p.du = du;
  p.ds0 = ds0;
  p.heads = heads;
  p.steps = steps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) return dispatch_dim<__nv_bfloat16>(p, batch, head_dim, s);
  return dispatch_dim<float>(p, batch, head_dim, s);
}

// Steps between two checkpoints, as this kernel reads them.
extern "C" int wkv6_bwd_ckpt_steps() { return kChunk; }

// Dynamic shared memory per block for a head_dim (0 if unsupported).
extern "C" int wkv6_bwd_smem_bytes(int head_dim) {
  switch (head_dim) {
    case 16: return sizeof(Smem<16>);
    case 32: return sizeof(Smem<32>);
    case 64: return sizeof(Smem<64>);
    default: return 0;
  }
}

extern "C" const char* wkv6_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

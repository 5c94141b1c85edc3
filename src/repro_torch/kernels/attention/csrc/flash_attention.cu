// Forward flash attention (online softmax) in f32 for NVIDIA Hopper (sm_90a).
//
//   o[b, h, i] = sum_j softmax_j(mask(cap * tanh(q_i . k_j * scale / cap))) v_j
//
// Replaces, for f32 inputs, the Pallas TPU kernel src/repro/kernels/
// attention/kernel.py::_attn_kernel (pallas_call in flash_attention_kernel)
// together with the head repeat and sequence padding of its wrapper
// (ops.py); bf16 inputs go to flash_attention_sm90.cu (tensor cores). Same
// semantics: causal mask q >= k, sliding-window mask q - k < window,
// optional logit softcap, masked logits set to NEG_INF = -1e30 (not -inf),
// f32 running max / denominator / accumulator, kv tiles that are masked for
// the whole q tile skipped, an l == 0 guard, f32 output.
//
// Bound: operations. Per (batch, head) the two products take 4 * Sq * Skv * d
// flops over the live (unmasked) part of the score matrix, against
// (2 * Skv + 2 * Sq) * d elements moved; at repro-100m's prefill (S = 2048,
// d = 64) that is ~500 flops per f32 byte, and f32 products must stay off
// the tensor cores (TF32 cannot meet the f32 bar), so the least time is
// flops / 67 TFLOP/s (f32 outside the tensor cores).
//
// Design (exact and simple):
//   * one block of 256 threads per (batch * head, 64-query tile); it walks
//     the kv tiles of 64 keys in order, keeping Q, K, V and the probability
//     tile P in dynamic shared memory, so every product is an f32 FMA on
//     the CUDA cores -- no TF32;
//   * thread t owns query rows 4 * (t / 16) .. + 3 and, of each row, the
//     score columns t % 16 + 16 j and the output columns t % 16 + 16 c; the
//     16 threads of a row group sit in one half-warp, so the row max and
//     row sum are four xor-shuffles;
//   * Q and K rows are padded to d + 1 floats so the strided K reads of a
//     half-warp fall in distinct banks;
//   * GQA reads kv head h / group in place of repeated k and v; ragged Sq
//     and Skv are masked in the kernel (keys past Skv are NEG_INF, their
//     V rows zero), so the wrapper pads and copies nothing; q, k, v and o
//     are addressed through (batch, head, seq) strides, so the projections'
//     (B, S, H, d) layout is read and written in place;
//   * q tiles are issued last-first, so under the causal mask the longest
//     rows start first.
// Shared memory: 4 * (64 * (d + 1) * 2 + 64 * d + 64 * 65) bytes, 213,760
// at d = 256, above the 48 KB static limit, hence the dynamic-size
// attribute set before each launch.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBlockQ = 64;                 // queries per block
constexpr int kBlockK = 64;                 // keys per kv tile
constexpr int kThreads = 256;
constexpr int kLanes = 16;                  // threads that share a row group
constexpr int kRows = kBlockQ / (kThreads / kLanes);  // rows per thread: 4
constexpr int kCols = kBlockK / kLanes;     // score columns per thread: 4
constexpr int kPStride = kBlockK + 1;
constexpr float kNegInf = -1e30f;

static_assert(kRows * (kThreads / kLanes) == kBlockQ, "row tiling");

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int64_t q_sb, q_sh, q_ss;  // element strides: batch, head, sequence
  int64_t k_sb, k_sh, k_ss;
  int64_t v_sb, v_sh, v_ss;
  int64_t o_sb, o_sh, o_ss;
  int heads;   // query heads
  int group;   // query heads per kv head
  int sq, skv;
  float scale;
  float softcap;  // <= 0: none
  int causal;
  int window;     // <= 0: none
};

__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  }
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, off);
  }
  return x;
}

template <int D>
constexpr int smem_bytes() {
  return 4 * (kBlockQ * (D + 1) + kBlockK * (D + 1) + kBlockK * D +
              kBlockQ * kPStride);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const Params p) {
  constexpr int kQStride = D + 1;
  constexpr int kOutCols = D / kLanes;
  extern __shared__ float smem[];
  float* s_q = smem;                          // kBlockQ x kQStride
  float* s_k = s_q + kBlockQ * kQStride;      // kBlockK x kQStride
  float* s_v = s_k + kBlockK * kQStride;      // kBlockK x D
  float* s_p = s_v + kBlockK * D;             // kBlockQ x kPStride

  const int tid = threadIdx.x;
  const int lane = tid % kLanes;
  const int row0 = (tid / kLanes) * kRows;    // first of this thread's rows
  const int bh = blockIdx.x;
  const int b = bh / p.heads;
  const int h = bh % p.heads;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;

  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* k =
      static_cast<const float*>(p.k) + b * p.k_sb + (h / p.group) * p.k_sh;
  const float* v =
      static_cast<const float*>(p.v) + b * p.v_sb + (h / p.group) * p.v_sh;
  float* o = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;

  for (int i = tid; i < kBlockQ * D; i += kThreads) {
    const int r = i / D;
    const int c = i % D;
    const int qi = q0 + r;
    s_q[r * kQStride + c] =
        qi < p.sq ? q[qi * p.q_ss + c] : 0.0f;
  }

  float m[kRows];
  float l[kRows];
  float acc[kRows][kOutCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kOutCols; ++c) acc[i][c] = 0.0f;
  }

  const int n_tiles = (p.skv + kBlockK - 1) / kBlockK;
  const int last_q = q0 + kBlockQ - 1;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBlockK;
    // tiles masked for the whole q tile (block-uniform conditions)
    if (p.causal && last_q < k0) break;
    if (p.window > 0 && q0 - (k0 + kBlockK - 1) >= p.window) continue;

    __syncthreads();  // the previous tile's readers of s_k / s_v / s_p
    for (int i = tid; i < kBlockK * D; i += kThreads) {
      const int r = i / D;
      const int c = i % D;
      const int kj = k0 + r;
      const bool in = kj < p.skv;
      s_k[r * kQStride + c] = in ? k[kj * p.k_ss + c] : 0.0f;
      s_v[r * D + c] = in ? v[kj * p.v_ss + c] : 0.0f;
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.0f;
    }
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[kRows];
      float kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = s_q[(row0 + i) * kQStride + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        kv[j] = s_k[(lane + j * kLanes) * kQStride + d];
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qi = q0 + row0 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kj = k0 + lane + j * kLanes;
        float x = s[i][j] * p.scale;
        if (p.softcap > 0.0f) x = p.softcap * tanhf(x / p.softcap);
        bool live = kj < p.skv;
        if (p.causal) live = live && qi >= kj;
        if (p.window > 0) live = live && (qi - kj) < p.window;
        x = live ? x : kNegInf;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float pj = expf(s[i][j] - m_new);
        sum += pj;
        s_p[(row0 + i) * kPStride + lane + j * kLanes] = pj;
      }
      l[i] = alpha * l[i] + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kOutCols; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBlockK; ++kk) {
      float pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = s_p[(row0 + i) * kPStride + kk];
#pragma unroll
      for (int c = 0; c < kOutCols; ++c) {
        const float vv = s_v[kk * D + lane + c * kLanes];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qi = q0 + row0 + i;
    if (qi < p.sq) {
      const float inv = 1.0f / (l[i] == 0.0f ? 1.0f : l[i]);
      float* orow = o + qi * p.o_ss;
#pragma unroll
      for (int c = 0; c < kOutCols; ++c) {
        orow[lane + c * kLanes] = acc[i][c] * inv;
      }
    }
  }
}

template <int D>
int launch(const Params& p, int batch, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(batch) * p.heads,
                  (p.sq + kBlockQ - 1) / kBlockQ);
  flash_attention_kernel<D><<<grid, kThreads, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_dim(const Params& p, int batch, int head_dim,
                 cudaStream_t stream) {
  switch (head_dim) {
    case 32: return launch<32>(p, batch, stream);
    case 64: return launch<64>(p, batch, stream);
    case 128: return launch<128>(p, batch, stream);
    case 256: return launch<256>(p, batch, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q: (batch, heads, sq, head_dim), k and v: (batch, heads / group, skv,
// head_dim), o: like q; all f32 on the current device, with unit stride
// along head_dim and the element strides
// `strides` = {q_b, q_h, q_s, k_b, k_h, k_s, v_b, v_h, v_s, o_b, o_h, o_s}.
// softcap <= 0 and window <= 0 mean none. Returns a CUDA error code (0 on
// success): cudaFuncSetAttribute's or cudaGetLastError() after the launch.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, const int64_t* strides, int batch,
                               int heads, int group, int sq, int skv,
                               int head_dim, float scale, float softcap,
                               int causal, int window, void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.q_sb = strides[0];
  p.q_sh = strides[1];
  p.q_ss = strides[2];
  p.k_sb = strides[3];
  p.k_sh = strides[4];
  p.k_ss = strides[5];
  p.v_sb = strides[6];
  p.v_sh = strides[7];
  p.v_ss = strides[8];
  p.o_sb = strides[9];
  p.o_sh = strides[10];
  p.o_ss = strides[11];
  p.heads = heads;
  p.group = group;
  p.sq = sq;
  p.skv = skv;
  p.scale = scale;
  p.softcap = softcap;
  p.causal = causal;
  p.window = window;
  return dispatch_dim(p, batch, head_dim, static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory per block for a head_dim (0 if unsupported).
extern "C" int flash_attention_smem_bytes(int head_dim) {
  switch (head_dim) {
    case 32: return smem_bytes<32>();
    case 64: return smem_bytes<64>();
    case 128: return smem_bytes<128>();
    case 256: return smem_bytes<256>();
    default: return 0;
  }
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

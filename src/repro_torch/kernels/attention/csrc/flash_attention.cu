// Forward flash attention (online softmax) in f32 for NVIDIA Hopper (sm_90a),
// every product an f32 FMA on the CUDA cores.
//
//   o[b, h, i] = sum_j softmax_j(mask(cap * tanh(q_i . k_j * scale / cap))) v_j
//
// Replaces, for f32 inputs, the Pallas TPU kernel src/repro/kernels/
// attention/kernel.py::_attn_kernel (kernel.py:29, the pallas_call in
// flash_attention_kernel) together with the head repeat and sequence padding
// of its wrapper (ops.py); bf16 inputs go to flash_attention_sm90.cu (tensor
// cores). Same semantics: causal mask q >= k, sliding-window mask
// q - k < window, optional softcap cap * tanh(x / cap) on the scaled logit,
// masked logits NEG_INF = -1e30 (not -inf), f32 running max / denominator /
// accumulator, kv tiles that are masked for the whole q tile skipped, the
// l == 0 guard, f32 output.
//
// Bound: operations. The two products take 4 * d flops per live (query, key)
// pair: at repro-100m's prefill (4, 10, 2048, 64) 21.5 GFLOP, 0.3207 ms at
// the H100's 67 TFLOP/s f32 rate outside the tensor cores, against 0.025 ms
// for the 84 MB that q, k, v and o move. The products stay off the tensor
// cores: TF32 cannot hold the f32 bar (atol 5e-5 + rtol 1e-4).
//
// Design: one block of 128 threads (4 warps) per (batch * head, q tile of
// 128 queries; 64 at d > 64), the q tiles issued last-first so the causal
// mask's longest rows start first; two blocks per SM at d <= 64.
//   * register tiles: thread (row group r of 16, lane c of 8) holds query
//     rows r + 16 i (i < 8; i < 4 at d > 64) against keys c + 8 j (j < 8;
//     j < 4 at d = 256, where the kv tile is 32 keys) for S, and the same
//     rows against output columns 4 c + 32 u (u < d / 32, four at a time)
//     for O. The 8 lanes of a row sit in one warp, so its max and sum are
//     three xor-shuffles;
//   * 128-bit shared loads: both products walk their depth in chunks of 4
//     and read every operand as a float4 (LDS.128). A warp's LDS.128 takes
//     4 SM cycles when a quarter-warp reads 4 or more addresses and 2 when
//     each reads at most 2 (tools/lds128_cost.cu), so shared memory feeds
//     at most 32 distinct floats a cycle against 128 FMAs: a product keeps
//     up only with 4 FMAs per float loaded, hence the 8 x 8 tiles (per
//     chunk, 16 loads for 256 FMAs in each product). The 8 lanes of a
//     quarter-warp read the same Q and P rows (2 cycles) and 8 distinct K
//     rows or 128 contiguous bytes of a V row (4 cycles). Q, K and V rows
//     are padded to d + 4 floats and P rows to kBlockK + 8, so rows start
//     16-byte aligned and those 8 K rows, like the 32 P stores of a warp,
//     fall in distinct banks;
//   * P stays in shared memory between the two products, row-major, so PV
//     reads it as float4 along the keys;
//   * cp.async staging: the K and V tiles flow through a ring of 2 stages,
//     K_t, V_t, K_{t+1}, ...: V_t is issued when tile t opens and lands
//     during S_t and the softmax, K_{t+1} is issued once S_t is done and
//     lands during P_t V_t; Q is loaded once, with K of the first tile. Two
//     __syncthreads per tile, each after the wait for the copy it
//     publishes: one opens the tile (K_t landed, PV of t - 1 done, so V's
//     stage and P are free), one publishes P and V_t (S_t done, so K's
//     stage is free). Rows past Sq or Skv are zero-filled by the copy
//     (src-size 0). A view whose base address or (batch, head, seq)
//     strides are not multiples of 16 bytes takes the 4-byte copy of the
//     same kernel (kVec16 false; the wrapper chooses, kernel.copy_bytes);
//     the arithmetic, hence every bit of the output, is the same;
//   * masks: the causal, window and sequence-end masks are computed only
//     on a tile that one of them crosses (a block-uniform test), and the
//     softcap is tested once per tile, not at every logit (softmax_tile's
//     template flags). tools/f32_attention_levers.py times each lever of
//     this design against the variant without it;
//   * exponentials: logits stay in q.k units and p = exp2(x * c - m * c),
//     c = scale * log2(e) (log2(e) on the capped logit under a softcap), is
//     one FMA and one exp2; a row that holds NEG_INF alone takes c = 0, so
//     its terms are exp(0) = 1 as in the reference;
//   * GQA reads kv head h / group; ragged Sq and Skv are masked in the
//     kernel; q, k, v and o are addressed through (batch, head, seq)
//     strides, so the projections' (B, S, H, d) layout is read and written
//     in place;
//   * the row log-sum-exp, when asked for (a non-null lse): the epilogue
//     writes lse = m * scale + ln l (m + ln l under a softcap, where m is
//     the capped logit) from the row state it already holds, in f32, one
//     value a row of (batch * head, sq), the residual the flash backward
//     reads (src/repro/models/flash_vjp.py:102-107). A row that holds
//     NEG_INF alone writes NEG_INF + ln l = NEG_INF, as the plain version's
//     logsumexp of its masked row. A null lse writes nothing: the launch
//     keeps its grid and the output its bits.
// Rounding against the plain version: d is summed by sequential FMAs, the
// online softmax rescales per kv tile, and exp2 of the folded FMA replaces
// exp of (x * scale - m); held to the f32 bar on the CPU by an emulation
// (tests/test_torch_attention.py, _f32_numerics) and on the card.
// Shared memory: 4 * (kBlockQ * (d + 4) + 2 * kBlockK * (d + 4) +
// kBlockQ * (kBlockK + 8)) bytes: 73,728 / 106,496 / 119,808 / 143,360 at
// d = 32 / 64 / 128 / 256, above the 48 KB static limit, hence the
// dynamic-size attribute set before each launch.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kRowGroups = 16;   // threads along the queries
constexpr int kLanes = 8;        // threads along the keys (one row's lanes)
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

static_assert(kRowGroups * kLanes == kThreads, "thread grid");

// Per head_dim: thread tiles, block tiles and the shared-memory layout.
// Q, then the ring's two stages (the K tile, the V tile), then P.
template <int D>
struct Tile {
  static constexpr int kRows = D <= 64 ? 8 : 4;     // query rows per thread
  static constexpr int kKeys = D == 256 ? 4 : 8;    // keys per thread
  static constexpr int kBlockQ = kRowGroups * kRows;
  static constexpr int kBlockK = kLanes * kKeys;    // keys per kv tile
  static constexpr int kVecs = D / (4 * kLanes);    // float4 of O per row
  static constexpr int kStride = D + 4;             // Q, K, V row (floats)
  static constexpr int kPStride = kBlockK + 8;      // P row (floats)
  static constexpr int kQ = kBlockQ * kStride;
  static constexpr int kKV = kBlockK * kStride;     // one ring stage
  static constexpr int kSmem = 4 * (kQ + 2 * kKV + kBlockQ * kPStride);
  static_assert(kVecs >= 1 && D % (4 * kLanes) == 0, "head_dim");
};

struct Params {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  float* lse;  // (batch * heads, sq) row log-sum-exp, or null: none
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

// Asynchronous global -> shared copy of 16 or 4 bytes; src_bytes 0
// zero-fills the destination (rows past the sequence).
template <bool kVec16>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool in) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if constexpr (kVec16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(in ? 16 : 0)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(in ? 4 : 0)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Issue the copy of rows r0 .. r0 + kTileRows - 1 of a (seq, D) slab with
// row stride `ss` (elements) into shared rows of D + 4 floats; rows at or
// past n arrive as zeros. The loop is kept rolled, so the copies'
// addresses take no registers across the tile's products.
template <int D, int kTileRows, bool kVec16>
__device__ __forceinline__ void load_rows(float* s, const float* g,
                                          int64_t ss, int r0, int n,
                                          int tid) {
  constexpr int kWidth = kVec16 ? 4 : 1;      // floats per copy
  constexpr int kPerRow = D / kWidth;
#pragma unroll 1
  for (int i = tid; i < kTileRows * kPerRow; i += kThreads) {
    const int r = i / kPerRow;
    const int c = (i % kPerRow) * kWidth;
    const bool in = r0 + r < n;
    cp_async<kVec16>(s + r * Tile<D>::kStride + c,
                     in ? g + (r0 + r) * ss + c : g, in);
  }
}

// The online softmax of one tile over a thread's rows (row0 + kRowGroups i)
// and keys (key0 + kLanes j): the softcap (kCap), the masks (kMask: only on
// tiles a mask crosses), each row's max and sum over its kLanes lanes, the
// rescale of l and O, and P to shared memory (row i at p_base +
// i * p_stride, key j at + kLanes j).
template <bool kCap, bool kMask, int kRows, int kN, int kAcc>
__device__ __forceinline__ void softmax_tile(
    float (&s)[kRows][kN], float (&m)[kRows], float (&l)[kRows],
    float (&acc)[kRows][kAcc], float* p_base, int p_stride, const Params& p,
    float c, int row0, int key0) {
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qi = row0 + kRowGroups * i;
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      float x = s[i][j];
      if (kCap) x = p.softcap * tanhf(x * p.scale / p.softcap);
      if (kMask) {
        const int kj = key0 + kLanes * j;
        bool live = kj < p.skv;
        if (p.causal) live = live && qi >= kj;
        if (p.window > 0) live = live && (qi - kj) < p.window;
        x = live ? x : kNegInf;
      }
      s[i][j] = x;
      mx = fmaxf(mx, x);
    }
    const float m_new = fmaxf(m[i], row_max(mx));
    const float alpha = exp2f((m[i] - m_new) * c);
    const float cr = m_new == kNegInf ? 0.0f : c;
    const float mc = m_new * cr;
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      const float pj = exp2f(fmaf(s[i][j], cr, -mc));
      sum += pj;
      p_base[i * p_stride + kLanes * j] = pj;
    }
    l[i] = alpha * l[i] + row_sum(sum);
    m[i] = m_new;
#pragma unroll
    for (int e = 0; e < kAcc; ++e) acc[i][e] *= alpha;
  }
}

template <int D, bool kVec16>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const Params p) {
  using T = Tile<D>;
  constexpr int kRows = T::kRows;
  constexpr int kN = T::kKeys;
  constexpr int kBlockQ = T::kBlockQ;
  constexpr int kBlockK = T::kBlockK;
  constexpr int kV = T::kVecs;
  constexpr int kS = T::kStride;
  constexpr int kPS = T::kPStride;
  extern __shared__ __align__(16) float smem[];
  float* s_q = smem;              // kBlockQ x kS
  float* s_k = s_q + T::kQ;       // ring stage 0: the K tiles
  float* s_v = s_k + T::kKV;      // ring stage 1: the V tiles
  float* s_p = s_v + T::kKV;      // kBlockQ x kPS

  const int tid = threadIdx.x;
  const int lane = tid % kLanes;
  const int rg = tid / kLanes;    // row group: rows rg + kRowGroups i
  const int bh = blockIdx.x;
  const int b = bh / p.heads;
  const int h = bh % p.heads;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;

  const float* q = p.q + b * p.q_sb + h * p.q_sh;
  const float* k = p.k + b * p.k_sb + (h / p.group) * p.k_sh;
  const float* v = p.v + b * p.v_sb + (h / p.group) * p.v_sh;
  float* o = p.o + b * p.o_sb + h * p.o_sh;

  // the kv tiles this q tile needs: the causal mask ends them, the window
  // starts them (tiles masked for every row of the q tile are skipped)
  int t_end = (p.skv + kBlockK - 1) / kBlockK;
  if (p.causal) t_end = min(t_end, (q0 + kBlockQ - 1) / kBlockK + 1);
  int t_begin = 0;
  if (p.window > 0) {
    const int x0 = q0 - p.window - kBlockK + 1;
    if (x0 >= 0) t_begin = x0 / kBlockK + 1;
  }

  load_rows<D, kBlockQ, kVec16>(s_q, q, p.q_ss, q0, p.sq, tid);
  if (t_begin < t_end) {
    load_rows<D, kBlockK, kVec16>(s_k, k, p.k_ss, t_begin * kBlockK, p.skv,
                                  tid);
  }
  cp_async_commit();

  // logits stay in q.k units (the capped logit under a softcap); c takes
  // them to log2 units inside exp2's FMA
  const float c = p.softcap > 0.0f ? kLog2e : p.scale * kLog2e;
  float m[kRows];
  float l[kRows];
  float acc[kRows][4 * kV];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int e = 0; e < 4 * kV; ++e) acc[i][e] = 0.0f;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * kBlockK;
    cp_async_wait_all();  // this thread's copies of K_t have landed
    __syncthreads();      // everyone's have; PV of t - 1 is done
    load_rows<D, kBlockK, kVec16>(s_v, v, p.v_ss, k0, p.skv, tid);
    cp_async_commit();    // V_t lands during S and the softmax

    // S = Q K^T over this thread's rows and keys, d in chunks of 4
    float s[kRows][kN];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
#pragma unroll
      for (int j = 0; j < kN; ++j) s[i][j] = 0.0f;
    }
    const float* q_base = s_q + rg * kS;
    const float* k_base = s_k + lane * kS;
#pragma unroll 1
    for (int d = 0; d < D; d += 4) {
      float4 qf[kRows];
      float4 kf[kN];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        qf[i] = *reinterpret_cast<const float4*>(q_base +
                                                 kRowGroups * i * kS + d);
      }
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        kf[j] = *reinterpret_cast<const float4*>(k_base + 8 * j * kS + d);
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
#pragma unroll
        for (int j = 0; j < kN; ++j) {
          s[i][j] = fmaf(qf[i].x, kf[j].x, s[i][j]);
          s[i][j] = fmaf(qf[i].y, kf[j].y, s[i][j]);
          s[i][j] = fmaf(qf[i].z, kf[j].z, s[i][j]);
          s[i][j] = fmaf(qf[i].w, kf[j].w, s[i][j]);
        }
      }
    }

    // online softmax; P to shared memory. Masks are computed only on a
    // tile that the causal diagonal, the window's edge or the end of the
    // keys crosses (a block-uniform test)
    const bool edge = k0 + kBlockK > p.skv ||
                      (p.causal && k0 + kBlockK - 1 > q0) ||
                      (p.window > 0 && q0 + kBlockQ - 1 - k0 >= p.window);
    float* p_out = s_p + rg * kPS + lane;
    if (p.softcap > 0.0f) {
      if (edge) {
        softmax_tile<true, true>(s, m, l, acc, p_out, kRowGroups * kPS, p,
                                 c, q0 + rg, k0 + lane);
      } else {
        softmax_tile<true, false>(s, m, l, acc, p_out, kRowGroups * kPS, p,
                                  c, q0 + rg, k0 + lane);
      }
    } else if (edge) {
      softmax_tile<false, true>(s, m, l, acc, p_out, kRowGroups * kPS, p, c,
                                q0 + rg, k0 + lane);
    } else {
      softmax_tile<false, false>(s, m, l, acc, p_out, kRowGroups * kPS, p,
                                 c, q0 + rg, k0 + lane);
    }
    cp_async_wait_all();  // this thread's copies of V_t have landed
    __syncthreads();      // everyone's have, P is written, S is done
    if (t + 1 < t_end) {
      load_rows<D, kBlockK, kVec16>(s_k, k, p.k_ss, k0 + kBlockK, p.skv,
                                    tid);
    }
    cp_async_commit();    // K_{t+1} lands during PV

    // O += P V over this thread's rows and columns, keys in chunks of 4
    const float* p_base = s_p + rg * kPS;
    const float* v_base = s_v + 4 * lane;
#pragma unroll 1
    for (int kk = 0; kk < kBlockK; kk += 4) {
      float4 pf[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        pf[i] = *reinterpret_cast<const float4*>(p_base +
                                                 kRowGroups * i * kPS + kk);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float4 vf[kV];
#pragma unroll
        for (int u = 0; u < kV; ++u) {
          vf[u] = *reinterpret_cast<const float4*>(v_base + (kk + e) * kS +
                                                   32 * u);
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const float pe = e == 0 ? pf[i].x
                           : e == 1 ? pf[i].y
                           : e == 2 ? pf[i].z
                                    : pf[i].w;
#pragma unroll
          for (int u = 0; u < kV; ++u) {
            acc[i][4 * u + 0] = fmaf(pe, vf[u].x, acc[i][4 * u + 0]);
            acc[i][4 * u + 1] = fmaf(pe, vf[u].y, acc[i][4 * u + 1]);
            acc[i][4 * u + 2] = fmaf(pe, vf[u].z, acc[i][4 * u + 2]);
            acc[i][4 * u + 3] = fmaf(pe, vf[u].w, acc[i][4 * u + 3]);
          }
        }
      }
    }
  }
  cp_async_wait_all();  // nothing may land after the block exits

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qi = q0 + rg + kRowGroups * i;
    if (qi < p.sq) {
      const float inv = 1.0f / (l[i] == 0.0f ? 1.0f : l[i]);
      float* orow = o + qi * p.o_ss + 4 * lane;
#pragma unroll
      for (int u = 0; u < kV; ++u) {
        const float4 r = make_float4(
            acc[i][4 * u] * inv, acc[i][4 * u + 1] * inv,
            acc[i][4 * u + 2] * inv, acc[i][4 * u + 3] * inv);
        if constexpr (kVec16) {
          *reinterpret_cast<float4*>(orow + 32 * u) = r;
        } else {
          orow[32 * u] = r.x;
          orow[32 * u + 1] = r.y;
          orow[32 * u + 2] = r.z;
          orow[32 * u + 3] = r.w;
        }
      }
      if (p.lse != nullptr && lane == 0) {
        const float mx = m[i] == kNegInf ? kNegInf
                         : p.softcap > 0.0f ? m[i] : m[i] * p.scale;
        p.lse[static_cast<int64_t>(bh) * p.sq + qi] =
            mx + logf(l[i] == 0.0f ? 1.0f : l[i]);
      }
    }
  }
}

template <int D, bool kVec16>
int launch(const Params& p, int batch, cudaStream_t stream) {
  constexpr int bytes = Tile<D>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<D, kVec16>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(batch) * p.heads,
                  (p.sq + Tile<D>::kBlockQ - 1) / Tile<D>::kBlockQ);
  flash_attention_kernel<D, kVec16><<<grid, kThreads, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <bool kVec16>
int dispatch_dim(const Params& p, int batch, int head_dim,
                 cudaStream_t stream) {
  switch (head_dim) {
    case 32: return launch<32, kVec16>(p, batch, stream);
    case 64: return launch<64, kVec16>(p, batch, stream);
    case 128: return launch<128, kVec16>(p, batch, stream);
    case 256: return launch<256, kVec16>(p, batch, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q: (batch, heads, sq, head_dim), k and v: (batch, heads / group, skv,
// head_dim), o: like q; all f32 on the current device, with unit stride
// along head_dim and the element strides
// `strides` = {q_b, q_h, q_s, k_b, k_h, k_s, v_b, v_h, v_s, o_b, o_h, o_s}.
// softcap <= 0 and window <= 0 mean none. lse, when not null, receives
// the f32 row log-sum-exp (batch * heads, sq), contiguous. copy_bytes picks the kernel's
// copy width (the wrapper chooses, kernel.copy_bytes): 16 needs
// 16-byte-aligned base addresses and strides that are multiples of 4
// elements wherever the dimension is longer than 1, 4 takes any such view.
// Returns a CUDA error code (0 on success): cudaErrorInvalidValue for an
// unsupported head_dim or copy width, else cudaFuncSetAttribute's or
// cudaGetLastError() after the launch.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, const int64_t* strides, int batch,
                               int heads, int group, int sq, int skv,
                               int head_dim, float scale, float softcap,
                               int causal, int window, void* stream,
                               int copy_bytes, void* lse) {
  Params p;
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.o = static_cast<float*>(o);
  p.lse = static_cast<float*>(lse);
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (copy_bytes) {
    case 16: return dispatch_dim<true>(p, batch, head_dim, s);
    case 4: return dispatch_dim<false>(p, batch, head_dim, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Dynamic shared memory per block for a head_dim (0 if unsupported).
extern "C" int flash_attention_smem_bytes(int head_dim) {
  switch (head_dim) {
    case 32: return Tile<32>::kSmem;
    case 64: return Tile<64>::kSmem;
    case 128: return Tile<128>::kSmem;
    case 256: return Tile<256>::kSmem;
    default: return 0;
  }
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Forward flash attention in bf16 for NVIDIA Hopper (sm_90a): both products
// on the tensor cores (wgmma), K and V streamed by TMA through a ring of
// shared-memory stages.
//
//   o[b, h, i] = sum_j softmax_j(mask(cap * tanh(q_i . k_j * scale / cap))) v_j
//
// Replaces, for bf16 inputs, the Pallas TPU kernel
// src/repro/kernels/attention/kernel.py::_attn_kernel (kernel.py:29, the
// pallas_call in flash_attention_kernel) together with the head repeat and
// sequence padding of its wrapper (ops.py). flash_attention.cu keeps the f32
// inputs on the CUDA cores. Same semantics: causal mask q >= k, window mask
// q - k < window, optional logit softcap, masked logits NEG_INF = -1e30 (not
// -inf), f32 running max / sum / accumulator, kv tiles masked for the whole
// q tile skipped, the l == 0 guard, bf16 output.
//
// Bound: operations. The two products take 4 * d flops per live (query, key)
// pair: at olmo-1b's prefill (4, 16, 2048, 128) 68.7 GFLOP, 0.0695 ms at the
// H100's 989 TFLOP/s bf16 tensor-core rate, against 0.0101 ms for the
// 33.6 MB that q, k, v and o move.
//
// Design:
//   * persistent: one block of 384 threads per SM walks work items (a
//     128-query tile of one batch * head), the causal mask's longest first,
//     in snake order over the blocks; the next item's Q and K/V load while
//     the current one's epilogue stores O;
//   * two consumer warpgroups of 64 query rows each (wgmma's M) and a
//     producer warpgroup, one thread of which issues every load; the
//     producer gives its registers to the consumers (setmaxnreg 24 / 240:
//     the registers come from the block's own pool, 128 * (168 - 24) =
//     256 * (240 - 168));
//   * q, k and v are 4-D TMA tensors (d, S, H, B) over the caller's
//     strides, so the projections' (B, S, H, d) memory is read in place;
//     boxes of 64 columns (128 bytes; 32 columns, 64 bytes at d = 32) land
//     swizzled in shared memory in the mode the wgmma descriptors name;
//     rows past S arrive as zeros;
//   * Q has a full and an empty barrier; K and V tiles of 128 keys (64 at
//     d = 256) flow through a ring of 3 stages (2 at d = 256), K and V of a
//     stage each with a full barrier (the TMA bytes) and an empty barrier
//     (the 256 consumer threads), so K is handed back a product before V;
//   * S = Q K^T: wgmma m64nNk16 with both operands in shared memory
//     (K-major), f32 accumulator in registers. Online softmax on that
//     fragment: each row lies in a quad of threads, so its max and sum are
//     two xor-shuffles; softcap (a template parameter) and masks from each
//     element's (row, column); logits stay in their own units and
//     exp2(x * c - m * c), c = scale * log2(e) (log2(e) under a softcap),
//     is one FMA and one MUFU;
//   * O += P V: P is converted to bf16 in place, since the accumulator
//     layout of S is wgmma's A register layout for P; V is read MN-major
//     from shared memory; O stays in f32 registers, is divided by l and
//     stored as bf16;
//   * overlap: tile t's QK^T is issued with tile t-1's PV behind it, so a
//     warpgroup's softmax of t runs while its PV of t-1 is on the tensor
//     cores; ping-pong: the two warpgroups take turns to issue their
//     products (named barriers 1 and 2), so one's softmax also runs under
//     the other's products;
//   * GQA reads kv head h / group;
//   * the row log-sum-exp, when asked for (a non-null lse): the epilogue
//     writes lse = m * scale + ln l (m + ln l under a softcap, where m is
//     the capped logit), the convention of flash_attention.cu, from the
//     row state its quad already holds (m is the quad's max, l is reduced
//     across the quad for the division), one f32 value a row of (batch *
//     head, sq), the residual the flash backward reads
//     (src/repro/models/flash_vjp.py:102-107). The lane holding the row's
//     first column writes it; rows past sq are not written. A row that
//     holds NEG_INF alone writes NEG_INF + ln l = NEG_INF, as the plain
//     version's logsumexp of its masked row. m and l are this thread's
//     registers, reset only after the store, so the next work item's loads
//     (the producer's) cannot touch them. A null lse writes nothing: the
//     launch and the output keep their bits.
// Rounding: P is rounded to bf16 before the PV product, the one rounding
// the reference does not make (it keeps P in f32); the row sum l is taken
// over the unrounded P. Held to the reference's bf16 bar (atol 3e-2).
// Registers: ptxas gives the consumers setmaxnreg's 240 only while no
// barrier wait carries a timed trap (one kept them at the 168 of the launch
// and spilled d = 256); the SASS then uses at most ~190 (d = 128) and ~210
// (d = 256) without spills, every product's wgmmas issued back to back.
// Shared memory: 2 * 128 * d (Q) + 2 * stages * 2 * kBlockK * d (K, V)
// bytes plus barriers and 1 KB of alignment: 230,512 at d = 128, 197,712 at
// d = 256.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBlockQ = 128;                // queries per block
constexpr int kConsumerThreads = 256;       // two warpgroups
constexpr int kThreads = kConsumerThreads + 128;  // and the producer's
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Tile {
  static constexpr int kBlockK = D == 256 ? 64 : 128;   // keys per kv tile
  static constexpr int kStages = D == 256 ? 2 : 3;      // K/V ring depth
  static constexpr int kBoxCols = D < 64 ? D : 64;      // columns per box
  static constexpr int kBoxes = D / kBoxCols;
  static constexpr int kRowBytes = kBoxCols * 2;        // one row of a box
  // wgmma layout type of the swizzle: 1 = 128-byte, 2 = 64-byte
  static constexpr uint64_t kLayout = kRowBytes == 128 ? 1 : 2;
  static constexpr int kQBytes = kBlockQ * D * 2;
  static constexpr int kKVBytes = kBlockK * D * 2;      // one K or V tile
  static constexpr int kBarOffset = kQBytes + 2 * kStages * kKVBytes;
  static constexpr int kSmem = kBarOffset + 8 * (2 + 4 * kStages) + 1024;
  static_assert(kSmem <= 232448, "shared memory of one block");
};

struct Params {
  __nv_bfloat16* o;
  int64_t o_sb, o_sh, o_ss;  // element strides of o: batch, head, sequence
  int batch_heads;  // batch * query heads
  int heads;        // query heads
  int group;        // query heads per kv head
  int sq, skv;
  float scale;
  float softcap;  // <= 0: none
  int causal;
  int window;     // <= 0: none
  float* lse;     // (batch * heads, sq) row log-sum-exp, or null: none
};

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Waits until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// One box of a 4-D tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units) and the swizzle layout type.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits until at most N of this warpgroup's commit groups are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns across the fence / wait around it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// Named barriers 1 and 2 order the two consumer warpgroups' products.
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(kConsumerThreads)
               : "memory");
}

__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(kConsumerThreads)
               : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D(64 x 64, f32) (+)= A(64 x 16) B(16 x 64); A and B bf16 in shared memory,
// both K-major. scale_d == 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t desc_a,
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D(64 x 128, f32) (+)= A(64 x 16) B(16 x 128); A and B bf16 in shared memory,
// both K-major. scale_d == 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t desc_a,
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D(64 x 32, f32) += A(64 x 16) B(16 x 32); A bf16 in registers (the
// accumulator fragment layout), B bf16 in shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs_n32(float* d, const uint32_t* a,
                                              uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D(64 x 64, f32) += A(64 x 16) B(16 x 64); A bf16 in registers (the
// accumulator fragment layout), B bf16 in shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                              uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D(64 x 128, f32) += A(64 x 16) B(16 x 128); A bf16 in registers (the
// accumulator fragment layout), B bf16 in shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                              uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t desc_a,
                                         uint64_t desc_b, int scale_d) {
  static_assert(N == 64 || N == 128, "S tile width");
  if constexpr (N == 64) {
    wgmma_ss_n64(d, desc_a, desc_b, scale_d);
  } else {
    wgmma_ss_n128(d, desc_a, desc_b, scale_d);
  }
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t desc_b) {
  static_assert(N == 32 || N == 64 || N == 128, "O tile width");
  if constexpr (N == 32) {
    wgmma_rs_n32(d, a, desc_b);
  } else if constexpr (N == 64) {
    wgmma_rs_n64(d, a, desc_b);
  } else {
    wgmma_rs_n128(d, a, desc_b);
  }
}

template <int D, bool kSoftcap>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_sm90_kernel(__grid_constant__ const CUtensorMap tq,
                                __grid_constant__ const CUtensorMap tk,
                                __grid_constant__ const CUtensorMap tv,
                                const Params p) {
  using T = Tile<D>;
  constexpr int kStages = T::kStages;
  constexpr int kS = T::kBlockK / 2;  // S fragment: floats per thread
  constexpr int kO = D / 2;           // O fragment: floats per thread
  extern __shared__ uint8_t smem_raw[];
  // TMA's swizzle repeats every 1024 bytes: align the tiles to it
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t s_q = base;
  const uint32_t s_k = base + T::kQBytes;             // + stage * kKVBytes
  const uint32_t s_v = s_k + kStages * T::kKVBytes;   // + stage * kKVBytes
  // barriers: Q full and empty, then per stage K full, V full, K empty,
  // V empty
  const uint32_t bar_q = base + T::kBarOffset;
  const uint32_t bar_q_empty = bar_q + 8;
  auto full_k = [&](int stage) { return bar_q + 16 + 8 * stage; };
  auto full_v = [&](int stage) { return bar_q + 16 + 8 * (kStages + stage); };
  auto empty_k = [&](int stage) {
    return bar_q + 16 + 8 * (2 * kStages + stage);
  };
  auto empty_v = [&](int stage) {
    return bar_q + 16 + 8 * (3 * kStages + stage);
  };

  // Persistent: the block walks work items (a q tile of one batch * head)
  // blockIdx.x, then in snake order, gridDim.x apart, the tiles with the
  // most kv tiles (the last q tiles under the causal mask) first.
  const int n_q_tiles = (p.sq + kBlockQ - 1) / kBlockQ;
  const int n_work = p.batch_heads * n_q_tiles;
  auto work_item = [&](int round) {
    return round * gridDim.x +
           (round % 2 == 0 ? blockIdx.x : gridDim.x - 1 - blockIdx.x);
  };
  // the first q row of a work item and its live kv tiles [t_begin, t_end):
  // the causal break and the window skip of flash_attention.cu
  auto q_start = [&](int w) {
    return (n_q_tiles - 1 - w / p.batch_heads) * kBlockQ;
  };
  auto kv_tiles = [&](int q0, int& t_begin, int& t_end) {
    t_end = (p.skv + T::kBlockK - 1) / T::kBlockK;
    if (p.causal) t_end = min(t_end, (q0 + kBlockQ - 1) / T::kBlockK + 1);
    t_begin = 0;
    if (p.window > 0 && q0 - p.window - T::kBlockK + 1 >= 0) {
      t_begin = (q0 - p.window - T::kBlockK + 1) / T::kBlockK + 1;
    }
  };

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(bar_q, 1);
    mbar_init(bar_q_empty, kConsumerThreads);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty_k(s), kConsumerThreads);
      mbar_init(empty_v(s), kConsumerThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the warpgroup index, broadcast so that ptxas sees a warp-uniform value
  const int role = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (role == 2) {
    // the producer warpgroup: one thread keeps the ring full, K and V of a
    // tile on barriers of their own (K is released a product earlier), and
    // loads the next work item's Q as soon as the last QK^T of the current
    // one has retired
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == kConsumerThreads) {
      int stage = 0;
      uint32_t phase = 0;
      uint32_t q_phase = 0;
      for (int round = 0;; ++round) {
        const int w = work_item(round);
        if (w >= n_work) break;
        const int bh = w % p.batch_heads;
        const int b = bh / p.heads;
        const int h = bh % p.heads;
        const int q0 = q_start(w);
        int t_begin, t_end;
        kv_tiles(q0, t_begin, t_end);
        mbar_wait(bar_q_empty, q_phase ^ 1);
        q_phase ^= 1;
        mbar_expect_tx(bar_q, T::kQBytes);
#pragma unroll
        for (int c = 0; c < T::kBoxes; ++c) {
          tma_load(s_q + c * kBlockQ * T::kRowBytes, &tq, bar_q,
                   c * T::kBoxCols, q0, h, b);
        }
        for (int t = t_begin; t < t_end; ++t) {
          mbar_wait(empty_k(stage), phase ^ 1);
          mbar_expect_tx(full_k(stage), T::kKVBytes);
#pragma unroll
          for (int c = 0; c < T::kBoxes; ++c) {
            tma_load(
                s_k + stage * T::kKVBytes + c * T::kBlockK * T::kRowBytes,
                &tk, full_k(stage), c * T::kBoxCols, t * T::kBlockK,
                h / p.group, b);
          }
          mbar_wait(empty_v(stage), phase ^ 1);
          mbar_expect_tx(full_v(stage), T::kKVBytes);
#pragma unroll
          for (int c = 0; c < T::kBoxes; ++c) {
            tma_load(
                s_v + stage * T::kKVBytes + c * T::kBlockK * T::kRowBytes,
                &tv, full_v(stage), c * T::kBoxCols, t * T::kBlockK,
                h / p.group, b);
          }
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = role;                 // rows 64 * wg .. of a q tile
    const int warp = (tid % 128) / 32;
    const int lane = tid % 32;
    // this thread's rows (row0 and row0 + 8 of the tile) and first column
    // in a group of 8 of the wgmma accumulator fragment
    const int row_in_tile = wg * 64 + warp * 16 + lane / 4;
    const int col0 = 2 * (lane % 4);
    // logits are kept in their own units (q.k, or the capped logit), max
    // and all; c takes them to log2 units inside exp2's FMA
    const float c = kSoftcap ? kLog2e : p.scale * kLog2e;

    float o[kO];
    float m[2];          // running max of the logits
    float l[2];          // this thread's part of the row sum
    float s[kS];         // S of the newest tile, then its P in f32
    uint32_t a[kS / 2];  // P as bf16 pairs for the next PV: wgmma's A
    int row0 = 0;        // this thread's first row in the current work item
    int wg_first = 0;    // the warpgroup's first and last rows
    int wg_last = 0;

    // S = Q K^T of the tile in `stage`, both K-major: a k-step of 16
    // columns is 32 bytes into a swizzled row, the next box after
    // kBoxCols columns. The first k-step overwrites s (scale-d 0), so no
    // other instruction defines a wgmma accumulator. One commit group.
    auto issue_s = [&](int stage) {
      const uint32_t sk = s_k + stage * T::kKVBytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        constexpr int kSteps = T::kBoxCols / 16;
        const int box = kk / kSteps;
        const int within = (kk % kSteps) * 32;
        const uint64_t da = smem_desc(
            s_q + box * kBlockQ * T::kRowBytes + wg * 64 * T::kRowBytes +
                within, 16, 8 * T::kRowBytes, T::kLayout);
        const uint64_t db = smem_desc(
            sk + box * T::kBlockK * T::kRowBytes + within, 16,
            8 * T::kRowBytes, T::kLayout);
        wgmma_ss<T::kBlockK>(s, da, db, kk > 0);
      }
      wgmma_commit();
    };
    // O += P V of the tile in `stage`, V MN-major: 16 keys are 16 swizzled
    // rows; the leading byte offset steps from one box of kBoxCols columns
    // to the next. One commit group.
    auto issue_pv = [&](int stage) {
      const uint32_t sv = s_v + stage * T::kKVBytes;
      constexpr uint32_t kBoxBytes = T::kBlockK * T::kRowBytes;
      fence_regs(o);
      fence_regs(a);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < T::kBlockK / 16; ++kk) {
        const uint32_t v_rows = sv + kk * 16 * T::kRowBytes;
        if constexpr (D == 256) {
          wgmma_rs<128>(o, a + 4 * kk,
                        smem_desc(v_rows, kBoxBytes, 8 * T::kRowBytes,
                                  T::kLayout));
          wgmma_rs<128>(o + 64, a + 4 * kk,
                        smem_desc(v_rows + 2 * kBoxBytes, kBoxBytes,
                                  8 * T::kRowBytes, T::kLayout));
        } else {
          wgmma_rs<D>(o, a + 4 * kk,
                      smem_desc(v_rows, kBoxBytes, 8 * T::kRowBytes,
                                T::kLayout));
        }
      }
      wgmma_commit();
    };
    // Online softmax of s (the kv tile at k0) in place: updates m and l,
    // leaves P (f32) in s and each row's rescale of O in alpha. s[i] lies
    // in row row0 + 8 * ((i >> 1) & 1), column k0 + 8 * (i / 4) + col0 +
    // (i & 1).
    auto softmax = [&](int k0, float(&alpha)[2]) {
      const bool edge = k0 + T::kBlockK > p.skv ||
                        (p.causal && k0 + T::kBlockK - 1 > wg_first) ||
                        (p.window > 0 && wg_last - k0 >= p.window);
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int i = 0; i < kS; ++i) {
        float x = s[i];
        if constexpr (kSoftcap) {
          x = p.softcap * tanhf(x * p.scale / p.softcap);
        }
        if (edge) {
          const int r = row0 + 8 * ((i >> 1) & 1);
          const int c = k0 + 8 * (i / 4) + col0 + (i & 1);
          bool live = c < p.skv;
          if (p.causal) live = live && r >= c;
          if (p.window > 0) live = live && r - c < p.window;
          x = live ? x : kNegInf;
        }
        s[i] = x;
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
      }
      // a row whose live keys have not begun holds NEG_INF alone: its
      // terms are exp(0) = 1, as in the reference (cr = 0 keeps x * c -
      // m * c from rounding to a huge residual there)
      float cr[2];
      float mc[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float v = mx[r];
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
        const float m_new = fmaxf(m[r], v);
        alpha[r] = exp2f((m[r] - m_new) * c);
        m[r] = m_new;
        l[r] *= alpha[r];
        cr[r] = m_new == kNegInf ? 0.0f : c;
        mc[r] = m_new * cr[r];
      }
#pragma unroll
      for (int i = 0; i < kS; ++i) {
        const int r = (i >> 1) & 1;
        s[i] = exp2f(fmaf(s[i], cr[r], -mc[r]));
        l[r] += s[i];
      }
    };
    // P to bf16 in wgmma's A layout: the accumulator layout of S is the A
    // layout of P, so the conversion is in place, pair by pair
    auto convert_p = [&]() {
#pragma unroll
      for (int i = 0; i < kS / 2; ++i) a[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
    };

    // Tile t's QK^T is issued with tile t-1's PV behind it, so t's softmax
    // runs while the tensor cores finish t-1's product; P is converted
    // once that product has retired (its A registers are free). Ping-pong:
    // the warpgroups take turns to issue their products (a turn barrier
    // each, 1 + wg), so one's softmax runs under the other's wgmma.
    if (wg == 1) named_arrive(1);  // warpgroup 0 starts
    int stage = 0;  // the ring stage of the next kv tile
    uint32_t phase = 0;
    uint32_t q_phase = 0;
    for (int round = 0;; ++round) {
      const int w = work_item(round);
      if (w >= n_work) break;
      const int bh = w % p.batch_heads;
      const int q0 = q_start(w);
      int t_begin, t_end;
      kv_tiles(q0, t_begin, t_end);
      row0 = q0 + row_in_tile;
      wg_first = q0 + wg * 64;
      wg_last = wg_first + 63;
#pragma unroll
      for (int i = 0; i < kO; ++i) o[i] = 0.0f;
      m[0] = m[1] = kNegInf;
      l[0] = l[1] = 0.0f;

      mbar_wait(bar_q, q_phase);
      q_phase ^= 1;
      if (t_begin < t_end) {
        float alpha[2];
        int kv_stage = stage;
        uint32_t kv_phase = phase;
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
        mbar_wait(full_k(kv_stage), kv_phase);
        named_sync(1 + wg);
        issue_s(kv_stage);
        named_arrive(2 - wg);
        wgmma_wait<0>();
        fence_regs(s);
        mbar_arrive(empty_k(kv_stage));
        softmax(t_begin * T::kBlockK, alpha);  // O is 0: nothing to rescale
        convert_p();
        for (int t = t_begin + 1; t < t_end; ++t) {
          const int pv_stage = kv_stage;
          const uint32_t pv_phase = kv_phase;
          kv_stage = stage;
          kv_phase = phase;
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
          mbar_wait(full_k(kv_stage), kv_phase);
          named_sync(1 + wg);
          issue_s(kv_stage);
          mbar_wait(full_v(pv_stage), pv_phase);
          issue_pv(pv_stage);
          named_arrive(2 - wg);
          wgmma_wait<1>();  // S done, PV in flight
          fence_regs(s);
          mbar_arrive(empty_k(kv_stage));
          softmax(t * T::kBlockK, alpha);
          wgmma_wait<0>();
          fence_regs(o);
          fence_regs(a);
          mbar_arrive(empty_v(pv_stage));
#pragma unroll
          for (int i = 0; i < kO; ++i) o[i] *= alpha[(i >> 1) & 1];
          convert_p();
        }
        mbar_arrive(bar_q_empty);  // the last QK^T has retired
        mbar_wait(full_v(kv_stage), kv_phase);
        issue_pv(kv_stage);
        wgmma_wait<0>();
        fence_regs(o);
        mbar_arrive(empty_v(kv_stage));
      } else {
        mbar_arrive(bar_q_empty);
      }

      // epilogue (under the next work item's loads)
      const int b = bh / p.heads;
      const int h = bh % p.heads;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float lt = l[r];
        lt += __shfl_xor_sync(0xffffffffu, lt, 1);
        lt += __shfl_xor_sync(0xffffffffu, lt, 2);
        const float inv = 1.0f / (lt == 0.0f ? 1.0f : lt);
        const int row = row0 + 8 * r;
        if (row < p.sq) {
          __nv_bfloat16* orow =
              p.o + b * p.o_sb + h * p.o_sh + row * p.o_ss;
#pragma unroll
          for (int j = 0; j < D / 8; ++j) {
            *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + col0) =
                __floats2bfloat162_rn(o[4 * j + 2 * r] * inv,
                                      o[4 * j + 2 * r + 1] * inv);
          }
          if (p.lse != nullptr && col0 == 0) {
            const float mx = m[r] == kNegInf ? kNegInf
                             : kSoftcap ? m[r] : m[r] * p.scale;
            p.lse[static_cast<int64_t>(bh) * p.sq + row] =
                mx + logf(lt == 0.0f ? 1.0f : lt);
          }
        }
      }
    }
    // take warpgroup 1's last hand-over, so both turn barriers end empty
    if (wg == 0) named_sync(1);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, looked up through the runtime so
// that the library links against the runtime alone.
cudaError_t encode_tiled(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (cached == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || ptr == nullptr) {
      return cudaErrorSymbolNotFound;
    }
    cached = reinterpret_cast<EncodeTiled>(ptr);
  }
  *fn = cached;
  return cudaSuccess;
}

// Error codes above kEncodeError are kEncodeError + the CUresult of a
// refused tensor map; below it, CUDA runtime errors.
constexpr int kEncodeError = 100000;

// (d, S, H, B) tensor map of a (B, H, S, d) bf16 tensor with element
// strides (batch, head, sequence) and unit stride along d; boxes of
// kBoxCols x rows. A dimension of size 1 is never stepped, so its stride
// is replaced by a valid one.
template <int D>
int make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int s,
             int h, int b, const int64_t* strides, int rows) {
  using T = Tile<D>;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(h),
                              static_cast<cuuint64_t>(b)};
  cuuint64_t bytes[3] = {static_cast<cuuint64_t>(strides[2]) * 2,
                         static_cast<cuuint64_t>(strides[1]) * 2,
                         static_cast<cuuint64_t>(strides[0]) * 2};
  cuuint64_t widest = 16;
  for (int i = 0; i < 3; ++i) {
    if (dims[i + 1] > 1 && bytes[i] > widest) widest = bytes[i];
  }
  for (int i = 0; i < 3; ++i) {
    if (dims[i + 1] == 1) bytes[i] = widest;
  }
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(T::kBoxCols),
                             static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      bytes, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      T::kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                          : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kEncodeError + static_cast<int>(res);
}

template <int D, bool kSoftcap>
int launch(const void* q, const void* k, const void* v,
           const int64_t* strides, int batch, int kv_heads, const Params& p,
           cudaStream_t stream) {
  using T = Tile<D>;
  EncodeTiled encode;
  cudaError_t err = encode_tiled(&encode);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap tq, tk, tv;
  int code = make_map<D>(encode, &tq, q, p.sq, p.heads, batch, strides,
                         kBlockQ);
  if (code == 0) {
    code = make_map<D>(encode, &tk, k, p.skv, kv_heads, batch, strides + 3,
                       T::kBlockK);
  }
  if (code == 0) {
    code = make_map<D>(encode, &tv, v, p.skv, kv_heads, batch, strides + 6,
                       T::kBlockK);
  }
  if (code != 0) return code;
  auto kernel = flash_attention_sm90_kernel<D, kSoftcap>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             T::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // persistent: one block per SM (the shared memory allows no second),
  // fewer when there are fewer work items
  int device = 0;
  int sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_work = p.batch_heads * ((p.sq + kBlockQ - 1) / kBlockQ);
  kernel<<<min(n_work, sms), kThreads, T::kSmem, stream>>>(tq, tk, tv, p);
  return static_cast<int>(cudaGetLastError());
}

template <bool kSoftcap>
int dispatch_dim(const void* q, const void* k, const void* v,
                 const int64_t* strides, int batch, int kv_heads,
                 int head_dim, const Params& p, cudaStream_t stream) {
  switch (head_dim) {
    case 32:
      return launch<32, kSoftcap>(q, k, v, strides, batch, kv_heads, p,
                                  stream);
    case 64:
      return launch<64, kSoftcap>(q, k, v, strides, batch, kv_heads, p,
                                  stream);
    case 128:
      return launch<128, kSoftcap>(q, k, v, strides, batch, kv_heads, p,
                                   stream);
    case 256:
      return launch<256, kSoftcap>(q, k, v, strides, batch, kv_heads, p,
                                   stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q: (batch, heads, sq, head_dim), k and v: (batch, heads / group, skv,
// head_dim), o: like q; all bf16 on the current device, with unit stride
// along head_dim, 16-byte-aligned base addresses and element strides
// `strides` = {q_b, q_h, q_s, k_b, k_h, k_s, v_b, v_h, v_s, o_b, o_h, o_s}
// that are multiples of 8 (16 bytes; TMA's rule) wherever the dimension is
// longer than 1. softcap <= 0 and window <= 0 mean none. Returns 0 on
// success, a CUDA error code, or kEncodeError + the CUresult of a refused
// tensor map (flash_attention_sm90_error_string says which). lse, when not
// null, receives the row log-sum-exp: a contiguous f32 (batch * heads, sq)
// buffer.
extern "C" int flash_attention_sm90(const void* q, const void* k,
                                    const void* v, void* o,
                                    const int64_t* strides, int batch,
                                    int heads, int group, int sq, int skv,
                                    int head_dim, float scale, float softcap,
                                    int causal, int window, void* stream,
                                    void* lse) {
  Params p;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.o_sb = strides[9];
  p.o_sh = strides[10];
  p.o_ss = strides[11];
  p.batch_heads = batch * heads;
  p.heads = heads;
  p.group = group;
  p.sq = sq;
  p.skv = skv;
  p.scale = scale;
  p.softcap = softcap;
  p.causal = causal;
  p.window = window;
  p.lse = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (softcap > 0.0f) {
    return dispatch_dim<true>(q, k, v, strides, batch, heads / group,
                              head_dim, p, s);
  }
  return dispatch_dim<false>(q, k, v, strides, batch, heads / group,
                             head_dim, p, s);
}

// Dynamic shared memory per block for a head_dim (0 if unsupported).
extern "C" int flash_attention_sm90_smem_bytes(int head_dim) {
  switch (head_dim) {
    case 32: return Tile<32>::kSmem;
    case 64: return Tile<64>::kSmem;
    case 128: return Tile<128>::kSmem;
    case 256: return Tile<256>::kSmem;
    default: return 0;
  }
}

extern "C" const char* flash_attention_sm90_error_string(int code) {
  if (code >= kEncodeError) {
    return "cuTensorMapEncodeTiled refused a tensor map";
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

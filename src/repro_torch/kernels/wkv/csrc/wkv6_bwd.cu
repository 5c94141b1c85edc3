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
//   dv_t[j] = sum_i dS_t[i][j] k_t[i] + do_t[j] sum_i r_t[i] u[i] k_t[i]
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
// Design. Rows of S and dS are independent: row i's recurrences read only
// w[i], k[i], r[i] and the v and do vectors, so dr, dk, dw and du are
// row-local, and only dv sums across rows.
//   * Row groups across blocks (Split<D>, compile-time per head dim): a
//     block of kWarps warps owns kRows rows of S and dS, and a (batch,
//     head) is kGroups blocks; kLanes lanes share a row, each owning kCols
//     consecutive columns, lane = q * kWarpRows + row, so the 8 lanes of a
//     quarter-warp read the same v and do float4 (a broadcast). D = 64:
//     16 columns a lane, 4 lanes a row, 4 warps, 32 rows a block, 2 blocks
//     a (batch, head): 1,024 blocks at the fused training shape (8, 64,
//     256, 64) and 128 at a transport node's (1, 64, 256, 64), where the
//     first version ran 512 and 64 blocks of 2 warps. 16 columns and not
//     8: a row's sums then need 2 butterfly levels, not 3 (8 columns a
//     lane ran slower on an H100 at both shapes, for all its lower
//     register count).
//   * States on chip, no device-memory scratch: for each 32-step chunk of
//     K3's checkpoints, in reverse, the thread walks its slice of the row
//     forward from the checkpoint once, keeping the state at the start of
//     every sub-chunk of kSub = 8 steps in shared memory (its own slice:
//     no barrier); then, for each sub-chunk in reverse, re-walks its
//     steps keeping each S_{t-1} in registers (kSub x kCols floats) and
//     walks them backward with dS in registers. Every state comes from
//     the forward's own FMA, s = fma(w_i, s, k_i v_j): K3's bits. This
//     removes the first version's scratch (a chunk's states per block in
//     device memory, 4.3 GB of traffic a launch at the training shape)
//     at the cost of the re-walk, 3 flops per (t, i, j) of ~13. kSub = 4
//     halves the registers but doubles the stored starts, and ran slower.
//   * Sums in a fixed order, so runs repeat bit for bit, with no atomics:
//     a row's sums over columns run in order within the thread, then
//     combine over its kLanes lanes by an xor butterfly (a + b is b + a,
//     so every lane holds the same bits); v . do and the block's sum_i r
//     u k are computed once a step per block when the chunk is widened;
//     dv's column sums over a warp's rows by a shuffle reduce-scatter (a
//     balanced tree over the rows, its selects forced to selp: as C++
//     conditionals they became local-memory loads at a computed index),
//     written once per sub-chunk step into shared memory; then, once per
//     sub-chunk (one barrier), over the block's warps in order; then over
//     the kGroups groups in order, and dv = fma(do_j, sum_g sigma_g, that
//     sum), rounded to the model dtype once. This removes the first
//     version's two barriers and 64-deep serial column sum a step.
//   * Across the row groups: each block writes its sub-chunk partials
//     (the sum of its warps for every column, and its sigma_g) to a
//     (kGroups, B, H, T, D + 1) f32 buffer the wrapper allocates, and a
//     second small kernel (wkv6_bwd_dv_sum_kernel) sums them in group
//     order. A thread-block cluster of the kGroups blocks summing through
//     distributed shared memory was slower at every shape timed in turns
//     (its third partial buffer and cluster barriers cost more than ~70 MB
//     of partials through device memory; in f32 it left one block an SM).
//   * A full sub-chunk runs as straight-line code (its steps unrolled,
//     every store unconditional: a lane with no output of its own writes
//     dw again, the same bits as the lane that owns it), so ptxas
//     interleaves one step's shuffles with the next step's FMAs (with the
//     stores behind branches each step was a block of its own, and the
//     kernel ran slower).
//   * Staging: each chunk's block rows of r, k, w and all D of v and do
//     are copied raw by 16-byte cp.async while the chunk before is
//     computed, then widened once to f32 planes, as K3 does; all through
//     the (batch, head, time) strides, so the model's (B, T, H, D) views
//     are read in place (the wrapper copies a view off 16 bytes first).
//   * r, k, w, v, do and the four outputs are addressed through (batch,
//     head, time) strides; du is written per (batch, head) and summed over
//     the batch by the wrapper (u is shared by the batch).
// Registers, spills and dynamic shared memory (ptxas, sm_90a): D = 64
// bf16 255 registers, 93,568 B; f32 254, 107,904 B (two blocks, 8 warps,
// an SM either way); D = 32 bf16 and f32 168, 35,136 B and 42,304 B;
// D = 16 bf16 98, 15,136 B; f32 107, 18,720 B; no spills; the second pass
// 26 registers.
// Measured (NVIDIA H100 80GB HBM3, 700.00 W; tools/wkv6_bwd_ab.py, each
// the mean of 20 launches, in turns against the first version): at (8,
// 64, 256, 64) bf16 0.6733 / 0.6732 ms against 2.2791 / 2.2761 ms, 15.6 %
// of the 0.1052 ms bound; f32 0.7073 / 0.7073 against 2.2849 / 2.2824; at
// (1, 64, 256, 64) bf16 0.1247 / 0.1247 against 0.5989 / 0.5943, 10.5 % of
// its 0.0131 ms bound; f32 0.1283 / 0.1282 against 0.5843 / 0.5884.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kChunk = 32;  // steps between two checkpoints (wkv6.cu's)
constexpr int kSub = 8;     // steps whose states a thread keeps in registers
constexpr int kSubs = kChunk / kSub;

constexpr int ilog2(int x) { return x <= 1 ? 0 : 1 + ilog2(x / 2); }

// Columns of a row per thread, and warps per block, per head dim.
template <int D>
struct Split;
template <>
struct Split<16> {
  static constexpr int kCols = 4, kWarps = 1;
};
template <>
struct Split<32> {
  static constexpr int kCols = 8, kWarps = 2;
};
template <>
struct Split<64> {
  static constexpr int kCols = 16, kWarps = 4;
};

template <int D>
struct Geo {
  static constexpr int kCols = Split<D>::kCols;    // columns a thread owns
  static constexpr int kLanes = D / kCols;         // lanes sharing a row
  static constexpr int kWarpRows = 32 / kLanes;    // rows of a warp
  static constexpr int kWarps = Split<D>::kWarps;
  static constexpr int kRows = kWarps * kWarpRows;  // rows of a block
  static constexpr int kGroups = D / kRows;         // blocks of a (b, h)
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kLevels = ilog2(kWarpRows);  // dv's shuffle levels
  // levels that halve the columns a lane holds, then ones that add
  static constexpr int kScatter =
      ilog2(kCols) < kLevels ? ilog2(kCols) : kLevels;
  static constexpr int kKept = kCols >> kScatter;  // dv columns a lane keeps
  static_assert(kCols % 4 == 0 && D % kCols == 0 && 32 % kLanes == 0 &&
                    D % kRows == 0,
                "row split");
};

struct Params {
  const void* in[5];  // r, k, v, w, do
  void* out[4];       // dr, dk, dv, dw
  int64_t sb[9], sh[9], st[9];  // element strides (batch, head, time):
                                // in[0..4], then out[0..3]
  const float* u;       // (heads, D)
  const float* ckpt;    // (batch * heads, ceil(steps / kChunk), D, D)
  const float* ds_fin;  // (batch * heads, D, D), or null: zeros
  float* du;            // (batch * heads, D)
  float* ds0;           // (batch * heads, D, D), or null: not written
  float* part_dv;       // (kGroups, B H, T, D): dv partials per row group
  float* part_sig;      // (kGroups, B H, T): sum_i r u k per row group
  int heads;
  int steps;
};

template <typename T, int D>
struct Smem {
  static constexpr int kRows = Geo<D>::kRows;
  static constexpr int kPad = 16 / sizeof(T);  // v . do reads rows apart
  alignas(16) T raw_row[3][kChunk][kRows];    // r, k, w of the next chunk
  alignas(16) T raw_col[2][kChunk][D + kPad];  // v, do of the next chunk
  alignas(16) float row[3][kChunk][kRows];    // r, k, w, widened
  alignas(16) float col[2][kChunk][D];        // v, do, widened
  alignas(16) float start[kSubs][kRows][D];   // S at each sub-chunk's start
  // dv partials per warp of a sub-chunk's steps; two buffers: one is
  // written out while the next sub-chunk fills the other
  alignas(16) float part[2][Geo<D>::kWarps][kSub][D];
  float vdo[kChunk];        // v . do per step
  float sig[kChunk];        // sum over the block's rows of r u k per step
  float u[kRows];
};

__device__ __forceinline__ float4 widen4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 widen4(const __nv_bfloat16* p) {
  const __nv_bfloat162* q = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 a = __bfloat1622float2(q[0]);
  const float2 b = __bfloat1622float2(q[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
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

// c ? a : b as a select instruction: written as a C++ conditional over
// two elements of a register array, it compiled to a load from local
// memory at a computed index.
__device__ __forceinline__ float select(bool c, float a, float b) {
  float r;
  asm("{\n.reg .pred p;\nsetp.ne.b32 p, %3, 0;\nselp.f32 %0, %1, %2, p;\n}"
      : "=f"(r)
      : "f"(a), "f"(b), "r"(static_cast<int>(c)));
  return r;
}

__device__ __forceinline__ float shfl_xor(float v, int mask) {
  return __shfl_xor_sync(0xffffffffu, v, mask);
}

// S advanced one step over the thread's columns: s_j = fma(w, s_j, k v_j),
// the forward's (wkv6.cu) FMA, so every recomputed state has its bits.
template <int C>
__device__ __forceinline__ void advance(const float (&s)[C], float (&out)[C],
                                        const float* v, float k, float w) {
#pragma unroll
  for (int a = 0; a < C / 4; ++a) {
    const float4 v4 = *reinterpret_cast<const float4*>(v + 4 * a);
    out[4 * a] = fmaf(w, s[4 * a], k * v4.x);
    out[4 * a + 1] = fmaf(w, s[4 * a + 1], k * v4.y);
    out[4 * a + 2] = fmaf(w, s[4 * a + 2], k * v4.z);
    out[4 * a + 3] = fmaf(w, s[4 * a + 3], k * v4.w);
  }
}

// Sums the warp's rows of p (this lane's kCols partial dv terms) by a
// reduce-scatter over the row bits of the lane: at each level the lanes
// of a pair keep opposite halves and add the partner's copy, so each
// column's sum over the warp's rows is one balanced tree over the rows in
// order; past kScatter levels the pair adds its one column. Leaves
// p[0 .. kKept) holding the columns at `kept_offset`. A level is a
// template instance, so every index into p is a constant (as a loop over
// levels, ptxas kept p in local memory).
template <int D, int kLvl, int kN>
__device__ __forceinline__ void warp_rows_sum(float (&p)[Geo<D>::kCols],
                                              int row) {
  using Gm = Geo<D>;
  if constexpr (kLvl < Gm::kLevels) {
    if constexpr (kLvl < Gm::kScatter) {
      const bool hi = (row >> kLvl) & 1;
#pragma unroll
      for (int a = 0; a < kN / 2; ++a) {
        const float send = select(hi, p[a], p[a + kN / 2]);
        const float keep = select(hi, p[a + kN / 2], p[a]);
        p[a] = keep + shfl_xor(send, 1 << kLvl);
      }
      warp_rows_sum<D, kLvl + 1, kN / 2>(p, row);
    } else {
      p[0] += shfl_xor(p[0], 1 << kLvl);
      warp_rows_sum<D, kLvl + 1, kN>(p, row);
    }
  }
}

// First column (within the lane's kCols) of the kKept that
// warp_rows_sum leaves in a lane of this row.
template <int D>
__device__ __forceinline__ int kept_offset(int row) {
  using Gm = Geo<D>;
  int off = 0;
#pragma unroll
  for (int lvl = 0; lvl < Gm::kScatter; ++lvl) {
    off += ((row >> lvl) & 1) * (Gm::kCols >> (lvl + 1));
  }
  return off;
}

template <typename T, int D>
__global__ void __launch_bounds__(Geo<D>::kThreads)
    wkv6_bwd_kernel(const Params p) {
  using Gm = Geo<D>;
  constexpr int C = Gm::kCols;
  constexpr int Q = Gm::kLanes;
  constexpr int RW = Gm::kWarpRows;
  constexpr int R = Gm::kRows;
  constexpr int G = Gm::kGroups;
  constexpr int NT = Gm::kThreads;
  constexpr int kMine = (3 + Q - 1) / Q;  // of dr, dk, dw, per lane
  extern __shared__ __align__(16) unsigned char smem[];
  Smem<T, D>& sm = *reinterpret_cast<Smem<T, D>*>(smem);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int q = lane / RW;         // which kCols columns of the row
  const int rw = lane % RW;        // the row within the warp
  const int il = warp * RW + rw;   // the row within the block
  const int c0 = q * C;            // first column
  const int g = blockIdx.x % G;    // the row group
  const int bh = blockIdx.x / G;
  const int b = bh / p.heads;
  const int h = bh % p.heads;
  const int i = g * R + il;        // the row of S and dS
  const int steps = p.steps;
  const int n_ckpt = (steps + kChunk - 1) / kChunk;
  const int64_t state = static_cast<int64_t>(bh) * D * D;

  const T* src[5];
#pragma unroll
  for (int x = 0; x < 5; ++x) {
    src[x] = static_cast<const T*>(p.in[x]) + b * p.sb[x] + h * p.sh[x];
  }
  // staged planes: the block's rows of r, k, w; every column of v, do
  const T* const row_src[3] = {src[0] + g * R, src[1] + g * R, src[3] + g * R};
  const int64_t row_st[3] = {p.st[0], p.st[1], p.st[3]};
  const T* const col_src[2] = {src[2], src[4]};
  const int64_t col_st[2] = {p.st[2], p.st[4]};
  // the outputs of dr (0), dk (1) and dw (2) this lane writes; a lane
  // past them writes dw again, the same bits as the lane that owns it, so
  // no store needs a branch
  int mine[kMine];
  T* mine_out[kMine];
  int64_t mine_st[kMine];
#pragma unroll
  for (int f = 0; f < kMine; ++f) {
    mine[f] = min(q + f * Q, 2);
    const int x = mine[f] == 0 ? 5 : (mine[f] == 1 ? 6 : 8);  // its strides
    mine_out[f] = static_cast<T*>(p.out[x - 5]) + b * p.sb[x] +
                  h * p.sh[x] + i;
    mine_st[f] = p.st[x];
  }

  // Stage steps t0 .. t0 + n - 1 into the raw buffers (16-byte copies).
  const auto stage = [&](int t0, int n) {
    constexpr int kPer = 16 / sizeof(T);
    constexpr int kRowCopies = R / kPer;
    constexpr int kColCopies = D / kPer;
#pragma unroll
    for (int x = 0; x < 3; ++x) {
#pragma unroll 1
      for (int e = tid; e < n * kRowCopies; e += NT) {
        const int c = e / kRowCopies;
        const int y = (e % kRowCopies) * kPer;
        cp_async16(&sm.raw_row[x][c][y], row_src[x] + (t0 + c) * row_st[x] + y);
      }
    }
#pragma unroll
    for (int x = 0; x < 2; ++x) {
#pragma unroll 1
      for (int e = tid; e < n * kColCopies; e += NT) {
        const int c = e / kColCopies;
        const int y = (e % kColCopies) * kPer;
        cp_async16(&sm.raw_col[x][c][y], col_src[x] + (t0 + c) * col_st[x] + y);
      }
    }
    cp_async_commit();
  };

  // Widen n staged steps into the f32 planes; v . do and the block's
  // sum_i r u k per step, each in order, one thread a step.
  const auto widen = [&](int n) {
#pragma unroll
    for (int x = 0; x < 3; ++x) {
#pragma unroll 1
      for (int e = tid; e < n * (R / 4); e += NT) {
        const int c = e / (R / 4);
        const int y = (e % (R / 4)) * 4;
        *reinterpret_cast<float4*>(&sm.row[x][c][y]) =
            widen4(&sm.raw_row[x][c][y]);
      }
    }
#pragma unroll
    for (int x = 0; x < 2; ++x) {
#pragma unroll 1
      for (int e = tid; e < n * (D / 4); e += NT) {
        const int c = e / (D / 4);
        const int y = (e % (D / 4)) * 4;
        *reinterpret_cast<float4*>(&sm.col[x][c][y]) =
            widen4(&sm.raw_col[x][c][y]);
      }
    }
#pragma unroll 1
    for (int c = tid; c < n; c += NT) {
      float vdo = 0.0f;
#pragma unroll
      for (int j = 0; j < D; j += 4) {
        const float4 v4 = widen4(&sm.raw_col[0][c][j]);
        const float4 g4 = widen4(&sm.raw_col[1][c][j]);
        vdo = fmaf(v4.x, g4.x, vdo);
        vdo = fmaf(v4.y, g4.y, vdo);
        vdo = fmaf(v4.z, g4.z, vdo);
        vdo = fmaf(v4.w, g4.w, vdo);
      }
      float sig = 0.0f;
#pragma unroll
      for (int y = 0; y < R; y += 4) {
        const float4 r4 = widen4(&sm.raw_row[0][c][y]);
        const float4 k4 = widen4(&sm.raw_row[1][c][y]);
        const float4 u4 = *reinterpret_cast<const float4*>(&sm.u[y]);
        sig = fmaf(r4.x * u4.x, k4.x, sig);
        sig = fmaf(r4.y * u4.y, k4.y, sig);
        sig = fmaf(r4.z * u4.z, k4.z, sig);
        sig = fmaf(r4.w * u4.w, k4.w, sig);
      }
      sm.vdo[c] = vdo;
      sm.sig[c] = sig;
    }
  };

  // the last chunk lands while the row's state is read
  if (steps > 0) {
    const int t0 = (n_ckpt - 1) * kChunk;
    stage(t0, steps - t0);
  }
  const float u_i = p.u[h * D + i];
  if (q == 0) sm.u[il] = u_i;

  float ds[C];  // this lane's columns of row i of dS
#pragma unroll
  for (int a = 0; a < C / 4; ++a) {
    const float4 x = p.ds_fin != nullptr
        ? *reinterpret_cast<const float4*>(p.ds_fin + state + i * D + c0 + 4 * a)
        : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    ds[4 * a] = x.x;
    ds[4 * a + 1] = x.y;
    ds[4 * a + 2] = x.z;
    ds[4 * a + 3] = x.w;
  }
  float du = 0.0f;
  int buf = 0;  // the dv partial buffer the next sub-chunk writes
  const int kept = c0 + kept_offset<D>(rw);  // this lane's kept dv columns

  float sp[kSub][C];  // S_{t-1} of a sub-chunk's steps, this lane's columns

  for (int c = n_ckpt - 1; c >= 0; --c) {
    const int t0 = c * kChunk;
    const int n = min(kChunk, steps - t0);
    const int n_sub = (n + kSub - 1) / kSub;
    cp_async_wait_all();
    __syncthreads();  // the chunk has landed; the last one's readers are done
    widen(n);
    __syncthreads();  // the planes are ready and the raw buffers are free
    if (c > 0) stage(t0 - kChunk, kChunk);

    // walk the chunk forward from its checkpoint, keeping the state at
    // the start of every sub-chunk (this lane's slice of row i)
    {
      float s[C];
      const float* ck = p.ckpt + (static_cast<int64_t>(bh) * n_ckpt + c) * D * D +
                        i * D + c0;
#pragma unroll
      for (int a = 0; a < C / 4; ++a) {
        const float4 x = *reinterpret_cast<const float4*>(ck + 4 * a);
        s[4 * a] = x.x;
        s[4 * a + 1] = x.y;
        s[4 * a + 2] = x.z;
        s[4 * a + 3] = x.w;
      }
#pragma unroll 1
      for (int sb = 0; sb < n_sub; ++sb) {
        float* st = &sm.start[sb][il][c0];
#pragma unroll
        for (int a = 0; a < C / 4; ++a) {
          *reinterpret_cast<float4*>(st + 4 * a) =
              make_float4(s[4 * a], s[4 * a + 1], s[4 * a + 2], s[4 * a + 3]);
        }
        if (sb + 1 == n_sub) break;
#pragma unroll 2
        for (int e = 0; e < kSub; ++e) {
          const int cc = sb * kSub + e;
          advance<C>(s, s, &sm.col[0][cc][c0], sm.row[1][cc][il],
                     sm.row[2][cc][il]);
        }
      }
    }

    // S_{t-1} of sub-chunk sb's steps into sp, from its start
    const auto rewalk = [&](int sb) {
      const int len = min(kSub, n - sb * kSub);
      const float* st = &sm.start[sb][il][c0];
#pragma unroll
      for (int a = 0; a < C / 4; ++a) {
        const float4 x = *reinterpret_cast<const float4*>(st + 4 * a);
        sp[0][4 * a] = x.x;
        sp[0][4 * a + 1] = x.y;
        sp[0][4 * a + 2] = x.z;
        sp[0][4 * a + 3] = x.w;
      }
#pragma unroll
      for (int e = 1; e < kSub; ++e) {
        if (e < len) {
          const int cc = sb * kSub + e - 1;
          advance<C>(sp[e - 1], sp[e], &sm.col[0][cc][c0], sm.row[1][cc][il],
                     sm.row[2][cc][il]);
        }
      }
    };

    rewalk(n_sub - 1);
#pragma unroll 1
    for (int sb = n_sub - 1; sb >= 0; --sb) {
      const int len = min(kSub, n - sb * kSub);
      T* out_sub[kMine];  // this lane's outputs at the sub-chunk's first step
#pragma unroll
      for (int f = 0; f < kMine; ++f) {
        out_sub[f] = mine_out[f] + (t0 + sb * kSub) * mine_st[f];
      }
      // step e of the sub-chunk, dS in registers
      const auto back_step = [&](int e) {
        const int cc = sb * kSub + e;
        const float r_i = sm.row[0][cc][il];
        const float k_i = sm.row[1][cc][il];
        const float w_i = sm.row[2][cc][il];
        const float vdo = sm.vdo[cc];
        float x = 0.0f;  // sum_j do[j] S_{t-1}[i][j]
        float y = 0.0f;  // sum_j dS_t[i][j] v[j]
        float z = 0.0f;  // sum_j dS_t[i][j] S_{t-1}[i][j]
        float pv[C];     // dS_t[i][j] k[i]
#pragma unroll
        for (int a = 0; a < C / 4; ++a) {
          const float4 g4 =
              *reinterpret_cast<const float4*>(&sm.col[1][cc][c0 + 4 * a]);
          const float4 v4 =
              *reinterpret_cast<const float4*>(&sm.col[0][cc][c0 + 4 * a]);
          const float gj[4] = {g4.x, g4.y, g4.z, g4.w};
          const float vj[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
          for (int f = 0; f < 4; ++f) {
            const int j = 4 * a + f;
            x = fmaf(gj[f], sp[e][j], x);
            y = fmaf(ds[j], vj[f], y);
            z = fmaf(ds[j], sp[e][j], z);
            pv[j] = ds[j] * k_i;
            ds[j] = fmaf(w_i, ds[j], r_i * gj[f]);  // now dS_{t-1}
          }
        }
#pragma unroll
        for (int m = RW; m < 32; m <<= 1) {  // over the row's lanes
          x += shfl_xor(x, m);
          y += shfl_xor(y, m);
          z += shfl_xor(z, m);
        }
        const float dr = fmaf(u_i * k_i, vdo, x);
        const float dk = fmaf(r_i * u_i, vdo, y);
        du = fmaf(r_i * k_i, vdo, du);
#pragma unroll
        for (int f = 0; f < kMine; ++f) {
          store(out_sub[f] + e * mine_st[f],
                mine[f] == 0 ? dr : (mine[f] == 1 ? dk : z));
        }
        warp_rows_sum<D, 0, C>(pv, rw);
        // lanes holding the same columns write the same bits
        float* dst = &sm.part[buf][warp][e][kept];
#pragma unroll
        for (int f = 0; f < Gm::kKept; ++f) dst[f] = pv[f];
      };
      if (len == kSub) {  // one block of straight-line code to schedule
#pragma unroll
        for (int e = kSub - 1; e >= 0; --e) back_step(e);
      } else {
#pragma unroll
        for (int e = kSub - 1; e >= 0; --e) {
          if (e < len) back_step(e);
        }
      }

      __syncthreads();  // every warp's partials are written
      if (sb > 0) rewalk(sb - 1);
      // the block's partials over its warps in order, and its sum_i r u k,
      // for the second pass
      const int64_t base =
          (static_cast<int64_t>(g) * (gridDim.x / G) + bh) * steps;
#pragma unroll 1
      for (int o = tid; o < len * D; o += NT) {
        const int e = o / D;
        const int j = o % D;
        float acc = 0.0f;
#pragma unroll
        for (int ww = 0; ww < Gm::kWarps; ++ww) acc += sm.part[buf][ww][e][j];
        const int cc = sb * kSub + e;
        p.part_dv[(base + t0 + cc) * D + j] = acc;
        if (j == 0) p.part_sig[base + t0 + cc] = sm.sig[cc];
      }
      buf ^= 1;
    }
  }

  if (q == 0) p.du[static_cast<int64_t>(bh) * D + i] = du;
  if (p.ds0 != nullptr) {
    float* out = p.ds0 + state + i * D + c0;
#pragma unroll
    for (int a = 0; a < C / 4; ++a) {
      *reinterpret_cast<float4*>(out + 4 * a) =
          make_float4(ds[4 * a], ds[4 * a + 1], ds[4 * a + 2], ds[4 * a + 3]);
    }
  }
}

// The second pass: dv[b, h, t, j] = fma(do_j, sum_g sigma_g,
// sum_g partial_g), each sum in group order; one thread an element.
template <typename T, int D>
__global__ void __launch_bounds__(256) wkv6_bwd_dv_sum_kernel(const Params p,
                                                              int bh_count) {
  constexpr int G = Geo<D>::kGroups;
  const int64_t e = static_cast<int64_t>(blockIdx.x) * 256 + threadIdx.x;
  const int64_t per = static_cast<int64_t>(bh_count) * p.steps;
  if (e >= per * D) return;
  const int j = static_cast<int>(e % D);
  const int64_t bt = e / D;  // bh * steps + t
  const int bh = static_cast<int>(bt / p.steps);
  const int64_t t = bt % p.steps;
  const int b = bh / p.heads;
  const int h = bh % p.heads;
  float acc = 0.0f;
  float sig = 0.0f;
#pragma unroll
  for (int gg = 0; gg < G; ++gg) {
    acc += p.part_dv[(gg * per + bt) * D + j];
    sig += p.part_sig[gg * per + bt];
  }
  const T* dout = static_cast<const T*>(p.in[4]) + b * p.sb[4] + h * p.sh[4];
  T* dv = static_cast<T*>(p.out[2]) + b * p.sb[7] + h * p.sh[7];
  const float gj = load(dout + t * p.st[4] + j);
  store(dv + t * p.st[7] + j, fmaf(gj, sig, acc));
}

template <typename T, int D>
int launch(const Params& p, int batch, cudaStream_t stream) {
  using Gm = Geo<D>;
  constexpr int bytes = sizeof(Smem<T, D>);
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_bwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int bh_count = batch * p.heads;
  wkv6_bwd_kernel<T, D>
      <<<Gm::kGroups * bh_count, Gm::kThreads, bytes, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t elems = static_cast<int64_t>(bh_count) * p.steps * D;
  if (elems > 0) {
    wkv6_bwd_dv_sum_kernel<T, D>
        <<<static_cast<unsigned>((elems + 255) / 256), 256, 0, stream>>>(
            p, bh_count);
  }
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

extern "C" int wkv6_bwd_groups(int head_dim);

// r, k, v, w, dout: (batch, heads, steps, head_dim), all f32 (bf16 = 0) or
// all bf16 (bf16 = 1), unit stride along head_dim; dr, dk, dv, dw: the same
// shape and dtype; `strides` = the (batch, head, time) element strides of
// r, k, v, w, dout, dr, dk, dv, dw in that order (27 values). r, k, v, w
// and dout are staged by 16-byte copies: their base addresses and their
// strides of a dimension longer than 1 must be whole 16 bytes (else
// cudaErrorMisalignedAddress). u: (heads, head_dim) f32; ckpt:
// wkv6_forward's checkpoints of the same call (the state at the start of
// every chunk of wkv6_bwd_ckpt_steps() steps); ds_fin (or null: zeros),
// ds0 (or null: not written): contiguous (batch, heads, head_dim,
// head_dim) f32; du: (batch, heads, head_dim) f32, each (batch, head)'s
// sum over time; part: f32 scratch of wkv6_bwd_groups(head_dim) * batch *
// heads * steps * (head_dim + 1) elements for dv's per-group partials.
// head_dim in {16, 32, 64} (and 16-byte-aligned ckpt, ds_fin and ds0).
// Returns a CUDA error code (0 on success).
extern "C" int wkv6_backward(const void* r, const void* k, const void* v,
                             const void* w, const void* dout, const float* u,
                             const float* ckpt, const float* ds_fin,
                             float* part, void* dr, void* dk, void* dv,
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
  const int64_t elt = bf16 ? 2 : 4;
  const int dims[3] = {batch, heads, steps};
  for (int x = 0; x < 9; ++x) {
    p.sb[x] = strides[3 * x];
    p.sh[x] = strides[3 * x + 1];
    p.st[x] = strides[3 * x + 2];
    if (x < 5) {
      if (reinterpret_cast<uintptr_t>(p.in[x]) % 16 != 0) {
        return static_cast<int>(cudaErrorMisalignedAddress);
      }
      for (int y = 0; y < 3; ++y) {
        if (dims[y] > 1 && strides[3 * x + y] * elt % 16 != 0) {
          return static_cast<int>(cudaErrorMisalignedAddress);
        }
      }
    }
  }
  p.u = u;
  p.ckpt = ckpt;
  p.ds_fin = ds_fin;
  p.du = du;
  p.ds0 = ds0;
  const int64_t part_dv = static_cast<int64_t>(wkv6_bwd_groups(head_dim)) *
                          batch * heads * steps * head_dim;
  p.part_dv = part;
  p.part_sig = part == nullptr ? nullptr : part + part_dv;
  p.heads = heads;
  p.steps = steps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) return dispatch_dim<__nv_bfloat16>(p, batch, head_dim, s);
  return dispatch_dim<float>(p, batch, head_dim, s);
}

// Steps between two checkpoints, as this kernel reads them.
extern "C" int wkv6_bwd_ckpt_steps() { return kChunk; }

// Dynamic shared memory per block for a head_dim and dtype (0 if
// unsupported).
extern "C" int wkv6_bwd_smem_bytes(int head_dim, int bf16) {
  switch (head_dim) {
    case 16: return bf16 ? sizeof(Smem<__nv_bfloat16, 16>) : sizeof(Smem<float, 16>);
    case 32: return bf16 ? sizeof(Smem<__nv_bfloat16, 32>) : sizeof(Smem<float, 32>);
    case 64: return bf16 ? sizeof(Smem<__nv_bfloat16, 64>) : sizeof(Smem<float, 64>);
    default: return 0;
  }
}

// Blocks per (batch, head) at a head_dim (0 if unsupported): the row
// groups whose dv partials the scratch holds.
extern "C" int wkv6_bwd_groups(int head_dim) {
  switch (head_dim) {
    case 16: return Geo<16>::kGroups;
    case 32: return Geo<32>::kGroups;
    case 64: return Geo<64>::kGroups;
    default: return 0;
  }
}

extern "C" const char* wkv6_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

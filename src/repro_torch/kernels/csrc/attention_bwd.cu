// Hand-written CUDA kernels for the backward pass of causal / sliding-window
// self-attention with GQA (csrc/attention.cu is the forward), FlashAttention-2's
// algorithm on Hopper's tensor cores. With p[i, j] = exp(scale q_i·k_j - lse_i)
// on the allowed pairs (0 elsewhere; lse is the forward's per-row
// log-sum-exp), o the forward's output and g = dL/do:
//
//   delta_i  = g_i·o_i
//   dp[i, j] = g_i·v_j,   ds[i, j] = p[i, j] (dp[i, j] - delta_i)
//   dv_j = sum_i p[i, j] g_i,  dk_j = scale sum_i ds[i, j] q_i,
//   dq_i = scale sum_j ds[i, j] k_j
//
// summed over the Hq / Hkv query heads of a key head for dk and dv. A row with
// no allowed key has p = 0 and so zero gradients.
//
// The TPU kernel src/repro/kernels/attention.py::flash_attention
// (pl.pallas_call at :74) has no backward: the reference differentiates its
// chunked jnp twin (src/repro/kernels/ops.py:52-105). This kernel is the
// gradient of the port's forward kernel, which training runs inside a
// torch.autograd.Function (kernels/attention.py::AttentionFn).
//
// What bounds it on the H100: operations. The function needs five products
// of length D per allowed (i, j) pair (q·k, g·v, dv, dk and dq), 10 D
// operations: at Zamba2's training shape (B = 4, H = 32, L = 1024, D = 64,
// causal) 43.0 GFLOP, 0.26 ms at the tensor cores' 3xTF32 rate (165 TFLOP/s
// f32-accurate, tf32x3.cuh), against 0.27 GB of inputs and outputs (0.08 ms
// at 3.35 TB/s).
//
// What the design does. Every product runs as mma.sync.m16n8k8 tf32 with
// each f32 operand split into a TF32 hi and lo (3xTF32: a_lo·b_hi +
// a_hi·b_lo + a_hi·b_hi), 4 warps a block, each warp on 16 rows of M:
// 1. attention_bwd_delta: one warp per row, delta_i by a butterfly.
// 2. attention_bwd_dkdv, one block per (b, key head, 64 keys): keys on M.
//    Each warp owns 16 keys and computes Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ for a
//    tile of query rows; Pᵀ and dSᵀ then sit in the accumulator layout and
//    are the A operands of dV += Pᵀ·dO and dK += dSᵀ·Q without a trip
//    through shared memory (A column t <-> row 2t, column t + 4 <-> row
//    2t + 1, where the accumulator holds them: csrc/attention.cu's P·V).
//    The block walks the query tiles of every query head of its group that
//    can see its keys, so no two blocks write one key and GQA needs no
//    atomics.
// 3. attention_bwd_dq, one block per (b, query head, 64 rows): rows on M;
//    it recomputes S and dP and adds dS·K for the key tiles its rows see.
//    That is seven products a pair, not five. The other route, one pass
//    writing a dQ partial per key tile and folding them in order, moves 16
//    x 34 MB per call at Zamba2's shape with 64-key tiles (0.16-0.32 ms of
//    bytes), more than the two recomputed products cost at the 3xTF32 rate
//    (about 0.10 ms), so this one recomputes.
// The tensor cores' adds truncate (tf32x3.cuh), so a sum over tiles never
// chains through them: each tile's dV, dK (and dQ) part is summed in a fresh
// accumulator, one group of 8·kNG columns at a time, and added on the CUDA
// cores. Tiles of the inner operand (query rows for dK/dV, keys for dQ: 64;
// 32 at D = 80 and 16 at D >= 96, where dK and dV take the registers) load
// by cp.async into two stages, the next tile while this one is multiplied.
// Every tile lives in shared memory in rows of a multiple of 32 words whose
// 16-byte chunks are swizzled (chunk c of row r at c ^ s(r), s(r) = (r & 6)
// ^ 4 (r & 1)): the fragment loads that read a row's dims (float4 of rows
// g, g + 1) and those that read two rows' columns (float4 or float2 of rows
// 2t, 2t + 1) are then both free of bank conflicts. Only tiles inside the
// causal or window band are visited, a warp skips a tile that its 16 rows
// cannot see, masks are tested only on tiles that straddle an edge, and the
// heaviest blocks launch first. Every sum runs in a fixed order and there
// are no atomics: the same bits on every call.
//
// q, k, v and dO, and dq, dk and dv, are at the storage type T (storage.cuh:
// f32, or bf16 in the bf16 instance), converted to f32 as they are loaded (at
// bf16 stored into shared memory as f32, not by cp.async) and rounded once on
// store; o (the forward's output before rounding: csrc/attention.cu's out32
// at bf16), lse and delta are f32.
#include <cstdint>
#include <cuda_runtime.h>

#include "tf32x3.cuh"
#include "storage.cuh"

namespace {

using namespace tf32x3;
using storage::T;
using storage::widen;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // keys of a dK/dV block, query rows of a dQ block
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Shape {
  static constexpr int kBI = D <= 64 ? 64 : D <= 80 ? 32 : 16;  // rows of an inner tile
  static constexpr int kLd = (D + 31) / 32 * 32;   // words a tile row
  static constexpr int kNG = D % 32 ? 2 : 4;       // n-tiles per column load
  static constexpr int kStage = 2 * kBI * kLd + 2 * kBI;
};

// Shared memory of either kernel, in floats: the block's own two tiles and
// two stages of two inner tiles (with lse and delta of the rows in the
// dK/dV kernel). kernels/attention.py::bwd_smem_floats computes the same.
__host__ __device__ constexpr int smem_floats(int D) {
  return 2 * kRows * ((D + 31) / 32 * 32) +
         2 * (2 * (D <= 64 ? 64 : D <= 80 ? 32 : 16) * ((D + 31) / 32 * 32) +
              2 * (D <= 64 ? 64 : D <= 80 ? 32 : 16));
}

// Word of column c of row r in a swizzled tile.
__device__ __forceinline__ int swz(int r, int c) {
  return c ^ ((((r & 6) ^ ((r & 1) << 2))) << 2);
}

template <int D>
__device__ __forceinline__ float4 ld4(const float* tile, int r, int c) {
  return *reinterpret_cast<const float4*>(tile + r * Shape<D>::kLd + swz(r, c));
}

// NG consecutive words of row r from column c (a multiple of NG)
template <int D>
__device__ __forceinline__ void ldng(const float* tile, int r, int c, float (&v)[Shape<D>::kNG]) {
  const float* at = tile + r * Shape<D>::kLd + swz(r, c);
  if constexpr (Shape<D>::kNG == 4) {
    const float4 x = *reinterpret_cast<const float4*>(at);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else {
    const float2 x = *reinterpret_cast<const float2*>(at);
    v[0] = x.x; v[1] = x.y;
  }
}

// rows [r0, r0 + n) of a (L, D) matrix into a swizzled f32 tile, zero past L
template <int D>
__device__ __forceinline__ void load_rows(float* tile, const T* src, int64_t r0, int n,
                                          int64_t L) {
  for (int i = threadIdx.x; i < n * (D / 4); i += kThreads) {
    const int r = i / (D / 4), c = 4 * (i % (D / 4));
    const int64_t row = r0 + r;
    const bool ok = row < L;
    storage::copy4(tile + r * Shape<D>::kLd + swz(r, c), src + (ok ? row : 0) * D + c, ok);
  }
}

// acc[n][.] += A·Bᵀ over the D dims for one warp: A's 16 rows ra, ra + 8 of
// tile `a`, B's rows 8n + g of tile `b` (n < NT); dims 16i + 4t .. + 3 give
// the k-steps 2i, 2i + 1 of both operands.
template <int D, int NT>
__device__ __forceinline__ void rows_product(float (&acc)[NT][4], const float* a, int ra,
                                             const float* b, int g, int t) {
#pragma unroll
  for (int i = 0; i < D / 16; ++i) {
    const float4 x = ld4<D>(a, ra, 16 * i + 4 * t), y = ld4<D>(a, ra + 8, 16 * i + 4 * t);
    const float a0[4] = {x.x, y.x, x.y, y.y}, a1[4] = {x.z, y.z, x.w, y.w};
    uint32_t ah0[4], al0[4], ah1[4], al1[4];
    split4(a0, ah0, al0);
    split4(a1, ah1, al1);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float4 z = ld4<D>(b, 8 * n + g, 16 * i + 4 * t);
      mma3(acc[n], ah0, al0, z.x, z.y);
      mma3(acc[n], ah1, al1, z.z, z.w);
    }
  }
}

// out[qg NG + jj] += A·B for each column group: A is the accumulator tile
// m[NT][4] (column t <-> row 8j + 2t of tile b, t + 4 <-> 8j + 2t + 1), B the
// rows of tile b; each group is summed in a fresh accumulator and added on
// the CUDA cores.
template <int D, int NT>
__device__ __forceinline__ void cols_product(float (&out)[D / 8][4], const float (&m)[NT][4],
                                             const float* b, int g, int t) {
  constexpr int NG = Shape<D>::kNG, W = 8 * NG;
#pragma unroll
  for (int qg = 0; qg < D / W; ++qg) {
    float part[NG][4];
#pragma unroll
    for (int jj = 0; jj < NG; ++jj) part[jj][0] = part[jj][1] = part[jj][2] = part[jj][3] = 0.0f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float pa[4] = {m[j][0], m[j][2], m[j][1], m[j][3]};
      uint32_t ah[4], al[4];
      split4(pa, ah, al);
      float b0[NG], b1[NG];
      ldng<D>(b, 8 * j + 2 * t, qg * W + NG * g, b0);
      ldng<D>(b, 8 * j + 2 * t + 1, qg * W + NG * g, b1);
#pragma unroll
      for (int jj = 0; jj < NG; ++jj) mma3(part[jj], ah, al, b0[jj], b1[jj]);
    }
#pragma unroll
    for (int jj = 0; jj < NG; ++jj) {
#pragma unroll
      for (int e = 0; e < 4; ++e) out[qg * NG + jj][e] += part[jj][e];
    }
  }
}

// rows r (r < L) of an accumulator tile times `mul` to dst (row stride D),
// rounded once to T: thread t holds columns qg·W + 2·NG·t + e of each group.
template <int D>
__device__ __forceinline__ void store_rows(T* dst, const float (&acc)[D / 8][4], int64_t r0,
                                           int64_t L, int t, float mul) {
  constexpr int NG = Shape<D>::kNG, W = 8 * NG;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int64_t row = r0 + 8 * half;
    if (row >= L) continue;
#pragma unroll
    for (int qg = 0; qg < D / W; ++qg) {
      float val[2 * NG];
#pragma unroll
      for (int e = 0; e < 2 * NG; ++e) val[e] = acc[qg * NG + e % NG][2 * half + e / NG] * mul;
#pragma unroll
      for (int e = 0; e < 2 * NG; e += 4)
        storage::store4(dst + row * D + qg * W + 2 * NG * t + e,
                        make_float4(val[e], val[e + 1], val[e + 2], val[e + 3]));
    }
  }
}

__device__ __forceinline__ bool allowed(int64_t i, int64_t j, int64_t L, int causal,
                                        int has_window, int64_t window) {
  return i < L && j < L && (!causal || j <= i) && (!has_window || j > i - window);
}

__global__ void __launch_bounds__(256) attention_bwd_delta(
    float* __restrict__ delta, const float* __restrict__ o, const T* __restrict__ g,
    const int64_t rows, const int D) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float acc = 0.0f;
  if (row < rows)
    for (int d = lane; d < D; d += 32) acc += widen(g[row * D + d]) * o[row * D + d];
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) acc += __shfl_xor_sync(kFull, acc, off);
  if (row < rows && lane == 0) delta[row] = acc;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2) attention_bwd_dkdv(
    T* __restrict__ dk, T* __restrict__ dv, const T* __restrict__ q,
    const T* __restrict__ k, const T* __restrict__ v, const T* __restrict__ g,
    const float* __restrict__ lse, const float* __restrict__ delta, const int Hkv,
    const int rep, const int64_t L, const int causal, const int has_window,
    const int64_t window, const float scale) {
  using S = Shape<D>;
  constexpr int BI = S::kBI, LD = S::kLd, NT = BI / 8;
  extern __shared__ float smem[];
  float* const Ks = smem;
  float* const Vs = Ks + kRows * LD;
  float* const stages = Vs + kRows * LD;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t = lane & 3;
  const int bkv = blockIdx.x;
  const int64_t k0 = static_cast<int64_t>(blockIdx.y) * kRows;  // key tile 0 (heaviest) first
  const int64_t b = bkv / Hkv;
  const int hkv = bkv % Hkv;
  const int64_t kv = static_cast<int64_t>(bkv) * L * D;
  const int64_t kk0 = k0 + 16 * warp;  // this warp's keys kk0 .. kk0 + 15
  // rows that can see a key of this block: [i_lo, i_hi)
  const int64_t i_lo = causal ? k0 : 0;
  int64_t i_hi = L;
  if (has_window && k0 + kRows - 1 + window < L) i_hi = k0 + kRows - 1 + window;
  const int nti = i_hi > i_lo ? static_cast<int>((i_hi - i_lo + BI - 1) / BI) : 0;
  const int total = rep * nti;
  const float sl2 = scale * kLog2e;

  auto tile_of = [&](int it, int64_t& i0, int64_t& bh) {
    i0 = i_lo + static_cast<int64_t>(it % nti) * BI;
    bh = (b * Hkv + hkv) * rep + it / nti;
  };
  auto load_stage = [&](int st, int it) {
    int64_t i0, bh;
    tile_of(it, i0, bh);
    float* Qs = stages + st * S::kStage;
    float* Gs = Qs + BI * LD;
    float* ls = Gs + BI * LD;
    load_rows<D>(Qs, q + bh * L * D, i0, BI, L);
    load_rows<D>(Gs, g + bh * L * D, i0, BI, L);
    for (int j = tid; j < BI; j += kThreads) {
      const bool ok = i0 + j < L;
      cp_async4(ls + j, lse + (ok ? bh * L + i0 + j : 0), ok);
      cp_async4(ls + BI + j, delta + (ok ? bh * L + i0 + j : 0), ok);
    }
  };

  load_rows<D>(Ks, k + kv, k0, kRows, L);
  load_rows<D>(Vs, v + kv, k0, kRows, L);
  if (total > 0) load_stage(0, 0);
  cp_async_commit();

  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.0f;
  }
  for (int it = 0; it < total; ++it) {
    cp_async_wait_all();
    __syncthreads();  // tile it landed; every warp is done with tile it - 1
    if (it + 1 < total) load_stage((it + 1) & 1, it + 1);
    cp_async_commit();
    const float* Qs = stages + (it & 1) * S::kStage;
    const float* Gs = Qs + BI * LD;
    const float* ls = Gs + BI * LD;
    int64_t i0, bh;
    tile_of(it, i0, bh);
    // a tile none of whose rows sees this warp's keys
    if (kk0 >= L || (causal && i0 + BI - 1 < kk0) ||
        (has_window && i0 - window >= kk0 + 15))
      continue;

    // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ for the warp's 16 keys and the tile's rows
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.0f;
    }
    rows_product<D, NT>(s, Ks, 16 * warp + gq, Qs, gq, t);
    rows_product<D, NT>(dp, Vs, 16 * warp + gq, Gs, gq, t);

    // Pᵀ and dSᵀ in place: element (n, e) is key kk0 + g + 8 (e / 2), row
    // i0 + 8n + 2t + e % 2
    const bool full = i0 + BI <= L && kk0 + 16 <= L && (!causal || kk0 + 15 <= i0) &&
                      (!has_window || kk0 > i0 + BI - 1 - window);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 8 * n + 2 * t + (e & 1);
        const bool ok = full || allowed(i0 + r, kk0 + gq + 8 * (e >> 1), L, causal,
                                        has_window, window);
        const float p = ok ? exp2f(s[n][e] * sl2 - ls[r] * kLog2e) : 0.0f;
        s[n][e] = p;
        dp[n][e] = p * (dp[n][e] - ls[BI + r]);
      }
    }
    // dV += Pᵀ·dO and dK += dSᵀ·Q
    cols_product<D, NT>(dva, s, Gs, gq, t);
    cols_product<D, NT>(dka, dp, Qs, gq, t);
  }
  cp_async_wait_all();
  store_rows<D>(dk + kv, dka, kk0 + gq, L, t, scale);
  store_rows<D>(dv + kv, dva, kk0 + gq, L, t, 1.0f);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2) attention_bwd_dq(
    T* __restrict__ dq, const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ g, const float* __restrict__ lse,
    const float* __restrict__ delta, const int Hq, const int rep, const int64_t L,
    const int causal, const int has_window, const int64_t window, const float scale) {
  using S = Shape<D>;
  constexpr int BI = S::kBI, LD = S::kLd, NT = BI / 8;
  extern __shared__ float smem[];
  float* const Qs = smem;
  float* const Gs = Qs + kRows * LD;
  float* const stages = Gs + kRows * LD;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t = lane & 3;
  const int64_t bh = blockIdx.x;
  const int64_t i0 = static_cast<int64_t>(gridDim.y - 1 - blockIdx.y) * kRows;  // heaviest first
  const int64_t b = bh / Hq;
  const int h = static_cast<int>(bh % Hq);
  const int64_t kv = (b * (Hq / rep) + h / rep) * L * D;
  const int64_t rr0 = i0 + 16 * warp;  // this warp's rows rr0 .. rr0 + 15
  // keys some row of this block can see: [k_lo, k_hi)
  int64_t k_lo = 0;
  if (has_window && i0 - window + 1 > 0) k_lo = i0 - window + 1;
  const int64_t k_hi = causal && i0 + kRows < L ? i0 + kRows : L;
  const int ntk = k_hi > k_lo ? static_cast<int>((k_hi - k_lo + BI - 1) / BI) : 0;
  const float sl2 = scale * kLog2e;
  // lse (log2 units) and delta of this thread's rows rr0 + g, rr0 + g + 8
  float lrow[2], drow[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int64_t row = rr0 + gq + 8 * hh;
    lrow[hh] = row < L ? lse[bh * L + row] * kLog2e : 0.0f;
    drow[hh] = row < L ? delta[bh * L + row] : 0.0f;
  }

  auto load_stage = [&](int st, int it) {
    float* Ks = stages + st * S::kStage;
    load_rows<D>(Ks, k + kv, k_lo + static_cast<int64_t>(it) * BI, BI, L);
    load_rows<D>(Ks + BI * LD, v + kv, k_lo + static_cast<int64_t>(it) * BI, BI, L);
  };
  load_rows<D>(Qs, q + bh * L * D, i0, kRows, L);
  load_rows<D>(Gs, g + bh * L * D, i0, kRows, L);
  if (ntk > 0) load_stage(0, 0);
  cp_async_commit();

  float dqa[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) dqa[n][0] = dqa[n][1] = dqa[n][2] = dqa[n][3] = 0.0f;
  for (int it = 0; it < ntk; ++it) {
    cp_async_wait_all();
    __syncthreads();  // tile it landed; every warp is done with tile it - 1
    if (it + 1 < ntk) load_stage((it + 1) & 1, it + 1);
    cp_async_commit();
    const float* Ks = stages + (it & 1) * S::kStage;
    const float* Vs = Ks + BI * LD;
    const int64_t k0 = k_lo + static_cast<int64_t>(it) * BI;
    // a tile none of whose keys this warp's rows see
    if (rr0 >= L || (causal && k0 > rr0 + 15) || (has_window && k0 + BI - 1 <= rr0 - window))
      continue;

    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.0f;
    }
    rows_product<D, NT>(s, Qs, 16 * warp + gq, Ks, gq, t);
    rows_product<D, NT>(dp, Gs, 16 * warp + gq, Vs, gq, t);

    // dS in place: element (n, e) is row rr0 + g + 8 (e / 2), key k0 + 8n +
    // 2t + e % 2
    const bool full = rr0 + 16 <= L && k0 + BI <= L && (!causal || k0 + BI - 1 <= rr0) &&
                      (!has_window || k0 > rr0 + 15 - window);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hh = e >> 1;
        const bool ok = full || allowed(rr0 + gq + 8 * hh, k0 + 8 * n + 2 * t + (e & 1), L,
                                        causal, has_window, window);
        const float p = ok ? exp2f(s[n][e] * sl2 - lrow[hh]) : 0.0f;
        dp[n][e] = p * (dp[n][e] - drow[hh]);
      }
    }
    // dQ += dS·K
    cols_product<D, NT>(dqa, dp, Ks, gq, t);
  }
  cp_async_wait_all();
  store_rows<D>(dq + bh * L * D, dqa, rr0 + gq, L, t, scale);
}

template <int D>
int launch_d(cudaStream_t st, T* dq, T* dk, T* dv, const T* q,
             const T* k, const T* v, const T* g, const float* lse,
             const float* delta, int64_t B, int Hq, int Hkv, int64_t L, int causal,
             int has_window, int64_t window, float scale) {
  const int smem = smem_floats(D) * 4;
  cudaError_t err = cudaFuncSetAttribute(attention_bwd_dkdv<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(attention_bwd_dq<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 block(kThreads, 1, 1);
  const int rep = Hq / Hkv;
  const unsigned tiles = static_cast<unsigned>((L + kRows - 1) / kRows);
  {
    const dim3 grid(static_cast<unsigned>(B * Hkv), tiles, 1);
    attention_bwd_dkdv<D><<<grid, block, smem, st>>>(
        dk, dv, q, k, v, g, lse, delta, Hkv, rep, L, causal, has_window, window, scale);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  {
    const dim3 grid(static_cast<unsigned>(B * Hq), tiles, 1);
    attention_bwd_dq<D><<<grid, block, smem, st>>>(
        dq, q, k, v, g, lse, delta, Hq, rep, L, causal, has_window, window, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

int launch_delta(cudaStream_t st, float* delta, const float* o, const T* g, int64_t rows,
                 int D) {
  const dim3 grid(static_cast<unsigned>((rows + 7) / 8), 1, 1);
  const dim3 block(256, 1, 1);
  attention_bwd_delta<<<grid, block, 0, st>>>(
      delta, o, g, rows, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// smem_floats for the host (kernels/attention.py::bwd_smem_floats is held to it)
extern "C" int64_t bwd_smem_floats(int64_t D) { return smem_floats(static_cast<int>(D)); }

// Head dimensions multiples of 16 up to 128 (attention.cu's); q, k, v, g
// start on 16-byte boundaries. delta is a (B, Hq, L) f32 scratch; lse and o
// (f32) are the forward's.
extern "C" int launch(void* dq, void* dk, void* dv, void* delta, const void* q, const void* k,
                      const void* v, const void* o, const void* g, const void* lse, int64_t B,
                      int64_t Hq, int64_t Hkv, int64_t L, int64_t D, int64_t causal,
                      int64_t has_window, int64_t window, float scale, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const T*>(p); };
  auto dl = static_cast<float*>(delta);
  const int err = launch_delta(st, dl, static_cast<const float*>(o), f(g), B * Hq * L,
                               static_cast<int>(D));
  if (err != 0) return err;
  auto ls = static_cast<const float*>(lse);
  auto qo = static_cast<T*>(dq);
  auto ko = static_cast<T*>(dk);
  auto vo = static_cast<T*>(dv);
  const int hq = static_cast<int>(Hq), hkv = static_cast<int>(Hkv);
  const int c = static_cast<int>(causal), hw = static_cast<int>(has_window);
  switch (D) {
    case 16: return launch_d<16>(st, qo, ko, vo, f(q), f(k), f(v), f(g), ls, dl, B, hq, hkv, L, c, hw, window, scale);
    case 32: return launch_d<32>(st, qo, ko, vo, f(q), f(k), f(v), f(g), ls, dl, B, hq, hkv, L, c, hw, window, scale);
    case 48: return launch_d<48>(st, qo, ko, vo, f(q), f(k), f(v), f(g), ls, dl, B, hq, hkv, L, c, hw, window, scale);
    case 64: return launch_d<64>(st, qo, ko, vo, f(q), f(k), f(v), f(g), ls, dl, B, hq, hkv, L, c, hw, window, scale);
    case 80: return launch_d<80>(st, qo, ko, vo, f(q), f(k), f(v), f(g), ls, dl, B, hq, hkv, L, c, hw, window, scale);
    case 96: return launch_d<96>(st, qo, ko, vo, f(q), f(k), f(v), f(g), ls, dl, B, hq, hkv, L, c, hw, window, scale);
    case 112: return launch_d<112>(st, qo, ko, vo, f(q), f(k), f(v), f(g), ls, dl, B, hq, hkv, L, c, hw, window, scale);
    case 128: return launch_d<128>(st, qo, ko, vo, f(q), f(k), f(v), f(g), ls, dl, B, hq, hkv, L, c, hw, window, scale);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

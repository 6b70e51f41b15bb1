// Hand-written CUDA kernels for the backward pass of the Mamba2 SSD chunk
// scan (csrc/ssd.cu is the forward), on Hopper's tensor cores. Per batch row
// b and head h, with g = h / (H / G) the head's state group, the forward's
// recurrence is
//
//   h_t = a_t h_{t-1} + dt_t x_t B_tᵀ,   a_t = exp(dt_t A),   (P x N state)
//   y_t = h_t C_t + D x_t,
//
// from h_{-1} = h0 (or zero) to h_{L-1} = h_final. Given dy and dh_final
// (or zero), with G_t = dL/dh_t:
//
//   G_t     = dy_t C_tᵀ + a_{t+1} G_{t+1}        (G_{L-1} = dy C_ᵀ + dh_final)
//   dx_t    = dt_t G_t B_t + D dy_t
//   dB_t    = dt_t G_tᵀ x_t,  dC_t = h_tᵀ dy_t   (summed over the group's heads)
//   dla_t   = <G_t, a_t h_{t-1}> = sum_{v >= t} (dy_v·(h_v C_v) - dt_v e_v)
//             + <dh_final, h_final>,             e_t = x_t·(G_t B_t)
//   ddt_t   = e_t + A dla_t,  dA = sum_t dt_t dla_t,  dD = sum_t dy_t·x_t,
//   dh0     = a_0 G_0.
//
// The identity for dla (it follows from the two recurrences) keeps the
// states and their gradients apart, and dy_v·(h_v C_v) = C_v·dC_v of the
// head, so it needs neither.
//
// The TPU kernel src/repro/kernels/ssd.py::ssd_chunk_scan (pl.pallas_call at
// :78) has no backward: the reference differentiates its chunked jnp twin
// (src/repro/kernels/ops.py:159-205). This kernel is the gradient of the
// port's forward kernels, which training runs inside a
// torch.autograd.Function (kernels/ssd.py::SSDFn).
//
// The chunked algebra, as the forward's. Over the forward's chunks of cs
// steps, lc is the in-chunk cumulative sum of dt·A and Gin(c) the gradient
// of the chunk's last state from later chunks (Gin(nc - 1) = dh_final):
//
//   Gin(c - 1) = sum_{v in c} exp(lc_v) dy_v C_vᵀ + exp(lc_last) Gin(c),
//   dh0 = Gin(-1),
//   G_t B_t  = sum_{v >= t} exp(lc_v - lc_t)(C_v·B_t) dy_v
//              + exp(lc_last - lc_t) Gin B_t,
//   dB_t     = dt_t [sum_{v >= t} exp(lc_v - lc_t)(dy_v·x_t) C_v
//                    + exp(lc_last - lc_t) Ginᵀ x_t],
//   dC_t     = exp(lc_t) h_startᵀ dy_t
//              + sum_{u <= t} exp(lc_t - lc_u) dt_u (x_u·dy_t) B_u,
//
// with h_start the forward's saved chunk-start state: every term a product
// of cs x cs masked-decay matrices (C·Bᵀ, x·dyᵀ) or of the state tiles.
//
// What bounds it on the H100: operations, once the products run on the
// tensor cores. At Zamba2's training shape (B = 4, L = 1024, H = 64,
// P = N = 64, G = 1) the 14 operations a step and state element of the step
// recurrence, 15.0 GFLOP, take 0.091 ms at the 3xTF32 rate; the function
// reads x, dy, dt, B, C and the chunk-start states and writes the
// gradients, 0.27 GB, 0.082 ms at 3.35 TB/s. The chunked algebra below does
// about 21 GFLOP over the chunks' triangles (0.13 ms at the same rate).
//
// What the design does. Every product runs as mma.sync.m16n8k8 tf32 with
// each f32 operand split into a TF32 hi and lo (3xTF32, tf32x3.cuh), 4 warps
// a block. Only the passing of the state gradient across chunks is
// sequential. One call makes up to five launches:
// 1. ssd_bwd_gin, one block per (b, h, 64 p, 64 n): the forward's
//    ssd_states_kernel in reverse. It walks the chunks from the last with
//    Gin in the accumulators' registers, writes Gin(c) to a (B, nc, H, P, N)
//    buffer, sums the chunk's exp(lc_v) dy_v C_vᵀ in a fresh accumulator on
//    the tensor cores and adds it to exp(lc_last)·Gin on the CUDA cores; dy
//    and C of the next chunk load by cp.async meanwhile. Gin(-1) is dh0.
// 2. ssd_bwd_chunk, one block per (chunk, b, slice of hb heads of a group):
//    each warp owns 16 steps of the chunk. Per head it loads x, dy, Gin and
//    the start state (B and C once for the slice), then C·Bᵀ -> the masked
//    decay -> G B (with B·Ginᵀ) -> dx and e; x·dyᵀ -> dB (with x·Gin); dy·xᵀ
//    -> dC (with dy·h_start) and dy·(h C) = C·dC. A matrix that comes out of
//    an accumulator feeds the next product as its A operand without a trip
//    through shared memory (A column t <-> key 2t, t + 4 <-> 2t + 1, as the
//    forward's W·x), the decays masked before the exponential (exp2f of log2
//    units); a warp skips the key tiles across its diagonal. The slice's
//    dB and dC are summed over its heads in order in the block's own rows
//    of a (B, L, G·slices, N) buffer (the gradients themselves where a
//    slice is a whole group). Tiles are rows of a multiple of 32 words with
//    swizzled 16-byte chunks (chunk c of row r at c ^ s(r), s(r) = (r & 6)
//    ^ 4 (r & 1)), so the loads of a row's k-steps and of two rows' columns
//    are both free of bank conflicts.
// 3. ssd_bwd_fold_slices (slices > 1): dB and dC, the slices of each group
//    summed in order.
// 4. ssd_bwd_dla, one block of 256 threads per (b, h): the suffix sums of
//    dy·(h C) - dt e in double as thread sums, a scan over the threads and a
//    walk of each thread's steps; ddt, and the (b, h) parts of dA and dD.
// 5. ssd_bwd_fold_heads folds dA and dD over b in order.
// A chunk's products are summed in accumulators fresh for the chunk (and
// its head), never chained across chunks through the tensor cores' adds,
// which truncate (tf32x3.cuh); where P > 64 a block walks P in tiles of 64
// and the tiles of one head chain. hb (heads_per_block) trades the
// slices' scratch for blocks: a call of fewer blocks than SMs takes whole
// groups, otherwise the most heads that keep four blocks an SM. Every sum
// runs in a fixed order and there are no atomics: the same bits on every
// call.
//
// x, dy, B and C, and dx, dB and dC, are at the storage type T
// (storage.cuh: f32, or bf16 in the bf16 instance), converted to f32 as
// they are staged in shared memory (at bf16 by a load and a store, not
// cp.async) and rounded once on store; dB and dC are then always summed in
// the f32 slices' buffer and rounded by the fold (3.), also where a slice is
// a whole group. Everything else is f32.
#include <cstdint>
#include <cuda_runtime.h>

#include "tf32x3.cuh"
#include "storage.cuh"

namespace {

using namespace tf32x3;
using storage::T;
using storage::kTwoByte;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = 64;        // steps of a chunk tile: cs <= 64
constexpr int kTile = 64;         // p (and n) columns of a tile
constexpr int kLdX = kTile + 4;   // words, = 4 mod 16 (ssd_bwd_gin's tiles)
constexpr int kFold = 128;        // threads of a fold block
constexpr int kDla = 256;         // threads of a dla block
constexpr int kSMs = 132;         // H100 SXM
constexpr float kLog2e = 1.4426950408889634f;

// Word of column c of row r in a swizzled tile (a row a multiple of 32 words).
__device__ __forceinline__ int swz(int r, int c) {
  return c ^ ((((r & 6) ^ ((r & 1) << 2))) << 2);
}

// Copy rows [0, kChunk) x columns [0, cols_tile) of a row-major global tile
// (row stride ldg) into shared memory (row stride lds, swizzled or not);
// rows >= rows and columns >= cols are zero-filled. vec4: 16-byte copies
// (every column count, stride and base is a multiple of 4 elements and 16
// bytes at f32); storage values are converted to f32 (storage::copy4).
template <class S>
__device__ __forceinline__ void load_tile(float* s, int lds, bool swizzled, const S* g,
                                          int64_t ldg, int rows, int cols, int cols_tile,
                                          bool vec4) {
  if (vec4) {
    const int chunks = cols_tile / 4;
    for (int i = threadIdx.x; i < kChunk * chunks; i += kThreads) {
      const int r = i / chunks, c = 4 * (i % chunks);
      const bool ok = r < rows && c < cols;
      storage::copy4(s + r * lds + (swizzled ? swz(r, c) : c), ok ? g + r * ldg + c : g, ok);
    }
  } else {
    for (int i = threadIdx.x; i < kChunk * cols_tile; i += kThreads) {
      const int r = i / cols_tile, c = i % cols_tile;
      const bool ok = r < rows && c < cols;
      storage::copy1(s + r * lds + (swizzled ? swz(r, c) : c), ok ? g + r * ldg + c : g, ok);
    }
  }
}

// dt of the chunk's rows (stride H), zero past `rows`
__device__ __forceinline__ void load_dt(float* s, const float* dt, int64_t H, int rows) {
  for (int u = threadIdx.x; u < kChunk; u += kThreads) {
    const bool ok = u < rows;
    cp_async4(s + u, ok ? dt + u * H : dt, ok);
  }
}

// In-chunk cumulative log decay by one warp: lane l returns lc[2l] and
// lc[2l + 1], lc[u] = sum_{v <= u} dt[v] a (dt is 0 past the chunk).
__device__ __forceinline__ void logcum(const float* dts, float a, int lane, float& l0,
                                       float& l1) {
  const float v0 = dts[2 * lane] * a, v1 = dts[2 * lane + 1] * a;
  float s = v0 + v1;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float n = __shfl_up_sync(kFull, s, off);
    if (lane >= off) s += n;
  }
  float e = __shfl_up_sync(kFull, s, 1);
  if (lane == 0) e = 0.0f;
  l0 = e + v0;
  l1 = l0 + v1;
}

// The accumulators acc[4 Q][4] of a warp's 16 x 32 Q tile hold, for the row
// half (0: row g, 1: row g + 8) and column group q (32 columns), columns
// 32q + 8t + e, e = 0..7, at acc[4q + e % 4][e / 4 + 2·half].
template <int M, class V>
__device__ __forceinline__ V& frag(V (&acc)[M][4], int q, int half, int e) {
  return acc[4 * q + (e & 3)][(e >> 2) + 2 * half];
}

template <class S>
__device__ __forceinline__ void load8(const S* src, int left, bool vec4, float (&v)[8]) {
  if (vec4 && left >= 8) {
    const float4 a = storage::load4(src);
    const float4 b = storage::load4(src + 4);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = e < left ? storage::widen(src[e]) : 0.0f;
  }
}

// 8 values to dst, rounded once to its type
template <class S>
__device__ __forceinline__ void store8(S* dst, int left, bool vec4, const float (&v)[8]) {
  if (vec4 && left >= 8) {
    storage::store4(dst, make_float4(v[0], v[1], v[2], v[3]));
    storage::store4(dst + 4, make_float4(v[4], v[5], v[6], v[7]));
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (e < left) dst[e] = storage::narrow<S>(v[e]);
  }
}

// Rows prow + 8·half (< P - p0) of the (P, N) state at `base`, columns
// n0 + 32q + 8t + e: from the accumulators (store) or into them (load).
template <bool kStore, typename S>
__device__ __forceinline__ void state_rows(float (&acc)[8][4], S* base, int prow, int t,
                                           int P, int N, int p0, int n0, bool vec4) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int p = p0 + prow + 8 * half;
    if (p >= P) continue;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int n = n0 + 32 * q + 8 * t;
      S* at = base + static_cast<int64_t>(p) * N + n;
      float v[8];
      if constexpr (kStore) {
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = frag(acc, q, half, e);
        store8(at, N - n, vec4, v);
      } else {
        load8(at, N - n, vec4, v);
#pragma unroll
        for (int e = 0; e < 8; ++e) frag(acc, q, half, e) = v[e];
      }
    }
  }
}

constexpr int kGinStage = 2 * kChunk * kLdX + kChunk;  // dy, C, dt
constexpr int kGinSmem = 4 * (2 * kGinStage + kChunk + 4);

// 1. Gin(c) for every chunk, walking back from dh_final; dh0 = Gin(-1).
__global__ void __launch_bounds__(kThreads) ssd_bwd_gin(
    float* __restrict__ gin, float* __restrict__ dh0, const T* __restrict__ dy,
    const float* __restrict__ dt, const float* __restrict__ A, const T* __restrict__ Cm,
    const float* __restrict__ dh_final, const int64_t L, const int H, const int P, const int G,
    const int N, const int cs, const int nc, const int vec4) {
  extern __shared__ float smem[];
  float* const sm = smem;
  float* const co = sm + 2 * kGinStage;  // exp(lc[v])
  float* const decay = co + kChunk;      // exp(lc[cs-1])

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H, grp = h / (H / G);
  const int p0 = blockIdx.y * kTile, n0 = blockIdx.z * kTile;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int prow = 16 * warp + g;
  const int pc = P - p0 < kTile ? P - p0 : kTile;
  const int ncols = N - n0 < kTile ? N - n0 : kTile;
  const float a = A[h];
  const int64_t state_size = static_cast<int64_t>(P) * N;

  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
  if (dh_final != nullptr)
    state_rows<false>(acc, dh_final + static_cast<int64_t>(bh) * state_size, prow, t, P, N, p0,
                      n0, vec4);

  auto load = [&](int stage, int c) {
    float* ys = sm + stage * kGinStage;
    float* cs_ = ys + kChunk * kLdX;
    const int64_t r0 = static_cast<int64_t>(c) * cs;
    const int rows = L - r0 < cs ? static_cast<int>(L - r0) : cs;
    load_tile(ys, kLdX, false, dy + ((b * L + r0) * H + h) * P + p0,
              static_cast<int64_t>(H) * P, rows, pc, kTile, vec4);
    load_tile(cs_, kLdX, false, Cm + ((b * L + r0) * G + grp) * N + n0,
              static_cast<int64_t>(G) * N, rows, ncols, kTile, vec4);
    load_dt(cs_ + kChunk * kLdX, dt + (b * L + r0) * H + h, H, rows);
  };

  if (nc > 0) load(0, nc - 1);
  cp_async_commit();
  for (int i = 0; i < nc; ++i) {
    const int c = nc - 1 - i;
    cp_async_wait_all();
    __syncthreads();  // chunk c landed; every warp is done with chunk c + 1
    if (i + 1 < nc) load((i + 1) & 1, c - 1);
    cp_async_commit();
    const float* ys = sm + (i & 1) * kGinStage;
    const float* cs_ = ys + kChunk * kLdX;
    if (warp == 0) {
      const float* dts = cs_ + kChunk * kLdX;
      float l0, l1;
      logcum(dts, a, lane, l0, l1);
      co[2 * lane] = expf(l0);
      co[2 * lane + 1] = expf(l1);
      if (lane == 31) *decay = expf(l1);
    }
    __syncthreads();

    // Gin(c), then Gin <- decay·Gin + (coeff ⊙ dy)ᵀ·C
    state_rows<true>(acc, gin + ((static_cast<int64_t>(b) * nc + c) * H + h) * state_size,
                     prow, t, P, N, p0, n0, vec4);
    // the chunk's own part in a fresh accumulator, added to decay·Gin on
    // the CUDA cores (the tensor cores' adds truncate: tf32x3.cuh)
    float gacc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) gacc[j][0] = gacc[j][1] = gacc[j][2] = gacc[j][3] = 0.0f;
    const int64_t r0 = static_cast<int64_t>(c) * cs;
    const int rows = L - r0 < cs ? static_cast<int>(L - r0) : cs;
    const int ksteps = (rows + 7) / 8;
#pragma unroll
    for (int ks = 0; ks < kChunk / 8; ++ks) {
      if (ks >= ksteps) break;
      // A[p][v] = coeff[v] dy[v][p]: column t <-> v = 8ks + 2t, t + 4 <-> v + 1
      const int v = 8 * ks + 2 * t;
      const float c0 = co[v], c1 = co[v + 1];
      const float av[4] = {ys[v * kLdX + prow] * c0, ys[v * kLdX + prow + 8] * c0,
                           ys[(v + 1) * kLdX + prow] * c1, ys[(v + 1) * kLdX + prow + 8] * c1};
      uint32_t ah[4], al[4];
      split4(av, ah, al);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float4 w0 = *reinterpret_cast<const float4*>(cs_ + v * kLdX + 32 * q + 4 * g);
        const float4 w1 = *reinterpret_cast<const float4*>(cs_ + (v + 1) * kLdX + 32 * q + 4 * g);
        mma3(gacc[4 * q + 0], ah, al, w0.x, w1.x);
        mma3(gacc[4 * q + 1], ah, al, w0.y, w1.y);
        mma3(gacc[4 * q + 2], ah, al, w0.z, w1.z);
        mma3(gacc[4 * q + 3], ah, al, w0.w, w1.w);
      }
    }
    const float dec = *decay;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = acc[j][e] * dec + gacc[j][e];
    }
  }
  cp_async_wait_all();
  if (dh0 != nullptr)
    state_rows<true>(acc, dh0 + static_cast<int64_t>(bh) * state_size, prow, t, P, N, p0, n0,
                     vec4);
}

__device__ __forceinline__ float4 ld4(const float* tile, int ld, int r, int c) {
  return *reinterpret_cast<const float4*>(tile + r * ld + swz(r, c));
}
__device__ __forceinline__ float2 ld2(const float* tile, int ld, int r, int c) {
  return *reinterpret_cast<const float2*>(tile + r * ld + swz(r, c));
}
__device__ __forceinline__ float at(const float* tile, int ld, int r, int c) {
  return tile[r * ld + swz(r, c)];
}

// acc[n] += (s ⊙ A)·Bᵀ for one warp over kdim (a multiple of 16) columns:
// A's rows ra, ra + 8 of tile a (scaled by s0, s1), B's rows brow(n) of
// tile b, n in [nlo, nhi]; columns 16i + 4t .. + 3 give the k-steps 2i,
// 2i + 1 of both operands.
template <int NT, class BRow>
__device__ __forceinline__ void rows_product(float (&acc)[NT][4], const float* a, int lda,
                                             int ra, float s0, float s1, const float* b,
                                             int ldb, int kdim, int nlo, int nhi, BRow brow,
                                             int t) {
  for (int i = 0; i < kdim / 16; ++i) {
    const float4 x = ld4(a, lda, ra, 16 * i + 4 * t), y = ld4(a, lda, ra + 8, 16 * i + 4 * t);
    const float a0[4] = {x.x * s0, y.x * s1, x.y * s0, y.y * s1};
    const float a1[4] = {x.z * s0, y.z * s1, x.w * s0, y.w * s1};
    uint32_t ah0[4], al0[4], ah1[4], al1[4];
    split4(a0, ah0, al0);
    split4(a1, ah1, al1);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      if (n < nlo || n > nhi) continue;
      const float4 z = ld4(b, ldb, brow(n), 16 * i + 4 * t);
      mma3(acc[n], ah0, al0, z.x, z.y);
      mma3(acc[n], ah1, al1, z.z, z.w);
    }
  }
}

// out[4q + jj] += A·B over the k-steps j in [jlo, jhi] of 8 rows of tile b:
// A's fragment of k-step j from afrag(j, a) (column t <-> row 8j + 2t of b,
// t + 4 <-> 8j + 2t + 1), B's columns 32q + 4g + jj.
template <int NQ, class AFrag>
__device__ __forceinline__ void cols_product(float (&out)[4 * NQ][4], AFrag afrag, int jlo,
                                             int jhi, const float* b, int ldb, int g, int t) {
#pragma unroll
  for (int j = 0; j < kChunk / 8; ++j) {
    if (j < jlo || j > jhi) continue;
    float a[4];
    afrag(j, a);
    uint32_t ah[4], al[4];
    split4(a, ah, al);
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const float4 b0 = ld4(b, ldb, 8 * j + 2 * t, 32 * q + 4 * g);
      const float4 b1 = ld4(b, ldb, 8 * j + 2 * t + 1, 32 * q + 4 * g);
      mma3(out[4 * q + 0], ah, al, b0.x, b1.x);
      mma3(out[4 * q + 1], ah, al, b0.y, b1.y);
      mma3(out[4 * q + 2], ah, al, b0.z, b1.z);
      mma3(out[4 * q + 3], ah, al, b0.w, b1.w);
    }
  }
}

// A fragment of k-step j from an accumulator tile m (keys 8j + 2t, + 1)
template <int M>
__device__ __forceinline__ void acc_frag(const float (&m)[M][4], int j, float (&a)[4]) {
  a[0] = m[j][0]; a[1] = m[j][2]; a[2] = m[j][1]; a[3] = m[j][3];
}

// A fragment of k-step j from rows r, r + 8 of a tile (columns 8j + 2t, + 1),
// scaled by s0, s1
__device__ __forceinline__ void tile_frag(const float* tile, int ld, int r, int j, int t,
                                          float s0, float s1, float (&a)[4]) {
  const float2 x = ld2(tile, ld, r, 8 * j + 2 * t), y = ld2(tile, ld, r + 8, 8 * j + 2 * t);
  a[0] = x.x * s0; a[1] = y.x * s1; a[2] = x.y * s0; a[3] = y.y * s1;
}

// Rows t0 + 8·half (< rows) of a 16 x 32 NQ accumulator tile times mul[half]
// into the (row stride ld) rows at base, columns 32q + 8t + e < N; added to
// what is there unless `first`.
template <int NQ>
__device__ __forceinline__ void store_part(float* base, int64_t ld, const float (&acc)[4 * NQ][4],
                                           int t0, int rows, int N, int t, bool first,
                                           bool vec4, const float (&mul)[2]) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = t0 + 8 * half;
    if (row >= rows) continue;
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int n = 32 * q + 8 * t;
      if (n >= N) continue;
      float* dst = base + row * ld + n;
      float v[8], o[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = frag(acc, q, half, e) * mul[half];
      if (!first) {
        load8(dst, N - n, vec4, o);
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] += o[e];
      }
      store8(dst, N - n, vec4, v);
    }
  }
}

// Shared memory of a chunk block in floats: x and dy (64 steps x 64 p), B
// and C (64 steps x ldn), Gin and the start state (64 p x ldn), dt and lc;
// ldn = N padded to 32. kernels/ssd.py::bwd_smem_floats computes the same.
__host__ __device__ constexpr int chunk_smem_floats(int ldn) {
  return 2 * kChunk * kTile + 2 * kChunk * ldn + 2 * kTile * ldn + 2 * kChunk;
}

// 2. Per (chunk, b, slice of hb heads): dx, e_t (into ddt), dy·(h C) -
// dt e (dsc) and dy·x (ddg) per step, and the slice's dB and dC.
template <int NJ>
__global__ void __launch_bounds__(kThreads, NJ <= 2 ? 2 : 1) ssd_bwd_chunk(
    T* __restrict__ dx, float* __restrict__ ddt, float* __restrict__ dsc,
    float* __restrict__ ddg, float* __restrict__ pB, float* __restrict__ pC,
    const float* __restrict__ states, const float* __restrict__ gin,
    const T* __restrict__ x, const T* __restrict__ dy, const float* __restrict__ dt,
    const float* __restrict__ A, const T* __restrict__ Bm, const T* __restrict__ Cm,
    const float* __restrict__ D, const int64_t L, const int H, const int P, const int G,
    const int N, const int cs, const int nc, const int hb, const int vec4) {
  constexpr int LDN = 32 * NJ;
  extern __shared__ float smem[];
  float* const xs = smem;                    // [t][p]
  float* const dys = xs + kChunk * kTile;    // [t][p]
  float* const bs = dys + kChunk * kTile;    // [t][n]
  float* const cms = bs + kChunk * LDN;      // [t][n]
  float* const gs = cms + kChunk * LDN;      // Gin [p][n]
  float* const hs = gs + kTile * LDN;        // start state [p][n]
  float* const dts = hs + kTile * LDN;
  float* const lc = dts + kChunk;            // log2 units

  const int c = blockIdx.x;
  const int rep = H / G, ns = rep / hb, slots = G * ns;
  const int64_t b = blockIdx.y / slots;
  const int slot = blockIdx.y % slots;
  const int grp = slot / ns, h_first = grp * rep + (slot % ns) * hb;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t = lane & 3;
  const int64_t r0 = static_cast<int64_t>(c) * cs;
  const int rows = L - r0 < cs ? static_cast<int>(L - r0) : cs;
  const int t0 = 16 * warp + gq;  // this thread's steps t0, t0 + 8 of the chunk
  const bool live = 16 * warp < rows;
  const int np = (P + kTile - 1) / kTile;
  const int kn = (N + 15) / 16 * 16;  // the n columns a product sums over
  const int64_t state_size = static_cast<int64_t>(P) * N;
  auto nat = [gq](int n) { return 8 * n + gq; };
  // B's row of n-tile n of a product whose columns are 32q + 4g + jj
  auto perm = [gq](int n) { return 32 * (n >> 2) + 4 * gq + (n & 3); };

  const int64_t bc = ((b * L + r0) * G + grp) * N;
  load_tile(bs, LDN, true, Bm + bc, static_cast<int64_t>(G) * N, rows, N, LDN, vec4);
  load_tile(cms, LDN, true, Cm + bc, static_cast<int64_t>(G) * N, rows, N, LDN, vec4);
  // x, dy, Gin and the start state of head h and p tile pt, then a barrier
  auto load_p = [&](int h, int pt) {
    const int p0 = pt * kTile, pc = P - p0 < kTile ? P - p0 : kTile;
    load_tile(xs, kTile, true, x + ((b * L + r0) * H + h) * P + p0,
              static_cast<int64_t>(H) * P, rows, pc, kTile, vec4);
    load_tile(dys, kTile, true, dy + ((b * L + r0) * H + h) * P + p0,
              static_cast<int64_t>(H) * P, rows, pc, kTile, vec4);
    const int64_t so = ((b * nc + c) * H + h) * state_size + static_cast<int64_t>(p0) * N;
    load_tile(gs, LDN, true, gin + so, N, pc, N, LDN, vec4);
    load_tile(hs, LDN, true, states + so, N, pc, N, LDN, vec4);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
  };
  auto reload = [&](int h, int pt) {
    __syncthreads();  // every warp is done with the tiles loaded now
    load_p(h, pt);
  };

  for (int j = 0; j < hb; ++j) {
    const int h = h_first + j;
    __syncthreads();  // every warp is done with the previous head's tiles
    load_dt(dts, dt + (b * L + r0) * H + h, H, rows);
    load_p(h, 0);
    if (warp == 0) {
      float l0, l1;
      logcum(dts, A[h], lane, l0, l1);
      lc[2 * lane] = l0 * kLog2e;
      lc[2 * lane + 1] = l1 * kLog2e;
    }
    __syncthreads();
    const float llast = lc[kChunk - 1];
    const float lrow[2] = {lc[t0], lc[t0 + 8]};
    const float dtr[2] = {dts[t0], dts[t0 + 8]};
    const float dec[2] = {exp2f(llast - lrow[0]), exp2f(llast - lrow[1])};
    const float elc[2] = {exp2f(lrow[0]), exp2f(lrow[1])};
    const float one[2] = {1.0f, 1.0f};
    const float dskip = D != nullptr ? D[h] : 0.0f;

    // M1 = (C·Bᵀ masked, decayed): element (n, e) is step t0 + 8 (e / 2) and
    // key v = 8n + 2t + e % 2; keys before the warp's first step are 0
    float m[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) m[n][0] = m[n][1] = m[n][2] = m[n][3] = 0.0f;
    if (live) rows_product<8>(m, bs, LDN, t0, 1.0f, 1.0f, cms, LDN, kn, 2 * warp, 7, nat, t);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      if (n < 2 * warp) continue;  // keys before the warp's steps: left 0
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = t0 + 8 * (e >> 1), v = 8 * n + 2 * t + (e & 1);
        m[n][e] = v >= row ? m[n][e] * exp2f(lc[v] - lrow[e >> 1]) : 0.0f;
      }
    }
    // G B = M1·dy + dec ⊙ B·Ginᵀ per p tile: dx, and e = x·(G B)
    float esum[2] = {0.0f, 0.0f};
    for (int pt = 0; pt < np; ++pt) {
      if (pt > 0) reload(h, pt);
      float gb[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n) gb[n][0] = gb[n][1] = gb[n][2] = gb[n][3] = 0.0f;
      if (live) {
        cols_product<2>(gb, [&](int jj, float (&a)[4]) { acc_frag(m, jj, a); }, 2 * warp, 7,
                        dys, kTile, gq, t);
        rows_product<8>(gb, bs, LDN, t0, dec[0], dec[1], gs, LDN, kn, 0, 7, perm, t);
      }
      const int p0 = pt * kTile;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = t0 + 8 * half;
        if (row >= rows) continue;
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int p = 32 * q + 8 * t;
          float v[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float val = frag(gb, q, half, e);
            esum[half] += at(xs, kTile, row, p + e) * val;
            v[e] = dtr[half] * val + dskip * at(dys, kTile, row, p + e);
          }
          store8(dx + ((b * L + r0 + row) * H + h) * P + p0 + p, P - p0 - p, vec4, v);
        }
      }
    }

    // dB = dt ⊙ (M2·C + dec ⊙ x·Gin), M2 = (x·dyᵀ masked, decayed)
    float da[4 * NJ][4];
#pragma unroll
    for (int n = 0; n < 4 * NJ; ++n) da[n][0] = da[n][1] = da[n][2] = da[n][3] = 0.0f;
#pragma unroll
    for (int n = 0; n < 8; ++n) m[n][0] = m[n][1] = m[n][2] = m[n][3] = 0.0f;
    for (int pt = 0; pt < np; ++pt) {
      if (np > 1) reload(h, pt);
      if (live) {
        rows_product<8>(m, xs, kTile, t0, 1.0f, 1.0f, dys, kTile, kTile, 2 * warp, 7, nat, t);
        cols_product<NJ>(da, [&](int jj, float (&a)[4]) {
          tile_frag(xs, kTile, t0, jj, t, dec[0], dec[1], a);
        }, 0, 7, gs, LDN, gq, t);
      }
    }
    float xd[2] = {0.0f, 0.0f};  // x_t·dy_t
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      if (n < 2 * warp) continue;  // keys before the warp's steps: left 0
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = t0 + 8 * (e >> 1), v = 8 * n + 2 * t + (e & 1);
        if (v == row) xd[e >> 1] = m[n][e];
        m[n][e] = v >= row ? m[n][e] * exp2f(lc[v] - lrow[e >> 1]) : 0.0f;
      }
    }
    if (live)
      cols_product<NJ>(da, [&](int jj, float (&a)[4]) { acc_frag(m, jj, a); }, 2 * warp, 7,
                       cms, LDN, gq, t);
    const int64_t ldp = static_cast<int64_t>(slots) * N;
    store_part<NJ>(pB + ((b * L + r0) * slots + slot) * N, ldp, da, t0, rows, N, t, j == 0,
                   vec4, dtr);

    // dC = M3·B + exp(lc) ⊙ dy·h_start, M3 = (dy·xᵀ masked, decayed, ⊙ dt)
#pragma unroll
    for (int n = 0; n < 4 * NJ; ++n) da[n][0] = da[n][1] = da[n][2] = da[n][3] = 0.0f;
#pragma unroll
    for (int n = 0; n < 8; ++n) m[n][0] = m[n][1] = m[n][2] = m[n][3] = 0.0f;
    for (int pt = 0; pt < np; ++pt) {
      if (np > 1) reload(h, pt);
      if (live) {
        rows_product<8>(m, dys, kTile, t0, 1.0f, 1.0f, xs, kTile, kTile, 0, 2 * warp + 1, nat,
                        t);
        cols_product<NJ>(da, [&](int jj, float (&a)[4]) {
          tile_frag(dys, kTile, t0, jj, t, elc[0], elc[1], a);
        }, 0, 7, hs, LDN, gq, t);
      }
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      if (n > 2 * warp + 1) continue;  // keys after the warp's steps: left 0
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = t0 + 8 * (e >> 1), u = 8 * n + 2 * t + (e & 1);
        m[n][e] = u <= row ? m[n][e] * exp2f(lrow[e >> 1] - lc[u]) * dts[u] : 0.0f;
      }
    }
    if (live)
      cols_product<NJ>(da, [&](int jj, float (&a)[4]) { acc_frag(m, jj, a); }, 0,
                       2 * warp + 1, bs, LDN, gq, t);
    // dy·(h C) = C·dC
    float usum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int half = 0; half < 2; ++half) {
#pragma unroll
      for (int q = 0; q < NJ; ++q) {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          usum[half] += at(cms, LDN, t0 + 8 * half, 32 * q + 8 * t + e) * frag(da, q, half, e);
      }
    }
    store_part<NJ>(pC + ((b * L + r0) * slots + slot) * N, ldp, da, t0, rows, N, t, j == 0,
                   vec4, one);

    // the step's scalars: sums over the quad's lanes
#pragma unroll
    for (int half = 0; half < 2; ++half) {
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        esum[half] += __shfl_xor_sync(kFull, esum[half], o);
        usum[half] += __shfl_xor_sync(kFull, usum[half], o);
        xd[half] += __shfl_xor_sync(kFull, xd[half], o);
      }
      const int row = t0 + 8 * half;
      if (t == 0 && row < rows) {
        const int64_t s = (b * L + r0 + row) * H + h;
        ddt[s] = esum[half];
        dsc[s] = usum[half] - dtr[half] * esum[half];
        ddg[s] = xd[half];
      }
    }
  }
}

// 3. dB and dC (B, L, G, N): the slices of each group summed in order, then
// rounded to T.
__global__ void __launch_bounds__(kFold) ssd_bwd_fold_slices(
    T* __restrict__ dB, T* __restrict__ dC, const float* __restrict__ pB,
    const float* __restrict__ pC, const int64_t total, const int G, const int N,
    const int ns) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kFold + threadIdx.x;
  if (i >= total) return;
  const int n = static_cast<int>(i % N);
  const int64_t row = i / N;  // (b, t, group)
  float sb = 0.0f, sc = 0.0f;
  for (int s = 0; s < ns; ++s) {
    const int64_t at = (row * ns + s) * N + n;
    sb += pB[at];
    sc += pC[at];
  }
  dB[i] = storage::narrow<T>(sb);
  dC[i] = storage::narrow<T>(sc);
}

// A block's sum of v in double, in a fixed order (each warp's butterfly,
// then the warps in turn); every thread returns it. `part` holds a value a
// warp.
__device__ __forceinline__ double block_sum(double v, double* part) {
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  __syncthreads();  // `part` is free
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
  __syncthreads();
  double s = 0.0;
  for (int w = 0; w < kDla / 32; ++w) s += part[w];
  return s;
}

// 4. Per (b, h), one block: dla_t = <dh_final, h_final> + sum_{v >= t} dsc_v
// in double (thread i holds steps [i·per, (i + 1)·per): its sum, a suffix
// scan over the warp's lanes and over the warps, then a walk of its steps);
// ddt = e + A dla (e is in ddt), and the (b, h) parts of dA = sum dt dla and
// dD = sum ddg.
__global__ void __launch_bounds__(kDla) ssd_bwd_dla(
    float* __restrict__ ddt, float* __restrict__ da_bh, float* __restrict__ dd_bh,
    const float* __restrict__ dsc, const float* __restrict__ ddg,
    const float* __restrict__ dt, const float* __restrict__ A,
    const float* __restrict__ dh_final, const float* __restrict__ h_final, const int64_t L,
    const int H, const int64_t state_size) {
  __shared__ double part[kDla / 32];
  const int64_t bh = blockIdx.x;
  const int64_t b = bh / H;
  const int h = static_cast<int>(bh % H);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  double hf = 0.0;
  if (dh_final != nullptr)
    for (int64_t i = tid; i < state_size; i += kDla)
      hf += static_cast<double>(dh_final[bh * state_size + i]) * h_final[bh * state_size + i];
  hf = block_sum(hf, part);
  const int64_t per = (L + kDla - 1) / kDla;
  const int64_t lo = tid * per < L ? tid * per : L;
  const int64_t hi = lo + per < L ? lo + per : L;
  double mine = 0.0;
  for (int64_t t = lo; t < hi; ++t) mine += dsc[(b * L + t) * H + h];
  double incl = mine;  // sum over the warp's lanes >= this one
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double n = __shfl_down_sync(kFull, incl, o);
    if (lane + o < 32) incl += n;
  }
  double run = __shfl_down_sync(kFull, incl, 1);
  if (lane == 31) run = 0.0;
  __syncthreads();  // every thread has read `part`
  if (lane == 0) part[warp] = incl;
  __syncthreads();
  for (int w = warp + 1; w < kDla / 32; ++w) run += part[w];
  run += hf;
  const float a = A[h];
  double da = 0.0, dd = 0.0;
  for (int64_t t = hi - 1; t >= lo; --t) {
    const int64_t s = (b * L + t) * H + h;
    run += dsc[s];
    ddt[s] = static_cast<float>(ddt[s] + static_cast<double>(a) * run);
    da += static_cast<double>(dt[s]) * run;
    dd += ddg[s];
  }
  da = block_sum(da, part);
  dd = block_sum(dd, part);
  if (tid == 0) {
    da_bh[bh] = static_cast<float>(da);
    dd_bh[bh] = static_cast<float>(dd);
  }
}

// 5. dA[h] and dD[h]: the (b, h) parts summed over b in order.
__global__ void __launch_bounds__(kFold) ssd_bwd_fold_heads(
    float* __restrict__ dA, float* __restrict__ dD, const float* __restrict__ da_bh,
    const float* __restrict__ dd_bh, const int64_t B, const int H) {
  const int h = blockIdx.x * kFold + threadIdx.x;
  if (h >= H) return;
  float sa = 0.0f, sd = 0.0f;
  for (int64_t b = 0; b < B; ++b) {
    sa += da_bh[b * H + h];
    sd += dd_bh[b * H + h];
  }
  dA[h] = sa;
  if (dD != nullptr) dD[h] = sd;
}

__host__ __device__ constexpr int64_t round4(int64_t n) { return (n + 3) / 4 * 4; }

template <int NJ>
int launch_chunk(cudaStream_t st, T* dx, float* ddt, float* dsc, float* ddg, float* pB,
                 float* pC, const float* states, const float* gin, const T* x,
                 const T* dy, const float* dt, const float* A, const T* Bm,
                 const T* Cm, const float* D, int64_t B, int64_t L, int H, int P, int G,
                 int N, int cs, int nc, int hb, int vec4) {
  const int smem = 4 * chunk_smem_floats(32 * NJ);
  const cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_chunk<NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(nc), static_cast<unsigned>(B * H / hb), 1);
  const dim3 block(kThreads, 1, 1);
  ssd_bwd_chunk<NJ><<<grid, block, smem, st>>>(
      dx, ddt, dsc, ddg, pB, pC, states, gin, x, dy, dt, A, Bm, Cm, D, L, H, P, G, N, cs, nc,
      hb, vec4);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// Heads a chunk block takes (a divisor of the group's H / G): a whole group
// where the call has fewer blocks than the card has SMs, otherwise the most
// that keep at least four blocks an SM (kernels/ssd.py::bwd_heads_per_block
// computes the same).
extern "C" int heads_per_block(int64_t B, int64_t L, int64_t H, int64_t G, int64_t cs) {
  const int64_t rep = H / G, blocks = (L + cs - 1) / cs * B * H;
  if (blocks < kSMs) return static_cast<int>(rep);
  int64_t best = 1;
  for (int64_t d = 1; d <= rep; ++d)
    if (rep % d == 0 && blocks / d >= 4 * kSMs) best = d;
  return static_cast<int>(best);
}

// Shared memory of a chunk block at state size N, in floats.
extern "C" int64_t chunk_smem(int64_t N) { return chunk_smem_floats((N + 31) / 32 * 32); }

// Whether dB and dC are summed in the slices' f32 buffer and folded: where a
// group has more than one slice, and always at bf16 (rounded once, by the
// fold).
bool folds(int64_t ns) { return ns > 1 || kTwoByte; }

// f32 scratch of the backward: Gin of every chunk (B, nc, H, P, N); the
// slices' dB and dC (B, L, G·slices, N) where they fold; dy·(h C) - dt e and
// dy·x per step (B, L, H); the (b, h) parts of dA and dD. Each part starts
// on a 16-byte boundary.
extern "C" int64_t work_floats(int64_t B, int64_t L, int64_t H, int64_t P, int64_t G,
                               int64_t N, int64_t cs) {
  const int64_t nc = (L + cs - 1) / cs, ns = H / G / heads_per_block(B, L, H, G, cs);
  return round4(B * nc * H * P * N) + (folds(ns) ? 2 * round4(B * L * G * ns * N) : 0) +
         2 * round4(B * L * H) + 2 * round4(B * H);
}

// dh0 and dh_final (with h_final) may be null; N <= 128; states is the
// forward's (B, nc, H, P, N) chunk-start buffer at chunk cs.
extern "C" int launch(void* dx, void* ddt, void* dA, void* dB, void* dC, void* dD, void* dh0,
                      void* work, const void* dy, const void* dh_final, const void* h_final,
                      const void* states, const void* x, const void* dt, const void* A,
                      const void* Bm, const void* Cm, const void* D, int64_t B, int64_t L,
                      int64_t H, int64_t P, int64_t G, int64_t N, int64_t cs, int64_t nc,
                      int64_t work_size, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (N < 1 || N > 128 || cs < 1 || cs > kChunk || nc != (L + cs - 1) / cs ||
      work_size < work_floats(B, L, H, P, G, N, cs))
    return static_cast<int>(cudaErrorInvalidValue);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto s = [](const void* p) { return static_cast<const T*>(p); };
  const int hb = heads_per_block(B, L, H, G, cs);
  const int64_t ns = H / G / hb;
  float* w = static_cast<float*>(work);
  float* gin = w;
  float* pB = gin + round4(B * nc * H * P * N);
  float* pC = pB + (folds(ns) ? round4(B * L * G * ns * N) : 0);
  float* dsc = pC + (folds(ns) ? round4(B * L * G * ns * N) : 0);
  float* ddg = dsc + round4(B * L * H);
  float* da_bh = ddg + round4(B * L * H);
  float* dd_bh = da_bh + round4(B * H);
  if (!folds(ns)) {
    pB = static_cast<float*>(dB);
    pC = static_cast<float*>(dC);
  }
  const bool vec4 = P % 4 == 0 && N % 4 == 0 && aligned16(x) && aligned16(dy) &&
                    aligned16(Bm) && aligned16(Cm) && aligned16(states) && aligned16(dx) &&
                    aligned16(work) && aligned16(dB) && aligned16(dC) &&
                    (dh_final == nullptr || aligned16(dh_final)) &&
                    (dh0 == nullptr || aligned16(dh0));
  const int h = static_cast<int>(H), p = static_cast<int>(P), g = static_cast<int>(G);
  const int n = static_cast<int>(N), c = static_cast<int>(cs), k = static_cast<int>(nc);
  cudaError_t err = cudaFuncSetAttribute(ssd_bwd_gin,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kGinSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  {
    const dim3 grid(static_cast<unsigned>(B * H), static_cast<unsigned>((P + kTile - 1) / kTile),
                    static_cast<unsigned>((N + kTile - 1) / kTile));
    const dim3 block(kThreads, 1, 1);
    ssd_bwd_gin<<<grid, block, kGinSmem, st>>>(
        gin, static_cast<float*>(dh0), s(dy), f(dt), f(A), s(Cm), f(dh_final), L, h, p, g, n,
        c, k, vec4);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  int e = 0;
  auto ddtp = static_cast<float*>(ddt);
  auto dxp = static_cast<T*>(dx);
  switch ((N + 31) / 32) {
    case 1:
      e = launch_chunk<1>(st, dxp, ddtp, dsc, ddg, pB, pC, f(states), gin, s(x), s(dy), f(dt),
                          f(A), s(Bm), s(Cm), f(D), B, L, h, p, g, n, c, k, hb, vec4);
      break;
    case 2:
      e = launch_chunk<2>(st, dxp, ddtp, dsc, ddg, pB, pC, f(states), gin, s(x), s(dy), f(dt),
                          f(A), s(Bm), s(Cm), f(D), B, L, h, p, g, n, c, k, hb, vec4);
      break;
    case 3:
      e = launch_chunk<3>(st, dxp, ddtp, dsc, ddg, pB, pC, f(states), gin, s(x), s(dy), f(dt),
                          f(A), s(Bm), s(Cm), f(D), B, L, h, p, g, n, c, k, hb, vec4);
      break;
    default:
      e = launch_chunk<4>(st, dxp, ddtp, dsc, ddg, pB, pC, f(states), gin, s(x), s(dy), f(dt),
                          f(A), s(Bm), s(Cm), f(D), B, L, h, p, g, n, c, k, hb, vec4);
  }
  if (e != 0) return e;
  const dim3 fold(kFold, 1, 1);
  if (folds(ns)) {
    const int64_t total = B * L * G * N;
    const dim3 grid(static_cast<unsigned>((total + kFold - 1) / kFold), 1, 1);
    const dim3 block = fold;
    ssd_bwd_fold_slices<<<grid, block, 0, st>>>(
        static_cast<T*>(dB), static_cast<T*>(dC), pB, pC, total, g, n,
        static_cast<int>(ns));
  }
  {
    const dim3 grid(static_cast<unsigned>(B * H), 1, 1);
    const dim3 block(kDla, 1, 1);
    ssd_bwd_dla<<<grid, block, 0, st>>>(
        ddtp, da_bh, dd_bh, dsc, ddg, f(dt), f(A), f(dh_final), f(h_final), L, h, P * N);
  }
  {
    const dim3 grid(static_cast<unsigned>((H + kFold - 1) / kFold), 1, 1);
    const dim3 block = fold;
    ssd_bwd_fold_heads<<<grid, block, 0, st>>>(
        static_cast<float*>(dA), static_cast<float*>(dD), da_bh, dd_bh, B, h);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

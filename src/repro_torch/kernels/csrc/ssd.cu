// Hand-written CUDA kernels for the Mamba2 SSD (state-space duality)
// forward chunk scan (arXiv:2405.21060), on Hopper's tensor cores. For each
// batch row b and head h, over chunks of cs steps, with g = h / (H / G) the
// head's state group:
//
//   la[t]     = dt[t] * A[h],   lc = cumsum(la) within the chunk
//   y[t, p]   = exp(lc[t]) * sum_n C[t, n] h[p, n]                  (inter)
//             + sum_{u <= t} (C[t]·B[u]) exp(lc[t] - lc[u]) dt[u] x[u, p]
//             + D[h] x[t, p]                                         (skip)
//   h[p, n]  <- exp(lc[cs-1]) h[p, n]
//             + sum_u exp(lc[cs-1] - lc[u]) dt[u] x[u, p] B[u, n]
//
// with h starting from h0 (or zero) and returned after the last chunk.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd.py::ssd_chunk_scan
// (pl.pallas_call at :78, body _body at :27). x, B, C and y at the storage
// type T (storage.cuh: f32, or bf16 in the bf16 instance, as the TPU kernel
// takes the parameter dtype), converted to f32 as they are staged in shared
// memory (at bf16 by a load and a store, not cp.async); dt, A, D, h0, the
// states and h_final f32; f32 state and accumulation; y rounded once.
//
// What bounds it on the H100: bytes, once the products run on the tensor
// cores. At Zamba2's prefill (B = 4, L = 1024, H = 64, P = N = 64, G = 1,
// chunk 64) the products are 6.48 GFLOP over the causal triangles (0.097 ms
// on the CUDA cores at 67 TFLOP/s, 0.039 ms on the tensor cores at f32
// accuracy) for 141.6 MB of x, dt, B, C and y (0.042 ms at 3.35 TB/s).
//
// f32 accuracy on TF32 tensor cores (3xTF32, tf32x3.cuh). A TF32 operand
// keeps 10 mantissa bits, so one TF32 product is off by about 5e-4
// relative: outside the 1e-4 this kernel is held to against its plain f32
// version, and the state would carry that error across every chunk. Each
// f32 operand is split into a TF32 hi and a TF32 residual lo, and every
// product a·b is summed as a_lo·b_hi + a_hi·b_lo + a_hi·b_hi into f32
// accumulators (about 2^-21 relative): three TF32 products per f32
// product, 165 TFLOP/s f32-accurate.
//
// What the design does. Only the state passing between chunks is
// sequential (kernels/ref.py::ssd shows the algebra), so one call makes two
// launches, both on mma.sync.m16n8k8 tf32, 4 warps per block:
// 1. ssd_states_kernel, one block per (b, h, 64 p, 64 n): walks the chunks
//    with the (p, n) state in the mma accumulators' registers. Per chunk it
//    writes the state as the chunk's start state to a (B, nc, H, P, N)
//    buffer, then sums the chunk's own state (coeff ⊙ x)ᵀ·B on the tensor
//    cores in a fresh accumulator and adds it to exp(lc[cs-1])·h on the
//    CUDA cores (the state never passes through the tensor cores' adds,
//    which truncate); x and B of the next chunk load by cp.async into a
//    second stage meanwhile. At Zamba2's shapes that is 256 blocks, about two on
//    each SM: the kernel reads x and writes the states (134 MB), and the
//    double buffer keeps about 70 KB of loads in flight per SM.
// 2. ssd_output_kernel, one block per (chunk, 64 p, b·h): 4096 blocks at
//    Zamba2's shapes, three per SM. It loads x, B, C, dt and the start
//    state by cp.async and computes y = exp(lc) ⊙ (C·h_startᵀ) +
//    ((C·Bᵀ) ⊙ decay ⊙ dt)·x + D·x, every product on the tensor cores, the
//    decay masked before the exponential (W = 0 for u > t; the decays are
//    exp2f of the log decay in log2 units). Each warp owns 16 rows of the
//    chunk and skips the key tiles above its diagonal.
// x is read twice and the states written and read once: 335 MB in all at
// Zamba2's shapes. The chunk is min(chunk, 64) steps for every L
// (kernels/ssd.py::plan), the last one short where it does not divide L:
// the plain version's function at pick_chunk's chunk, summed in another
// order. Rows past the chunk or L are zero-filled, so every shape runs the
// same code. Operand permutations
// (as in csrc/attention.cu) make each fragment load a float4 free of bank
// conflicts: x, B rows in the state kernel and the state rows are padded
// to 4 mod 16 words; B and C in the output kernel are swizzled.
//
// What bounds it now: both kernels run far below the memory rate. The
// state kernel's 1024 warps each walk 16 chunks, a chain of products per
// chunk, about two blocks per SM; in the output kernel each warp splits
// the shared B, x and state tiles it reads, and a block's loads do not
// overlap its products.
#include <cstdint>
#include <cuda_runtime.h>

#include "tf32x3.cuh"
#include "storage.cuh"

namespace {

using namespace tf32x3;
using storage::T;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = 64;        // rows of a chunk tile: cs <= 64
constexpr int kTile = 64;         // p (and n) columns of a block
constexpr int kLdX = kTile + 4;   // words, = 4 mod 16
constexpr float kLog2e = 1.4426950408889634f;

// Word of column c of row r in a tile whose odd rows are swizzled by swz
// (0 or 16 words: flips bit 2 of the 16-byte chunk index).
__device__ __forceinline__ int swz_col(int r, int c, int swz) { return c ^ (r & 1 ? swz : 0); }

// Copy rows [0, kChunk) x columns [0, cols_tile) of a row-major global tile
// (row stride ldg) into shared memory (row stride lds, swizzled by swz);
// rows >= rows and columns >= cols are zero-filled. vec4: 16-byte copies
// (every column count, stride and base is a multiple of 4 elements and 16
// bytes at f32); storage values are converted to f32 (storage::copy4).
template <class S>
__device__ __forceinline__ void load_tile(float* s, int lds, int swz, const S* g,
                                          int64_t ldg, int rows, int cols, int cols_tile,
                                          bool vec4) {
  if (vec4) {
    const int chunks = cols_tile / 4;
    for (int i = threadIdx.x; i < kChunk * chunks; i += kThreads) {
      const int r = i / chunks, c = 4 * (i % chunks);
      const bool ok = r < rows && c < cols;
      storage::copy4(s + r * lds + swz_col(r, c, swz), ok ? g + r * ldg + c : g, ok);
    }
  } else {
    for (int i = threadIdx.x; i < kChunk * cols_tile; i += kThreads) {
      const int r = i / cols_tile, c = i % cols_tile;
      const bool ok = r < rows && c < cols;
      storage::copy1(s + r * lds + swz_col(r, c, swz), ok ? g + r * ldg + c : g, ok);
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
    const float n = __shfl_up_sync(0xffffffffu, s, off);
    if (lane >= off) s += n;
  }
  float e = __shfl_up_sync(0xffffffffu, s, 1);
  if (lane == 0) e = 0.0f;
  l0 = e + v0;
  l1 = l0 + v1;
}

// The accumulators acc[8][4] of a warp's 16 x 64 tile hold, for the row
// half (0: row g, 1: row g + 8) and column group q (32 columns), columns
// 32q + 8t + e, e = 0..7, at acc[4q + e % 4][e / 4 + 2·half].
__device__ __forceinline__ float& frag(float (&acc)[8][4], int q, int half, int e) {
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
template <bool kStore, typename T>
__device__ __forceinline__ void state_rows(float (&acc)[8][4], T* base, int prow, int t,
                                           int P, int N, int p0, int n0, bool vec4) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int p = p0 + prow + 8 * half;
    if (p >= P) continue;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int n = n0 + 32 * q + 8 * t;
      T* at = base + static_cast<int64_t>(p) * N + n;
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

constexpr int kStatesStage = 2 * kChunk * kLdX + kChunk;  // x, B, dt
constexpr int kStatesSmem = 4 * (2 * kStatesStage + kChunk + 4);

__global__ void __launch_bounds__(kThreads) ssd_states_kernel(
    float* __restrict__ states, float* __restrict__ hout, const T* __restrict__ x,
    const float* __restrict__ dt, const float* __restrict__ A, const T* __restrict__ Bm,
    const float* __restrict__ h0, const int64_t L, const int H, const int P, const int G,
    const int N, const int cs, const int nc, const int vec4) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* co = sm + 2 * kStatesStage;  // exp(lc[cs-1] - lc[u]) dt[u]
  float* decay = co + kChunk;         // exp(lc[cs-1])

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
  if (h0 != nullptr)
    state_rows<false>(acc, h0 + static_cast<int64_t>(bh) * state_size, prow, t, P, N, p0, n0,
                      vec4);

  auto load = [&](int stage, int c) {
    float* xs = sm + stage * kStatesStage;
    float* bs = xs + kChunk * kLdX;
    const int64_t r0 = static_cast<int64_t>(c) * cs;
    const int rows = L - r0 < cs ? static_cast<int>(L - r0) : cs;
    load_tile(xs, kLdX, 0, x + ((b * L + r0) * H + h) * P + p0, static_cast<int64_t>(H) * P,
              rows, pc, kTile, vec4);
    load_tile(bs, kLdX, 0, Bm + ((b * L + r0) * G + grp) * N + n0,
              static_cast<int64_t>(G) * N, rows, ncols, kTile, vec4);
    load_dt(bs + kChunk * kLdX, dt + (b * L + r0) * H + h, H, rows);
  };

  load(0, 0);
  cp_async_commit();
  for (int c = 0; c < nc; ++c) {
    cp_async_wait_all();
    __syncthreads();  // chunk c landed; every warp is done with chunk c - 1
    if (c + 1 < nc) load((c + 1) & 1, c + 1);
    cp_async_commit();
    const float* xs = sm + (c & 1) * kStatesStage;
    const float* bs = xs + kChunk * kLdX;
    if (warp == 0) {
      const float* dts = bs + kChunk * kLdX;
      float l0, l1;
      logcum(dts, a, lane, l0, l1);
      const float last = __shfl_sync(0xffffffffu, l1, 31);
      co[2 * lane] = expf(last - l0) * dts[2 * lane];
      co[2 * lane + 1] = expf(last - l1) * dts[2 * lane + 1];
      if (lane == 0) *decay = expf(last);
    }
    __syncthreads();

    // the state at the start of chunk c, then h <- decay·h + (coeff ⊙ x)ᵀ·B
    state_rows<true>(acc, states + ((static_cast<int64_t>(b) * nc + c) * H + h) * state_size,
                     prow, t, P, N, p0, n0, vec4);
    // the chunk's own state in a fresh accumulator, added to decay·h on
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
      // A[p][u] = coeff[u] x[u][p]: column t <-> u = 8ks + 2t, t + 4 <-> u + 1
      const int u = 8 * ks + 2 * t;
      const float c0 = co[u], c1 = co[u + 1];
      const float av[4] = {xs[u * kLdX + prow] * c0, xs[u * kLdX + prow + 8] * c0,
                           xs[(u + 1) * kLdX + prow] * c1, xs[(u + 1) * kLdX + prow + 8] * c1};
      uint32_t ah[4], al[4];
      split4(av, ah, al);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float4 v0 = *reinterpret_cast<const float4*>(bs + u * kLdX + 32 * q + 4 * g);
        const float4 v1 = *reinterpret_cast<const float4*>(bs + (u + 1) * kLdX + 32 * q + 4 * g);
        mma3(gacc[4 * q + 0], ah, al, v0.x, v1.x);
        mma3(gacc[4 * q + 1], ah, al, v0.y, v1.y);
        mma3(gacc[4 * q + 2], ah, al, v0.z, v1.z);
        mma3(gacc[4 * q + 3], ah, al, v0.w, v1.w);
      }
    }
    const float dec = *decay;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = acc[j][e] * dec + gacc[j][e];
    }
  }
  state_rows<true>(acc, hout + static_cast<int64_t>(bh) * state_size, prow, t, P, N, p0, n0,
                   vec4);
}

// Shared memory of one output block, in bytes. kernels/ssd.py::smem_bytes
// computes the same to refuse a shape before the launch; a CPU test
// evaluates this expression and kChunk, kTile, kLdX against it.
__host__ __device__ constexpr int out_smem_bytes(int npad) {
  return 4 * (kChunk * kLdX + 2 * kChunk * npad + kTile * (npad + 4) + 2 * kChunk);
}

__global__ void __launch_bounds__(kThreads, 3) ssd_output_kernel(
    T* __restrict__ y, const float* __restrict__ states, const T* __restrict__ x,
    const float* __restrict__ dt, const float* __restrict__ A, const T* __restrict__ Bm,
    const T* __restrict__ Cm, const float* __restrict__ D, const int64_t L, const int H,
    const int P, const int G, const int N, const int cs, const int nc, const int vec4) {
  extern __shared__ float4 smem4[];
  const int npad = (N + 15) & ~15;
  const int swz = npad % 32 ? 0 : 16;  // npad = 16 mod 32 rows need none
  const int ldh = npad + 4;            // = 4 mod 16 words
  float* xs = reinterpret_cast<float*>(smem4);  // [u][p]
  float* bs = xs + kChunk * kLdX;               // [u][n], swizzled
  float* cm = bs + kChunk * npad;               // [t][n], swizzled
  float* hs = cm + kChunk * npad;               // [p][n], the start state
  float* dts = hs + kTile * ldh;
  float* lc = dts + kChunk;

  const int c = blockIdx.x, p0 = blockIdx.y * kTile, bh = blockIdx.z;
  const int b = bh / H, h = bh % H, grp = h / (H / G);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int64_t r0 = static_cast<int64_t>(c) * cs;
  const int rows = L - r0 < cs ? static_cast<int>(L - r0) : cs;
  const int pc = P - p0 < kTile ? P - p0 : kTile;

  load_tile(xs, kLdX, 0, x + ((b * L + r0) * H + h) * P + p0, static_cast<int64_t>(H) * P,
            rows, pc, kTile, vec4);
  const int64_t bc = ((b * L + r0) * G + grp) * N;
  load_tile(bs, npad, swz, Bm + bc, static_cast<int64_t>(G) * N, rows, N, npad, vec4);
  load_tile(cm, npad, swz, Cm + bc, static_cast<int64_t>(G) * N, rows, N, npad, vec4);
  load_tile(hs, ldh, 0, states + (((static_cast<int64_t>(b) * nc + c) * H + h) * P + p0) * N,
            N, pc, N, npad, vec4);
  load_dt(dts, dt + (b * L + r0) * H + h, H, rows);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  if (warp == 0) {  // lc in log2 units: every decay below is an exp2f
    float l0, l1;
    logcum(dts, A[h], lane, l0, l1);
    lc[2 * lane] = l0 * kLog2e;
    lc[2 * lane + 1] = l1 * kLog2e;
  }
  __syncthreads();

  const int t0 = 16 * warp + g;  // this thread's rows t0, t0 + 8
  if (16 * warp >= rows) return;
  const int tmax = 16 * warp + 15 < rows - 1 ? 16 * warp + 15 : rows - 1;
  const int jmax = tmax / 8;  // key tiles u < 8 (jmax + 1) reach the diagonal

  float yacc[8][4], s[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    yacc[j][0] = yacc[j][1] = yacc[j][2] = yacc[j][3] = 0.0f;
    s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
  }
  // y = C·h_startᵀ and S = C·Bᵀ over n (C's column t <-> n = 16i + 4t, two
  // k-steps per float4)
  for (int i = 0; i < npad / 16; ++i) {
    const int col = 16 * i + 4 * t;
    const float4 ca = *reinterpret_cast<const float4*>(cm + t0 * npad + swz_col(t0, col, swz));
    const float4 cb =
        *reinterpret_cast<const float4*>(cm + (t0 + 8) * npad + swz_col(t0 + 8, col, swz));
    const float a0[4] = {ca.x, cb.x, ca.y, cb.y}, a1[4] = {ca.z, cb.z, ca.w, cb.w};
    uint32_t ah0[4], al0[4], ah1[4], al1[4];
    split4(a0, ah0, al0);
    split4(a1, ah1, al1);
#pragma unroll
    for (int q = 0; q < 2; ++q) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 hv = *reinterpret_cast<const float4*>(hs + (32 * q + 4 * g + j) * ldh + col);
        mma3(yacc[4 * q + j], ah0, al0, hv.x, hv.y);
        mma3(yacc[4 * q + j], ah1, al1, hv.z, hv.w);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (j > jmax) break;
      const int u = 8 * j + g;
      const float4 bv = *reinterpret_cast<const float4*>(bs + u * npad + swz_col(u, col, swz));
      mma3(s[j], ah0, al0, bv.x, bv.y);
      mma3(s[j], ah1, al1, bv.z, bv.w);
    }
  }
  const float lrow[2] = {lc[t0], lc[t0 + 8]};
  const float e0 = exp2f(lrow[0]), e1 = exp2f(lrow[1]);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    yacc[j][0] *= e0; yacc[j][1] *= e0; yacc[j][2] *= e1; yacc[j][3] *= e1;
  }
  // y += W·x, W = (C·Bᵀ) ⊙ exp(lc[t] - lc[u]) ⊙ dt[u] for u <= t, else 0;
  // S's accumulator is W's A operand (column t <-> u = 2t, t + 4 <-> 2t + 1)
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (j > jmax) break;
    float w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = t0 + 8 * (e >> 1), u = 8 * j + 2 * t + (e & 1);
      w[e] = u <= row ? s[j][e] * exp2f(lrow[e >> 1] - lc[u]) * dts[u] : 0.0f;
    }
    const float wa[4] = {w[0], w[2], w[1], w[3]};
    uint32_t ah[4], al[4];
    split4(wa, ah, al);
    const int u = 8 * j + 2 * t;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const float4 v0 = *reinterpret_cast<const float4*>(xs + u * kLdX + 32 * q + 4 * g);
      const float4 v1 = *reinterpret_cast<const float4*>(xs + (u + 1) * kLdX + 32 * q + 4 * g);
      mma3(yacc[4 * q + 0], ah, al, v0.x, v1.x);
      mma3(yacc[4 * q + 1], ah, al, v0.y, v1.y);
      mma3(yacc[4 * q + 2], ah, al, v0.z, v1.z);
      mma3(yacc[4 * q + 3], ah, al, v0.w, v1.w);
    }
  }
  // + D·x, then y's rows t < rows, columns p < P
  const float dsk = D != nullptr ? D[h] : 0.0f;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = t0 + 8 * half;
    if (row >= rows) continue;
    T* yrow = y + ((b * L + r0 + row) * H + h) * P + p0;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int p = 32 * q + 8 * t;
      float v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        v[e] = frag(yacc, q, half, e);
        if (D != nullptr) v[e] += xs[row * kLdX + p + e] * dsk;
      }
      store8(yrow + p, pc - p, vec4, v);
    }
  }
}

}  // namespace

// Two launches: the chunk states (and h_final), then y. states is a
// (B, nc, H, P, N) f32 buffer; cs <= 64 and nc = ceil(L / cs); vec4 says
// that P, N and every pointer allow 16-byte copies.
extern "C" int launch(void* y, void* hout, void* states, const void* x, const void* dt,
                      const void* A, const void* Bm, const void* Cm, const void* D,
                      const void* h0, int64_t B, int64_t L, int64_t H, int64_t P, int64_t G,
                      int64_t N, int64_t cs, int64_t nc, int64_t vec4, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const int out_smem = out_smem_bytes(static_cast<int>((N + 15) & ~15));
  cudaError_t err = cudaFuncSetAttribute(
      ssd_states_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kStatesSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_output_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, out_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ptiles = static_cast<int>((P + kTile - 1) / kTile);
  const int ntiles = static_cast<int>((N + kTile - 1) / kTile);
  const int h = static_cast<int>(H), p = static_cast<int>(P), g = static_cast<int>(G);
  const int n = static_cast<int>(N), c = static_cast<int>(cs), k = static_cast<int>(nc);
  const int v4 = static_cast<int>(vec4);
  ssd_states_kernel<<<dim3(static_cast<unsigned>(B * H), ptiles, ntiles), kThreads,
                      kStatesSmem, st>>>(
      static_cast<float*>(states), static_cast<float*>(hout), static_cast<const T*>(x),
      static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const T*>(Bm), static_cast<const float*>(h0), L, h, p, g, n, c, k, v4);
  err = cudaGetLastError();
  if (err != cudaSuccess || nc == 0) return static_cast<int>(err);
  ssd_output_kernel<<<dim3(static_cast<unsigned>(nc), ptiles, static_cast<unsigned>(B * H)),
                      kThreads, out_smem, st>>>(
      static_cast<T*>(y), static_cast<const float*>(states),
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const float*>(D), L, h, p, g, n, c, k, v4);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

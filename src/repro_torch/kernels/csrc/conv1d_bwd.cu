// Hand-written CUDA kernels for the backward pass of Mamba2's causal
// depthwise short convolution (csrc/conv1d.cu is the forward):
//
//   pre[b, t, c] = sum_{d<K} w[d, c] x[b, t-d, c] + bias[c],
//   out = SiLU(pre) or pre.
//
// Given g = dL/dout, with gp = g * SiLU'(pre) (or g without the SiLU):
//
//   dx[b, s, c] = sum_{d<K, s+d<L} w[d, c] gp[b, s+d, c]
//   dw[d, c]    = sum_{b, t} gp[b, t, c] x[b, t-d, c]
//   dbias[c]    = sum_{b, t} gp[b, t, c]
//
// The TPU kernel src/repro/kernels/conv1d.py::conv1d_causal (pl.pallas_call
// at :44) has no backward: the reference differentiates its chunked jnp twin
// (src/repro/kernels/ops.py:224-230). This kernel is the gradient of the
// port's forward kernel, which training runs inside a torch.autograd.Function
// (kernels/conv1d.py::Conv1dFn).
//
// What bounds it on the H100: bytes. It reads x and g and writes dx (12 bytes
// per element at f32, 6 at bf16) against about 6K + 8 f32 operations per
// element, far below the card's ratio of f32 operations to bytes. Streaming at the memory rate
// needs about 15-20 KB of loads in flight on each SM.
//
// What the design does: the forward's tiles. A block covers 32 x VEC
// channels by `tile` positions [t0, t0 + tile) (kernels/conv1d.py::layout:
// 32 or 16, so that mamba2-130m's training shape too gives several blocks
// an SM). Its 128 threads first issue every load it needs at once, as
// cp.async copies of x and g at their storage type T (storage.cuh) into
// shared memory (4 channels a copy at VEC = 4, else one; see
// conv1d_tiles.cuh): x over the tile and K-1 positions on each side, g over
// the tile and the K-1 after it. Then gp is computed in f32 once for each of
// those tile + K - 1 positions, in place of g at f32 (in rows of its own at
// bf16), each thread marching a run of positions with its last K inputs in
// registers; the same window gives its partial dw and dbias over the tile's
// positions. After a barrier each thread computes dx over its
// run from the K gp that follow each position. The block then sums its
// threads' partials through shared memory in a fixed order and writes one
// partial row (K + 1 values a channel); a second launch folds the rows of each
// (d, c) in a fixed order, its threads each summing a strided share of the
// rows with their loads in flight together, and rounds each once to T. No
// atomics: the same bits on every call.
//
// K up to kMaxK (one instance per K and VEC); the wrapper refuses a larger K.
#include <cstdint>
#include <cuda_runtime.h>
#include "tf32x3.cuh"
#include "storage.cuh"
#include "conv1d_tiles.cuh"

namespace {

using namespace conv1d_tiles;
using tf32x3::cp_async_commit;
using tf32x3::cp_async_wait_all;
constexpr int kFoldRows = 8;          // threads of a fold block along the rows

// SiLU'(v) = s (1 + v (1 - s)), s = sigmoid(v), with the forward's expf
__device__ __forceinline__ float silu_grad(float v) {
  const float s = 1.0f / (1.0f + expf(-v));
  return s * (1.0f + v * (1.0f - s));
}

// Shared memory of a block in floats: x's rows (tile + 2(K-1)) and g's (tile
// + K - 1) of 32 x VEC channels of T, gp in g's rows at f32 and in tile + K
// - 1 rows of f32 after them at bf16; the partials' kRows x (K + 1) f32 rows
// reuse it. kernels/conv1d.py::bwd_smem_floats computes the same.
__host__ __device__ constexpr int bwd_smem_floats(int K, int vec, int tile) {
  return ((2 * tile + 3 * (K - 1)) * static_cast<int>(sizeof(T)) +
                      (kTwoByte ? (tile + K - 1) * 4 : 0) >
                  kRows * (K + 1) * 4
              ? (2 * tile + 3 * (K - 1)) * static_cast<int>(sizeof(T)) +
                    (kTwoByte ? (tile + K - 1) * 4 : 0)
              : kRows * (K + 1) * 4) *
         kLanes * vec / 4;
}

// grid (ceil(L / tile), ceil(C / (32 VEC)), B), block (32, 4). part: one row
// of (K + 1) x C a block, row b * gridDim.x + blockIdx.x: dw[0..K-1], dbias.
template <int K, int VEC>
__global__ void __launch_bounds__(kThreads) conv1d_bwd_tile(
    T* __restrict__ dx, float* __restrict__ part, const T* __restrict__ g,
    const T* __restrict__ x, const T* __restrict__ w,
    const T* __restrict__ bias, const int64_t L, const int64_t C, const int tile,
    const int silu) {
  extern __shared__ float smem[];
  constexpr int kWidth = kLanes * VEC;   // channels of the tile, a row of smem
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * tile;
  const int64_t c0 = static_cast<int64_t>(blockIdx.y) * kWidth;
  const int64_t slab = static_cast<int64_t>(blockIdx.z) * L * C;
  // xs row r: x at t0 - (K-1) + r; gs row r: g at t0 + r, and gps row r gp
  // there (gs's own rows at f32)
  T* const xs = reinterpret_cast<T*>(smem);
  T* const gs = xs + (tile + 2 * (K - 1)) * kWidth;
  float* const gps = reinterpret_cast<float*>(kTwoByte ? gs + (tile + K - 1) * kWidth : gs);
  stage<VEC>(xs, x + slab, t0 - (K - 1), tile + 2 * (K - 1), L, C, c0);
  stage<VEC>(gs, g + slab, t0, tile + K - 1, L, C, c0);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  const int64_t c = c0 + threadIdx.x * VEC;
  const bool live = c < C;               // every thread reaches every barrier
  const int col = threadIdx.x * VEC;     // the thread's channels in a row of smem
  float wr[K][VEC], bc[VEC], dw[K][VEC], db[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
#pragma unroll
    for (int d = 0; d < K; ++d) {
      wr[d][v] = live ? widen(w[d * C + c + v]) : 0.0f;
      dw[d][v] = 0.0f;
    }
    bc[v] = live ? widen(bias[c + v]) : 0.0f;
    db[v] = 0.0f;
  }
  const int run = tile / kRows;
  const int r0 = threadIdx.y * run;      // the thread's first row of the tile
  // gp at rows [r0, r0 + run) and, for the last row of threads, the K-1
  // rows after the tile (which dx needs); dw and dbias over the tile's rows
  const int r1 = threadIdx.y == kRows - 1 ? tile + K - 1 : r0 + run;
  // win[k] = x at row r - (K-1) + k for gp's row r: xs row r + k
  float win[K][VEC];
#pragma unroll
  for (int k = 0; k < K - 1; ++k) load_vec<VEC>(win[k], xs + (r0 + k) * kWidth + col);
  for (int r = r0; r < r1; ++r) {
    load_vec<VEC>(win[K - 1], xs + (r + K - 1) * kWidth + col);
    float gp[VEC];
    load_vec<VEC>(gp, gs + r * kWidth + col);
    if (silu) {
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        float pre = 0.0f;
#pragma unroll
        for (int k = 0; k < K; ++k) pre = pre + win[k][v] * wr[K - 1 - k][v];
        gp[v] *= silu_grad(pre + bc[v]);
      }
    }
    store_vec<VEC>(gps + r * kWidth + col, gp);
    if (r < tile) {
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
#pragma unroll
        for (int d = 0; d < K; ++d) dw[d][v] += gp[v] * win[K - 1 - d][v];
        db[v] += gp[v];
      }
    }
#pragma unroll
    for (int k = 0; k < K - 1; ++k) {
#pragma unroll
      for (int v = 0; v < VEC; ++v) win[k][v] = win[k + 1][v];
    }
  }
  __syncthreads();

  // dx over the run: gw[d] = gp at row s + d
  float gw[K][VEC];
#pragma unroll
  for (int d = 0; d < K - 1; ++d) load_vec<VEC>(gw[d], gps + (r0 + d) * kWidth + col);
  T* const dxb = dx + slab + c;
  for (int s = r0; s < r0 + run; ++s) {
    load_vec<VEC>(gw[K - 1], gps + (s + K - 1) * kWidth + col);
    if (live && t0 + s < L) {
      float acc[VEC];
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        acc[v] = 0.0f;
#pragma unroll
        for (int d = 0; d < K; ++d) acc[v] += wr[d][v] * gw[d][v];
      }
      store_vec<VEC>(dxb + (t0 + s) * C, acc);
    }
#pragma unroll
    for (int d = 0; d < K - 1; ++d) {
#pragma unroll
      for (int v = 0; v < VEC; ++v) gw[d][v] = gw[d + 1][v];
    }
  }
  __syncthreads();                       // every read of xs and gs done

  // the threads' partials, red[y][d][channel] (d = K: dbias), summed over y
  // in order into the block's row of part
  float* const red = smem;
#pragma unroll
  for (int d = 0; d < K; ++d) {
    store_vec<VEC>(red + (threadIdx.y * (K + 1) + d) * kWidth + col, dw[d]);
  }
  store_vec<VEC>(red + (threadIdx.y * (K + 1) + K) * kWidth + col, db);
  __syncthreads();
  float* const row = part + (static_cast<int64_t>(blockIdx.z) * gridDim.x + blockIdx.x) *
                                (K + 1) * C;
  for (int i = threadIdx.y * kLanes + threadIdx.x; i < (K + 1) * kWidth; i += kThreads) {
    const int d = i / kWidth, cc = i % kWidth;
    if (c0 + cc >= C) continue;
    float acc = red[d * kWidth + cc];
#pragma unroll
    for (int y = 1; y < kRows; ++y) acc += red[(y * (K + 1) + d) * kWidth + cc];
    row[d * C + c0 + cc] = acc;
  }
}

// dw[d, c] (d < K) and dbias[c] (d = K): the partial rows summed in a fixed
// order, then rounded to T. Block (32, 8): lane l of the block's 32 columns,
// thread y sums rows y, y + 8, ... (their loads issued together), then
// thread 0 of each column adds the 8 sums in order. Grid ceil((K + 1) C /
// 32).
__global__ void __launch_bounds__(kLanes * kFoldRows) conv1d_bwd_fold(
    T* __restrict__ dw, T* __restrict__ db, const float* __restrict__ part,
    const int64_t rows, const int64_t C, const int64_t K) {
  extern __shared__ float smem[];
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kLanes + threadIdx.x;
  const int64_t width = (K + 1) * C;
  float acc = 0.0f;
  if (i < width) {
#pragma unroll 4
    for (int64_t r = threadIdx.y; r < rows; r += kFoldRows) acc += part[r * width + i];
  }
  smem[threadIdx.y * kLanes + threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y != 0 || i >= width) return;
  float sum = smem[threadIdx.x];
#pragma unroll
  for (int y = 1; y < kFoldRows; ++y) sum += smem[y * kLanes + threadIdx.x];
  if (i < K * C) {
    dw[i] = narrow<T>(sum);
  } else {
    db[i - K * C] = narrow<T>(sum);
  }
}

int launch_fold(dim3 grid, cudaStream_t st, T* dw, T* db, const float* part,
                int64_t rows, int64_t C, int64_t K) {
  const dim3 block(kLanes, kFoldRows, 1);
  const int smem = kLanes * kFoldRows * static_cast<int>(sizeof(float));
  conv1d_bwd_fold<<<grid, block, smem, st>>>(
      dw, db, part, rows, C, K);
  return static_cast<int>(cudaGetLastError());
}

template <int K, int VEC>
int launch_tile(dim3 grid, cudaStream_t st, T* dx, float* part, const T* g,
                const T* x, const T* w, const T* bias, int64_t L, int64_t C,
                int tile, int silu) {
  const dim3 block(kLanes, kRows, 1);
  const int smem = bwd_smem_floats(K, VEC, tile) * static_cast<int>(sizeof(float));
  const cudaError_t set = cudaFuncSetAttribute(
      conv1d_bwd_tile<K, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (set != cudaSuccess) return static_cast<int>(set);
  conv1d_bwd_tile<K, VEC><<<grid, block, smem, st>>>(
      dx, part, g, x, w, bias, L, C, tile, silu);
  return static_cast<int>(cudaGetLastError());
}

template <int K>
int launch_k(dim3 grid, cudaStream_t st, int vec, T* dx, float* part, const T* g,
             const T* x, const T* w, const T* bias, int64_t L, int64_t C,
             int tile, int silu) {
  return vec == 4 ? launch_tile<K, 4>(grid, st, dx, part, g, x, w, bias, L, C, tile, silu)
                  : launch_tile<K, 1>(grid, st, dx, part, g, x, w, bias, L, C, tile, silu);
}

}  // namespace

// part: (B * ceil(L / tile), K + 1, C) f32 scratch; K <= kMaxK; vec and tile
// as the forward's (kernels/conv1d.py::layout), vec 4 needing g, x and dx
// 16-byte aligned.
extern "C" int launch(void* dx, void* dw, void* db, void* part, const void* g,
                      const void* x, const void* w, const void* bias, int64_t B, int64_t L,
                      int64_t C, int64_t K, int64_t vec, int64_t tile, int64_t silu,
                      void* stream) {
  if (K < 1 || K > kMaxK || !takes(C, vec, tile, aligned16(g) && aligned16(x) && aligned16(dx)))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((L + tile - 1) / tile),
                  static_cast<unsigned>((C + kLanes * vec - 1) / (kLanes * vec)),
                  static_cast<unsigned>(B));
  auto st = static_cast<cudaStream_t>(stream);
  auto dxo = static_cast<T*>(dx);
  auto pt = static_cast<float*>(part);
  auto gi = static_cast<const T*>(g);
  auto xi = static_cast<const T*>(x);
  auto wi = static_cast<const T*>(w);
  auto bi = static_cast<const T*>(bias);
  const int s = static_cast<int>(silu), v = static_cast<int>(vec), tl = static_cast<int>(tile);
  int err = 0;
  switch (K) {
    case 1: err = launch_k<1>(grid, st, v, dxo, pt, gi, xi, wi, bi, L, C, tl, s); break;
    case 2: err = launch_k<2>(grid, st, v, dxo, pt, gi, xi, wi, bi, L, C, tl, s); break;
    case 3: err = launch_k<3>(grid, st, v, dxo, pt, gi, xi, wi, bi, L, C, tl, s); break;
    case 4: err = launch_k<4>(grid, st, v, dxo, pt, gi, xi, wi, bi, L, C, tl, s); break;
    case 5: err = launch_k<5>(grid, st, v, dxo, pt, gi, xi, wi, bi, L, C, tl, s); break;
    case 6: err = launch_k<6>(grid, st, v, dxo, pt, gi, xi, wi, bi, L, C, tl, s); break;
    case 7: err = launch_k<7>(grid, st, v, dxo, pt, gi, xi, wi, bi, L, C, tl, s); break;
    default: err = launch_k<kMaxK>(grid, st, v, dxo, pt, gi, xi, wi, bi, L, C, tl, s); break;
  }
  if (err != 0) return err;
  const dim3 fold_grid(static_cast<unsigned>(((K + 1) * C + kLanes - 1) / kLanes), 1, 1);
  return launch_fold(fold_grid, st, static_cast<T*>(dw), static_cast<T*>(db), pt,
                     B * static_cast<int64_t>(grid.x), C, K);
}

extern "C" int64_t smem_floats(int64_t K, int64_t vec, int64_t tile) {
  return bwd_smem_floats(static_cast<int>(K), static_cast<int>(vec), static_cast<int>(tile));
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

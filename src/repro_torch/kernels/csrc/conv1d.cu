// Hand-written CUDA kernel for Mamba2's causal depthwise short convolution:
//
//   out[b, t, c] = act( sum_{d=0}^{K-1} w[d, c] * x[b, t-d, c] + bias[c] ),
//   x[b, t-d, c] = 0 where t - d < 0,   act = SiLU (x * sigmoid(x)) or none.
//
// Replaces the Pallas TPU kernel src/repro/kernels/conv1d.py::conv1d_causal
// (pl.pallas_call at :44, body _body at :23). x, w, bias and out at the
// storage type T (storage.cuh: f32, or bf16 in the bf16 instance, as the TPU
// kernel takes the parameter dtype), f32 accumulation, out rounded once.
//
// What bounds it on the H100: bytes. Each output reads K inputs that its
// K-1 predecessors along t read too, so the function needs x read once and
// out written once (8 bytes per element) against 2K + 5 f32 operations per
// element (about 13 at K = 4), far below the card's ratio of f32 operations
// to memory bytes (about 20): the kernel cannot beat 8 bytes per element
// (4 at bf16) over the memory rate. Streaming at that rate needs about 15-20 KB of loads
// in flight on each SM.
//
// What the design does about it: a block covers a tile of 32 x VEC channels
// (C, the contiguous axis) by `tile` positions (kernels/conv1d.py::layout
// picks 32 or 16, so that even mamba2-130m's 1792 channels give 16 blocks an
// SM). Its 128 threads first issue every load of the tile and of the K-1
// positions before it at once, as cp.async copies of x at its storage type
// into shared memory (4 channels a copy where VEC = 4, 16 bytes at f32 and 8
// at bf16: C a multiple of 4 and x and out 16-byte aligned; else one channel
// a thread, 4 bytes by cp.async at f32, a 2-byte load and store at bf16), so
// no thread waits on one load at a time and a block has its whole
// window in flight (about 18 KB at a tile of 32, several blocks an SM). Then
// each thread owns VEC adjacent channels and a run of tile / 4 positions,
// marches along it with the last K inputs converted to f32 in registers and
// writes VEC outputs a position (one store).
//
// The taps are summed from the oldest input to the newest, then the bias,
// which is the plain version's order (kernels/ref.py), and the build passes
// --fmad=false, so the sum agrees with the plain version bitwise; SiLU uses
// expf and a division, which gave PyTorch's sigmoid bit for bit on the card.
//
// K up to kMaxK has one instance per K and VEC; a larger K takes the generic
// kernel (one channel a thread, the taps read through L1), right but slow.
#include <cstdint>
#include <cuda_runtime.h>
#include "tf32x3.cuh"
#include "storage.cuh"
#include "conv1d_tiles.cuh"

namespace {

using namespace conv1d_tiles;
using tf32x3::cp_async_commit;
using tf32x3::cp_async_wait_all;

__device__ __forceinline__ float activate(float v, int silu) {
  return silu ? v * (1.0f / (1.0f + expf(-v))) : v;
}

// Shared memory of a block in floats: tile + K - 1 rows of 32 x VEC
// channels of T. kernels/conv1d.py::smem_floats computes the same.
constexpr int tile_smem_floats(int K, int vec, int tile) {
  return (tile + K - 1) * kLanes * vec * static_cast<int>(sizeof(T)) / 4;
}

// grid (ceil(L / tile), ceil(C / (32 VEC)), B), block (32, 4)
template <int K, int VEC>
__global__ void __launch_bounds__(kThreads) conv1d_tile(
    T* __restrict__ out, const T* __restrict__ x, const T* __restrict__ w,
    const T* __restrict__ bias, const int64_t L, const int64_t C, const int tile,
    const int silu) {
  extern __shared__ float smem[];
  T* const xt = reinterpret_cast<T*>(smem);
  constexpr int kWidth = kLanes * VEC;   // channels of the tile, a row of smem
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * tile;
  const int64_t c0 = static_cast<int64_t>(blockIdx.y) * kWidth;
  const int64_t slab = static_cast<int64_t>(blockIdx.z) * L * C;
  // smem row r holds position t0 - (K-1) + r
  stage<VEC>(xt, x + slab, t0 - (K - 1), tile + K - 1, L, C, c0);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  const int64_t c = c0 + threadIdx.x * VEC;
  if (c >= C) return;                    // no barrier follows
  float wr[K][VEC], bc[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
#pragma unroll
    for (int d = 0; d < K; ++d) wr[d][v] = widen(w[d * C + c + v]);
    bc[v] = widen(bias[c + v]);
  }
  const int run = tile / kRows;
  const int r0 = threadIdx.y * run;      // the thread's first row of outputs
  const T* xs = xt + threadIdx.x * VEC;
  // win[k] = x[t - (K-1) + k] for the output at t; win[K-1] the newest
  float win[K][VEC];
#pragma unroll
  for (int k = 0; k < K - 1; ++k) load_vec<VEC>(win[k], xs + (r0 + k) * kWidth);
  T* ob = out + slab + c;
  for (int j = 0; j < run; ++j) {
    const int64_t t = t0 + r0 + j;
    if (t >= L) break;
    load_vec<VEC>(win[K - 1], xs + (r0 + j + K - 1) * kWidth);
    float o[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < K; ++k) acc = acc + win[k][v] * wr[K - 1 - k][v];
      acc = acc + bc[v];
      o[v] = activate(acc, silu);
    }
    store_vec<VEC>(ob + t * C, o);
#pragma unroll
    for (int k = 0; k < K - 1; ++k) {
#pragma unroll
      for (int v = 0; v < VEC; ++v) win[k][v] = win[k + 1][v];
    }
  }
}

// any K: one channel a thread, the taps read through L1; grid (ceil(L /
// tile), ceil(C / 32), B), block (32, 4)
__global__ void __launch_bounds__(kThreads) conv1d_any(
    T* __restrict__ out, const T* __restrict__ x, const T* __restrict__ w,
    const T* __restrict__ bias, const int64_t L, const int64_t C, const int tile,
    const int K, const int silu) {
  const int64_t c = static_cast<int64_t>(blockIdx.y) * kLanes + threadIdx.x;
  if (c >= C) return;
  const int run = tile / kRows;
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * tile + threadIdx.y * run;
  const int64_t slab = static_cast<int64_t>(blockIdx.z) * L * C;
  const T* xb = x + slab + c;
  T* ob = out + slab + c;
  const float bc = widen(bias[c]);
  for (int64_t t = t0; t < t0 + run && t < L; ++t) {
    float acc = 0.0f;
    for (int k = 0; k < K; ++k) {
      const int64_t s = t - (K - 1) + k;
      const float xv = s >= 0 ? widen(xb[s * C]) : 0.0f;
      acc = acc + xv * widen(w[static_cast<int64_t>(K - 1 - k) * C + c]);
    }
    acc = acc + bc;
    ob[t * C] = narrow<T>(activate(acc, silu));
  }
}

template <int K, int VEC>
int launch_tile(dim3 grid, cudaStream_t st, T* out, const T* x, const T* w,
                const T* bias, int64_t L, int64_t C, int tile, int silu) {
  const dim3 block(kLanes, kRows, 1);
  const int smem = tile_smem_floats(K, VEC, tile) * static_cast<int>(sizeof(float));
  conv1d_tile<K, VEC><<<grid, block, smem, st>>>(
      out, x, w, bias, L, C, tile, silu);
  return static_cast<int>(cudaGetLastError());
}

template <int K>
int launch_k(dim3 grid, cudaStream_t st, int vec, T* out, const T* x, const T* w,
             const T* bias, int64_t L, int64_t C, int tile, int silu) {
  return vec == 4 ? launch_tile<K, 4>(grid, st, out, x, w, bias, L, C, tile, silu)
                  : launch_tile<K, 1>(grid, st, out, x, w, bias, L, C, tile, silu);
}

}  // namespace

// vec: channels a thread owns, 4 (C a multiple of 4, x and out 16-byte
// aligned) or 1; tile: positions a block covers, 16 or 32 (the wrapper's
// kernels/conv1d.py::layout); vec 1 for K > kMaxK.
extern "C" int launch(void* out, const void* x, const void* w, const void* bias,
                      int64_t B, int64_t L, int64_t C, int64_t K, int64_t vec, int64_t tile,
                      int64_t silu, void* stream) {
  if (K < 1 || (vec == 4 && K > kMaxK) ||
      !takes(C, vec, tile, aligned16(x) && aligned16(out)))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((L + tile - 1) / tile),
                  static_cast<unsigned>((C + kLanes * vec - 1) / (kLanes * vec)),
                  static_cast<unsigned>(B));
  auto st = static_cast<cudaStream_t>(stream);
  auto o = static_cast<T*>(out);
  auto xi = static_cast<const T*>(x);
  auto wi = static_cast<const T*>(w);
  auto bi = static_cast<const T*>(bias);
  const int s = static_cast<int>(silu), v = static_cast<int>(vec), tl = static_cast<int>(tile);
  switch (K) {
    case 1: return launch_k<1>(grid, st, v, o, xi, wi, bi, L, C, tl, s);
    case 2: return launch_k<2>(grid, st, v, o, xi, wi, bi, L, C, tl, s);
    case 3: return launch_k<3>(grid, st, v, o, xi, wi, bi, L, C, tl, s);
    case 4: return launch_k<4>(grid, st, v, o, xi, wi, bi, L, C, tl, s);
    case 5: return launch_k<5>(grid, st, v, o, xi, wi, bi, L, C, tl, s);
    case 6: return launch_k<6>(grid, st, v, o, xi, wi, bi, L, C, tl, s);
    case 7: return launch_k<7>(grid, st, v, o, xi, wi, bi, L, C, tl, s);
    case kMaxK: return launch_k<kMaxK>(grid, st, v, o, xi, wi, bi, L, C, tl, s);
    default: {
      const dim3 block(kLanes, kRows, 1);
      conv1d_any<<<grid, block, 0, st>>>(
          o, xi, wi, bi, L, C, tl, static_cast<int>(K), s);
      return static_cast<int>(cudaGetLastError());
    }
  }
}

// shared memory of a block in floats; none in the generic kernel
extern "C" int64_t smem_floats(int64_t K, int64_t vec, int64_t tile) {
  return K <= kMaxK ? tile_smem_floats(static_cast<int>(K), static_cast<int>(vec),
                                       static_cast<int>(tile))
                    : 0;
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

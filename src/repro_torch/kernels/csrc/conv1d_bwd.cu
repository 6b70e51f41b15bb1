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
// per element) against about 4K + 12 f32 operations per element, far below
// the card's ratio of f32 operations to bytes.
//
// What the design does: the forward's layout. A thread owns one channel c of
// one batch row and a segment of t, and marches along t with the last K
// inputs (to recompute pre and SiLU') and the last K values of gp in
// registers, so x and g are read once per segment plus a K-1 halo; threadIdx.x
// runs along c, so a warp's loads and stores coalesce. dw and dbias are summed
// per thread over its segment into a partial row (B x segments rows of
// (K + 1) x C values), and a second launch folds the rows of each (d, c) in
// a fixed order: no atomics, the same bits on every call.
//
// K up to kMaxK (one template instance per K); the wrapper refuses a larger K.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxK = 8;

// SiLU'(v) = s (1 + v (1 - s)), s = sigmoid(v), with the forward's expf
__device__ __forceinline__ float silu_grad(float v) {
  const float s = 1.0f / (1.0f + expf(-v));
  return s * (1.0f + v * (1.0f - s));
}

template <int K>
__global__ void __launch_bounds__(kThreads) conv1d_bwd_kernel(
    float* __restrict__ dx, float* __restrict__ part, const float* __restrict__ g,
    const float* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ bias, const int64_t L, const int64_t C, const int64_t seg,
    const int silu) {
  const int64_t c = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (c >= C) return;
  const int64_t b = blockIdx.y;
  const int64_t t0 = static_cast<int64_t>(blockIdx.z) * seg;
  const int64_t t1 = t0 + seg < L ? t0 + seg : L;
  const float* xb = x + b * L * C + c;
  const float* gb = g + b * L * C + c;
  float* dxb = dx + b * L * C + c;
  float wr[K];
#pragma unroll
  for (int d = 0; d < K; ++d) wr[d] = w[d * C + c];
  const float bc = bias[c];
  // xw[k] = x[t - (K-1) + k]; gw[k] = gp[t - (K-1) + k] (0 before t0: those
  // only reach dx before the segment)
  float xw[K], gw[K], dw[K], db = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int64_t s = t0 - (K - 1) + k;
    xw[k] = (k < K - 1 && s >= 0) ? xb[s * C] : 0.0f;
    gw[k] = 0.0f;
    dw[k] = 0.0f;
  }
  for (int64_t t = t0; t < t1 + K - 1; ++t) {
    float gp = 0.0f;
    if (t < L) {
      xw[K - 1] = xb[t * C];
      gp = gb[t * C];
      if (silu) {
        float pre = 0.0f;
#pragma unroll
        for (int k = 0; k < K; ++k) pre = pre + xw[k] * wr[K - 1 - k];
        gp *= silu_grad(pre + bc);
      }
    }
    if (t < t1) {
#pragma unroll
      for (int d = 0; d < K; ++d) dw[d] += gp * xw[K - 1 - d];
      db += gp;
    }
#pragma unroll
    for (int k = 0; k < K - 1; ++k) gw[k] = gw[k + 1];
    gw[K - 1] = gp;
    // gw[d] = gp[s + d] with s = t - (K-1): dx[s] is complete
    const int64_t s = t - (K - 1);
    if (s >= t0) {
      float acc = 0.0f;
#pragma unroll
      for (int d = 0; d < K; ++d) acc += wr[d] * gw[d];
      dxb[s * C] = acc;
    }
#pragma unroll
    for (int k = 0; k < K - 1; ++k) xw[k] = xw[k + 1];
  }
  // this thread's partial row: dw[0..K-1], then dbias
  const int64_t row = b * gridDim.z + blockIdx.z;
  float* pr = part + row * (K + 1) * C + c;
#pragma unroll
  for (int d = 0; d < K; ++d) pr[d * C] = dw[d];
  pr[K * C] = db;
}

// dw[d, c] (d < K) and dbias[c] (d = K): the partial rows summed in order
__global__ void __launch_bounds__(kThreads) conv1d_bwd_fold(
    float* __restrict__ dw, float* __restrict__ db, const float* __restrict__ part,
    const int64_t rows, const int64_t C, const int64_t K) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= (K + 1) * C) return;
  float acc = 0.0f;
  for (int64_t r = 0; r < rows; ++r) acc += part[r * (K + 1) * C + i];
  if (i < K * C) {
    dw[i] = acc;
  } else {
    db[i - K * C] = acc;
  }
}

void launch_fold(dim3 grid, cudaStream_t st, float* dw, float* db, const float* part,
                 int64_t rows, int64_t C, int64_t K) {
  const dim3 block(kThreads, 1, 1);
  conv1d_bwd_fold<<<grid, block, 0, st>>>(
      dw, db, part, rows, C, K);
}

template <int K>
int launch_k(dim3 grid, cudaStream_t st, float* dx, float* part, const float* g,
             const float* x, const float* w, const float* bias, int64_t L, int64_t C,
             int64_t seg, int silu) {
  const dim3 block(kThreads, 1, 1);
  conv1d_bwd_kernel<K><<<grid, block, 0, st>>>(
      dx, part, g, x, w, bias, L, C, seg, silu);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// part: (B * ceil(L / seg), K + 1, C) f32 scratch; K <= kMaxK.
extern "C" int launch(void* dx, void* dw, void* db, void* part, const void* g,
                      const void* x, const void* w, const void* bias, int64_t B, int64_t L,
                      int64_t C, int64_t K, int64_t seg, int64_t silu, void* stream) {
  const dim3 grid(static_cast<unsigned>((C + kThreads - 1) / kThreads),
                  static_cast<unsigned>(B),
                  static_cast<unsigned>((L + seg - 1) / seg));
  auto st = static_cast<cudaStream_t>(stream);
  auto dxo = static_cast<float*>(dx);
  auto pt = static_cast<float*>(part);
  auto gi = static_cast<const float*>(g);
  auto xi = static_cast<const float*>(x);
  auto wi = static_cast<const float*>(w);
  auto bi = static_cast<const float*>(bias);
  const int s = static_cast<int>(silu);
  int err = 0;
  switch (K) {
    case 1: err = launch_k<1>(grid, st, dxo, pt, gi, xi, wi, bi, L, C, seg, s); break;
    case 2: err = launch_k<2>(grid, st, dxo, pt, gi, xi, wi, bi, L, C, seg, s); break;
    case 3: err = launch_k<3>(grid, st, dxo, pt, gi, xi, wi, bi, L, C, seg, s); break;
    case 4: err = launch_k<4>(grid, st, dxo, pt, gi, xi, wi, bi, L, C, seg, s); break;
    case 5: err = launch_k<5>(grid, st, dxo, pt, gi, xi, wi, bi, L, C, seg, s); break;
    case 6: err = launch_k<6>(grid, st, dxo, pt, gi, xi, wi, bi, L, C, seg, s); break;
    case 7: err = launch_k<7>(grid, st, dxo, pt, gi, xi, wi, bi, L, C, seg, s); break;
    case kMaxK: err = launch_k<kMaxK>(grid, st, dxo, pt, gi, xi, wi, bi, L, C, seg, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  const int64_t rows = B * static_cast<int64_t>(grid.z);
  const dim3 fold_grid(static_cast<unsigned>(((K + 1) * C + kThreads - 1) / kThreads), 1, 1);
  launch_fold(fold_grid, st, static_cast<float*>(dw), static_cast<float*>(db), pt, rows, C, K);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Hand-written CUDA kernel for Mamba2's causal depthwise short convolution:
//
//   out[b, t, c] = act( sum_{d=0}^{K-1} w[d, c] * x[b, t-d, c] + bias[c] ),
//   x[b, t-d, c] = 0 where t - d < 0,   act = SiLU (x * sigmoid(x)) or none.
//
// Replaces the Pallas TPU kernel src/repro/kernels/conv1d.py::conv1d_causal
// (pl.pallas_call at :44, body _body at :23). f32 in, f32 accumulation,
// f32 out.
//
// What bounds it on the H100: bytes. Each output reads K inputs that its
// K-1 predecessors along t read too, so the function needs x read once and
// out written once (8 bytes per element) against 2K + 5 f32 operations per
// element (about 13 at K = 4), far below the card's ratio of f32 operations
// to memory bytes (about 20): the kernel cannot beat 8 bytes per element
// over the memory rate.
//
// What the design does about it (the paper's `loopopt`, the module's own
// "1-D stencil"): each thread owns one channel c of one batch row and a
// segment of t, and marches along t with the K-1 previous inputs in
// registers, so every x element is loaded once per segment (plus a K-1 halo
// at the segment's start). threadIdx.x runs along c, the contiguous axis,
// so a warp's loads and stores of one t row coalesce into whole 128-byte
// lines. t is cut into segments so that (B, L, C) = (4, 1024, 4224) gives
// enough blocks to fill the card's SMs.
//
// The taps are summed from the oldest input to the newest, then the bias,
// which is the plain version's order (kernels/ref.py), and the build passes
// --fmad=false, so the sum agrees with the plain version bitwise; SiLU uses
// expf, which differs from PyTorch's sigmoid by a few ulp at most.
//
// K up to kMaxK keeps its window in registers (one template instance per
// K); a larger K takes the generic kernel, which reads its taps through L1.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxK = 8;

__device__ __forceinline__ float activate(float v, int silu) {
  return silu ? v * (1.0f / (1.0f + expf(-v))) : v;
}

template <int K>
__global__ void __launch_bounds__(kThreads) conv1d_window(
    float* __restrict__ out, const float* __restrict__ x,
    const float* __restrict__ w, const float* __restrict__ bias,
    const int64_t L, const int64_t C, const int64_t seg, const int silu) {
  const int64_t c = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (c >= C) return;
  const int64_t b = blockIdx.y;
  const int64_t t0 = static_cast<int64_t>(blockIdx.z) * seg;
  const int64_t t1 = t0 + seg < L ? t0 + seg : L;
  const float* xb = x + b * L * C + c;
  float* ob = out + b * L * C + c;
  float wr[K];
#pragma unroll
  for (int d = 0; d < K; ++d) wr[d] = w[d * C + c];
  const float bc = bias[c];
  // win[k] = x[t - (K-1) + k]; win[K-1] is the newest input
  float win[K];
#pragma unroll
  for (int k = 0; k < K - 1; ++k) {
    const int64_t s = t0 - (K - 1) + k;
    win[k] = s >= 0 ? xb[s * C] : 0.0f;
  }
  for (int64_t t = t0; t < t1; ++t) {
    win[K - 1] = xb[t * C];
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < K; ++k) acc = acc + win[k] * wr[K - 1 - k];
    acc = acc + bc;
    ob[t * C] = activate(acc, silu);
#pragma unroll
    for (int k = 0; k < K - 1; ++k) win[k] = win[k + 1];
  }
}

__global__ void __launch_bounds__(kThreads) conv1d_any(
    float* __restrict__ out, const float* __restrict__ x,
    const float* __restrict__ w, const float* __restrict__ bias,
    const int64_t L, const int64_t C, const int64_t seg, const int K,
    const int silu) {
  const int64_t c = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (c >= C) return;
  const int64_t b = blockIdx.y;
  const int64_t t0 = static_cast<int64_t>(blockIdx.z) * seg;
  const int64_t t1 = t0 + seg < L ? t0 + seg : L;
  const float* xb = x + b * L * C + c;
  float* ob = out + b * L * C + c;
  const float bc = bias[c];
  for (int64_t t = t0; t < t1; ++t) {
    float acc = 0.0f;
    for (int k = 0; k < K; ++k) {
      const int64_t s = t - (K - 1) + k;
      const float xv = s >= 0 ? xb[s * C] : 0.0f;
      acc = acc + xv * w[static_cast<int64_t>(K - 1 - k) * C + c];
    }
    acc = acc + bc;
    ob[t * C] = activate(acc, silu);
  }
}

template <int K>
void launch_window(dim3 grid, cudaStream_t st, float* out, const float* x,
                   const float* w, const float* bias, int64_t L, int64_t C,
                   int64_t seg, int silu) {
  conv1d_window<K><<<grid, kThreads, 0, st>>>(out, x, w, bias, L, C, seg, silu);
}

}  // namespace

extern "C" int launch(void* out, const void* x, const void* w, const void* bias,
                      int64_t B, int64_t L, int64_t C, int64_t K, int64_t seg,
                      int64_t silu, void* stream) {
  const dim3 grid(static_cast<unsigned>((C + kThreads - 1) / kThreads),
                  static_cast<unsigned>(B),
                  static_cast<unsigned>((L + seg - 1) / seg));
  auto st = static_cast<cudaStream_t>(stream);
  auto o = static_cast<float*>(out);
  auto xi = static_cast<const float*>(x);
  auto wi = static_cast<const float*>(w);
  auto bi = static_cast<const float*>(bias);
  const int s = static_cast<int>(silu);
  switch (K) {
    case 1: launch_window<1>(grid, st, o, xi, wi, bi, L, C, seg, s); break;
    case 2: launch_window<2>(grid, st, o, xi, wi, bi, L, C, seg, s); break;
    case 3: launch_window<3>(grid, st, o, xi, wi, bi, L, C, seg, s); break;
    case 4: launch_window<4>(grid, st, o, xi, wi, bi, L, C, seg, s); break;
    case 5: launch_window<5>(grid, st, o, xi, wi, bi, L, C, seg, s); break;
    case 6: launch_window<6>(grid, st, o, xi, wi, bi, L, C, seg, s); break;
    case 7: launch_window<7>(grid, st, o, xi, wi, bi, L, C, seg, s); break;
    case kMaxK: launch_window<kMaxK>(grid, st, o, xi, wi, bi, L, C, seg, s); break;
    default:
      conv1d_any<<<grid, kThreads, 0, st>>>(o, xi, wi, bi, L, C, seg,
                                            static_cast<int>(K), s);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

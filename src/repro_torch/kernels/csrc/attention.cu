// Hand-written CUDA kernel for causal / sliding-window self-attention with
// GQA (forward, Lq == Lk):
//
//   out[b, h, i] = sum_j softmax_j(s[i, j]) v[b, h / rep, j],
//   s[i, j]      = scale * q[b, h, i] · k[b, h / rep, j]  where j is allowed:
//                  j <= i (causal), j > i - window (window); -1e30 elsewhere.
//
// Replaces the Pallas TPU kernel src/repro/kernels/attention.py::
// flash_attention (pl.pallas_call at :74, body _body at :26). f32 in, online
// softmax (m, l, acc) in f32, f32 out; the masking discipline is the TPU
// kernel's: masked scores are -1e30, masked p are set back to exactly 0, and
// the output divides by l only where l > 0, so a row with no key gives 0.
//
// What bounds it on the H100: operations. At Zamba2's prefill (B = 4,
// H = 32, L = 1024, D = 64, causal) the two products take about 17 GFLOP
// for about 134 MB of q, k, v and out, far above the card's ratio of f32
// operations to memory bytes. This first kernel runs them on the CUDA cores
// in f32; tensor cores (wgmma) are a later PR's work.
//
// What the design does: one block owns 64 query rows of one (b, h); four
// threads own one row, each holding a quarter of q and of the accumulator
// in registers (float4 chunks r, r + 4, r + 8, ... of the row, so that the
// four threads of a row read consecutive 16-byte words of a k or v row:
// no bank conflicts). Tiles of kBK keys and values are staged in shared
// memory once for all 64 rows. A row's four partial dot products meet by
// two warp shuffles. Key tiles that the causal or window mask removes for
// every row of the block are not visited: each would leave (m, l, acc) as
// they are.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 64;          // query rows per block
constexpr int kThreads = 4 * kRows;
constexpr int kBK = 32;            // keys per staged tile
constexpr float kNegInf = -1e30f;

// NV float4 chunks of the head dimension per thread: D = 16 * NV.
template <int NV>
__global__ void __launch_bounds__(kThreads) attention_kernel(
    float* __restrict__ out, const float* __restrict__ q,
    const float* __restrict__ k, const float* __restrict__ v, const int Hq,
    const int rep, const int64_t L, const int causal, const int has_window,
    const int64_t window, const float scale) {
  constexpr int D4 = 4 * NV;  // float4 chunks in a row
  __shared__ float4 Ks[kBK * D4];
  __shared__ float4 Vs[kBK * D4];
  const int tid = threadIdx.x;
  const int r = tid & 3;
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * kRows;
  const int64_t row = q0 + (tid >> 2);
  const int bh = blockIdx.y;
  const int b = bh / Hq, h = bh % Hq;
  const int64_t kvbase = (static_cast<int64_t>(b) * (Hq / rep) + h / rep) * L * D4;
  const int64_t qrow = (static_cast<int64_t>(bh) * L + row) * D4;
  const float4* q4 = reinterpret_cast<const float4*>(q);
  const float4* k4 = reinterpret_cast<const float4*>(k) + kvbase;
  const float4* v4 = reinterpret_cast<const float4*>(v) + kvbase;

  float4 qr[NV], acc[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    qr[i] = row < L ? q4[qrow + r + 4 * i] : make_float4(0.f, 0.f, 0.f, 0.f);
    acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = kNegInf, l = 0.0f;

  // keys some row of this block may attend to: [k_lo, k_hi)
  const int64_t q1 = q0 + kRows < L ? q0 + kRows : L;
  const int64_t k_hi = causal ? q1 : L;
  int64_t k_lo = 0;
  if (has_window) {
    k_lo = q0 - window + 1;
    if (k_lo < 0) k_lo = 0;
  }
  for (int64_t k0 = k_lo; k0 < k_hi; k0 += kBK) {
    __syncthreads();
    for (int i = tid; i < kBK * D4; i += kThreads) {
      const int64_t kp = k0 + i / D4;
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      Ks[i] = kp < L ? k4[kp * D4 + i % D4] : zero;
      Vs[i] = kp < L ? v4[kp * D4 + i % D4] : zero;
    }
    __syncthreads();
    float s[kBK];
    unsigned allowed = 0;  // bit j: key k0 + j is not masked for this row
    float tile_max = kNegInf;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      float part = 0.0f;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const float4 kk = Ks[j * D4 + r + 4 * i];
        part = part + qr[i].x * kk.x;
        part = part + qr[i].y * kk.y;
        part = part + qr[i].z * kk.z;
        part = part + qr[i].w * kk.w;
      }
      part = part + __shfl_xor_sync(0xffffffffu, part, 1);
      part = part + __shfl_xor_sync(0xffffffffu, part, 2);
      const int64_t kp = k0 + j;
      const bool ok = kp < L && (!causal || kp <= row) &&
                      (!has_window || kp > row - window);
      allowed |= static_cast<unsigned>(ok) << j;
      s[j] = ok ? part * scale : kNegInf;
      tile_max = fmaxf(tile_max, s[j]);
    }
    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);
    float psum = 0.0f;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      const float p = (allowed >> j) & 1u ? expf(s[j] - m_new) : 0.0f;
      s[j] = p;
      psum = psum + p;
    }
    l = l * alpha + psum;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      float4 a = acc[i];
      a.x = a.x * alpha; a.y = a.y * alpha; a.z = a.z * alpha; a.w = a.w * alpha;
#pragma unroll
      for (int j = 0; j < kBK; ++j) {
        const float4 vv = Vs[j * D4 + r + 4 * i];
        a.x = a.x + s[j] * vv.x;
        a.y = a.y + s[j] * vv.y;
        a.z = a.z + s[j] * vv.z;
        a.w = a.w + s[j] * vv.w;
      }
      acc[i] = a;
    }
    m = m_new;
  }
  if (row < L) {
    const float safe = l > 0.0f ? l : 1.0f;
    float4* o4 = reinterpret_cast<float4*>(out);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const float4 a = acc[i];
      o4[qrow + r + 4 * i] = make_float4(a.x / safe, a.y / safe, a.z / safe, a.w / safe);
    }
  }
}

template <int NV>
void launch_nv(dim3 grid, cudaStream_t st, float* out, const float* q,
               const float* k, const float* v, int Hq, int rep, int64_t L,
               int causal, int has_window, int64_t window, float scale) {
  attention_kernel<NV><<<grid, kThreads, 0, st>>>(out, q, k, v, Hq, rep, L, causal,
                                                  has_window, window, scale);
}

}  // namespace

// Head dimensions this kernel takes: multiples of 16 up to 128.
extern "C" int launch(void* out, const void* q, const void* k, const void* v,
                      int64_t B, int64_t Hq, int64_t Hkv, int64_t L, int64_t D,
                      int64_t causal, int64_t has_window, int64_t window,
                      float scale, void* stream) {
  const dim3 grid(static_cast<unsigned>((L + kRows - 1) / kRows),
                  static_cast<unsigned>(B * Hq), 1);
  auto st = static_cast<cudaStream_t>(stream);
  auto o = static_cast<float*>(out);
  auto qi = static_cast<const float*>(q);
  auto ki = static_cast<const float*>(k);
  auto vi = static_cast<const float*>(v);
  const int hq = static_cast<int>(Hq), rep = static_cast<int>(Hq / Hkv);
  const int c = static_cast<int>(causal), hw = static_cast<int>(has_window);
  switch (D) {
    case 16: launch_nv<1>(grid, st, o, qi, ki, vi, hq, rep, L, c, hw, window, scale); break;
    case 32: launch_nv<2>(grid, st, o, qi, ki, vi, hq, rep, L, c, hw, window, scale); break;
    case 48: launch_nv<3>(grid, st, o, qi, ki, vi, hq, rep, L, c, hw, window, scale); break;
    case 64: launch_nv<4>(grid, st, o, qi, ki, vi, hq, rep, L, c, hw, window, scale); break;
    case 80: launch_nv<5>(grid, st, o, qi, ki, vi, hq, rep, L, c, hw, window, scale); break;
    case 96: launch_nv<6>(grid, st, o, qi, ki, vi, hq, rep, L, c, hw, window, scale); break;
    case 112: launch_nv<7>(grid, st, o, qi, ki, vi, hq, rep, L, c, hw, window, scale); break;
    case 128: launch_nv<8>(grid, st, o, qi, ki, vi, hq, rep, L, c, hw, window, scale); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Hand-written CUDA kernel for causal / sliding-window self-attention with
// GQA (forward, Lq == Lk), on Hopper's tensor cores:
//
//   out[b, h, i] = sum_j softmax_j(s[i, j]) v[b, h / rep, j],
//   s[i, j]      = scale * q[b, h, i] · k[b, h / rep, j]  where j is allowed:
//                  j <= i (causal), j > i - window (window); -1e30 elsewhere.
//
// Replaces the Pallas TPU kernel src/repro/kernels/attention.py::
// flash_attention (pl.pallas_call at :74, body _body at :26). q, k, v and out
// at the storage type T (storage.cuh: f32, or bf16 in the bf16 instance, as
// the TPU kernel takes the parameter dtype), converted to f32 on load (at
// bf16, K and V are loaded and stored into shared memory as f32, not by
// cp.async); online softmax (m, l, acc) in f32; out rounded once; lse f32.
// Given a pointer for it, the kernel also writes out before rounding (out32,
// f32), which the bf16 backward reads for its delta = dO·O: computed from the
// rounded out, delta would be off by up to 2^-9 of |dO||O| and dq and dk by
// about 1e-3 of their largest value at Zamba2's shape (a CPU estimate).
// The masking discipline is the TPU
// kernel's: masked scores are -1e30, masked p are set to exactly 0, and the
// output divides by l only where l > 0, so a row with no key gives 0.
//
// What bounds it on the H100: operations. At Zamba2's prefill (B = 4,
// H = 32, L = 1024, D = 64, causal) the two products take 17.2 GFLOP for
// 134 MB of q, k, v and out. On the CUDA cores in f32 (67 TFLOP/s) that is
// 0.257 ms at best; on the tensor cores at f32 accuracy (below) 0.104 ms.
//
// f32 accuracy on TF32 tensor cores (3xTF32, tf32x3.cuh). A TF32 operand
// keeps 10 mantissa bits, so one TF32 product is off by about 5e-4
// relative: far outside the 1e-5 this kernel is held to against its plain
// f32 version. Each f32 operand is split into a TF32 hi and a TF32
// residual lo, and every product a·b is summed as a_lo·b_hi + a_hi·b_lo +
// a_hi·b_hi into f32 accumulators (about 2^-21 relative): three TF32
// products per f32 product, 165 TFLOP/s f32-accurate against 67 TFLOP/s
// on the CUDA cores.
//
// What the design does (FlashAttention-2's shape with mma.sync):
// - One block of 4 warps owns 64 query rows of one (b, h); each warp owns
//   16 rows and runs mma.sync.m16n8k8 tf32 on them. Its q rows are loaded
//   once, split into (hi, lo) and kept in registers (D <= 64; above that
//   the raw rows stay in registers and are split per tile).
// - Tiles of 32 keys of K and V are double-buffered in shared memory with
//   cp.async: the next tile loads while this one is multiplied. Keys past
//   L are zero-filled. Each warp splits the K and V values it reads; at
//   D <= 64 the registers are capped at 168, so three blocks (12 warps)
//   share an SM.
// - Operand permutations make every fragment load a 16- or 8-byte load
//   free of bank conflicts. A sum over k may visit k in any order, as long
//   as both operands agree: S = Q·Kᵀ gives thread t of a quad the head
//   dims 16i + 4t .. 16i + 4t + 3 (one float4 of q and of each k row, two
//   k-steps); P·V reuses S's accumulator as its A operand without a
//   shuffle (A column t <-> key 2t, column t + 4 <-> key 2t + 1, which is
//   where the accumulator holds them), and V's output columns are permuted
//   in groups of 8·kNG dims so that each thread reads kNG consecutive dims
//   of a V row and finally writes 2·kNG consecutive dims of out. K rows
//   are padded to a stride of 16 mod 32 words, V rows to 4 mod 16.
// - The output accumulator never passes through the tensor cores, whose
//   adds truncate: each tile's P·V is summed in a fresh accumulator, one
//   group of 8·kNG dims at a time, and added to alpha·O on the CUDA cores.
//   Chained through mma.sync over every key, O was off its plain version
//   by up to 7.3e-6 at Zamba2's shapes on the H100; summed per tile, by
//   2.7e-6, for about 6% more time (fresh accumulators, more registers).
// - The online softmax runs in the accumulator's layout: a row's max and
//   sum take two quad shuffles per tile, and l is summed over the quad
//   once, at the end. Scores are scaled by scale·log2(e) and exponentiated
//   with exp2f.
// - Masks are tested only on tiles that straddle the causal or window
//   edge, or L, for the warp's 16 rows; tiles wholly outside the band are
//   not visited, and the heaviest query tiles are launched first.
// - Given a pointer for it, the kernel writes each row's log-sum-exp of its
//   scaled scores, ln(sum_j exp(s[i, j])) = m ln 2 + ln l (-inf for a row
//   with no key), which the backward (csrc/attention_bwd.cu) reads to
//   recompute the probabilities; serving passes none.
// What bounds it now: the instruction rate of mma.sync (three per f32
// product, 16 rows per warp) and of the split arithmetic beside it, which
// every warp repeats on the K and V values it reads. wgmma, which reads B
// from shared memory for a whole warpgroup, is the next step.
#include <cstdint>
#include <cuda_runtime.h>

#include "tf32x3.cuh"
#include "storage.cuh"

namespace {

using namespace tf32x3;
using storage::T;

constexpr int kWarps = 4;
constexpr int kRows = 16 * kWarps;  // query rows per block
constexpr int kThreads = 32 * kWarps;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int D>
struct Shape {
  static constexpr int kBK = 32;                    // keys per tile
  static constexpr int kLdK = D % 32 ? D : D + 16;  // words, = 16 mod 32
  static constexpr int kLdV = D + 4;                // words, = 4 mod 16
  static constexpr int kNG = D % 32 ? 2 : 4;        // n-tiles per V load
  static constexpr int kStage = kBK * (kLdK + kLdV);
  static constexpr int kSmem = 2 * kStage * 4;      // bytes, two stages
};

template <int D>
__global__ void __launch_bounds__(kThreads, D <= 64 ? 3 : 2) attention_kernel(
    T* __restrict__ out, float* __restrict__ lse, float* __restrict__ out32,
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, const int Hq,
    const int rep, const int64_t L, const int causal, const int has_window,
    const int64_t window, const float scale) {
  using S = Shape<D>;
  constexpr int BK = S::kBK, NT = BK / 8, KS = D / 8, NG = S::kNG;
  constexpr int W = 8 * NG, NQ = D / W;  // V column groups
  constexpr bool kKeepSplit = D <= 64;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int64_t q0 = static_cast<int64_t>(gridDim.x - 1 - blockIdx.x) * kRows;
  const int bh = blockIdx.y;
  const int b = bh / Hq, h = bh % Hq;
  const int64_t kvbase = (static_cast<int64_t>(b) * (Hq / rep) + h / rep) * L * D;
  const T* qb = q + static_cast<int64_t>(bh) * L * D;
  const T* kb = k + kvbase;
  const T* vb = v + kvbase;

  // this thread's rows and their q fragments (k-steps 2i, 2i + 1 from one
  // float4 of each row)
  const int64_t r0 = q0 + 16 * warp + g, r1 = r0 + 8;
  float qf[KS][4];
  uint32_t qh[kKeepSplit ? KS : 1][4], ql[kKeepSplit ? KS : 1][4];
#pragma unroll
  for (int i = 0; i < D / 16; ++i) {
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    const T* qa = qb + r0 * D + 16 * i + 4 * t;
    const float4 a = r0 < L ? storage::load4(qa) : zero;
    const float4 c = r1 < L ? storage::load4(qa + 8 * D) : zero;
    qf[2 * i][0] = a.x; qf[2 * i][1] = c.x; qf[2 * i][2] = a.y; qf[2 * i][3] = c.y;
    qf[2 * i + 1][0] = a.z; qf[2 * i + 1][1] = c.z; qf[2 * i + 1][2] = a.w; qf[2 * i + 1][3] = c.w;
  }
  if constexpr (kKeepSplit) {
#pragma unroll
    for (int s = 0; s < KS; ++s) split4(qf[s], qh[s], ql[s]);
  }

  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  const float sl2 = scale * kLog2e;

  // keys some row of this block may attend to: [k_lo, k_hi)
  const int64_t q_end = q0 + kRows < L ? q0 + kRows : L;
  const int64_t k_hi = causal ? q_end : L;
  int64_t k_lo = 0;
  if (has_window) {
    k_lo = q0 - window + 1;
    if (k_lo < 0) k_lo = 0;
  }
  const int ntiles = k_hi > k_lo ? static_cast<int>((k_hi - k_lo + BK - 1) / BK) : 0;

  static_assert(BK * D / 4 % kThreads == 0, "a tile is whole 16-byte copies per thread");
  auto load_tile = [&](int stage, int64_t k0) {
    float* Ks = smem + stage * S::kStage;
    float* Vs = Ks + BK * S::kLdK;
#pragma unroll
    for (int j = 0; j < BK * D / 4 / kThreads; ++j) {
      const int i = tid + j * kThreads;
      const int r = i / (D / 4), c = 4 * (i % (D / 4));
      const int64_t kp = k0 + r;
      const bool ok = kp < L;
      const int64_t off = (ok ? kp : 0) * D + c;
      storage::copy4(Ks + r * S::kLdK + c, kb + off, ok);
      storage::copy4(Vs + r * S::kLdV + c, vb + off, ok);
    }
  };

  if (ntiles > 0) load_tile(0, k_lo);
  cp_async_commit();
  for (int it = 0; it < ntiles; ++it) {
    const int64_t k0 = k_lo + static_cast<int64_t>(it) * BK;
    cp_async_wait_all();
    __syncthreads();  // tile it landed; every warp is done with tile it - 1
    if (it + 1 < ntiles) load_tile((it + 1) & 1, k0 + BK);
    cp_async_commit();
    const float* Ks = smem + (it & 1) * S::kStage;
    const float* Vs = Ks + BK * S::kLdK;

    // S = Q·Kᵀ for this warp's 16 rows and the tile's BK keys
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
#pragma unroll
    for (int i = 0; i < D / 16; ++i) {
      uint32_t ah0[4], al0[4], ah1[4], al1[4];
      if constexpr (kKeepSplit) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          ah0[r] = qh[2 * i][r]; al0[r] = ql[2 * i][r];
          ah1[r] = qh[2 * i + 1][r]; al1[r] = ql[2 * i + 1][r];
        }
      } else {
        split4(qf[2 * i], ah0, al0);
        split4(qf[2 * i + 1], ah1, al1);
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float4 kk =
            *reinterpret_cast<const float4*>(Ks + (8 * n + g) * S::kLdK + 16 * i + 4 * t);
        mma3(s[n], ah0, al0, kk.x, kk.y);
        mma3(s[n], ah1, al1, kk.z, kk.w);
      }
    }

    // masks: only where this warp's rows meet the band edge or L
    const int64_t w0 = q0 + 16 * warp;
    const bool full = k0 + BK <= L && (!causal || k0 + BK - 1 <= w0) &&
                      (!has_window || k0 > w0 + 15 - window);
    float mt[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * sl2;
        if (!full) {
          const int64_t row = e < 2 ? r0 : r1;
          const int64_t kp = k0 + 8 * n + 2 * t + (e & 1);
          const bool ok = kp < L && (!causal || kp <= row) && (!has_window || kp > row - window);
          x = ok ? x : kNegInf;
        }
        s[n][e] = x;
        mt[e >> 1] = fmaxf(mt[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
      const float m_new = fmaxf(m[r], mt[r]);
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // a masked score is -1e30: its p is exactly 0, also in a row with
        // no key so far (m = -1e30 there)
        const float p = s[n][e] == kNegInf ? 0.0f : exp2f(s[n][e] - m[e >> 1]);
        s[n][e] = p;
        l[e >> 1] += p;
      }
    }
    // O = alpha·O + P·V: S's accumulator is P's A operand (column t <->
    // key 2t, column t + 4 <-> key 2t + 1). Each group of W output dims
    // sums the tile's keys in a fresh accumulator on the tensor cores and
    // is added to O on the CUDA cores: the tensor cores' adds truncate, so
    // O itself never passes through them (tf32x3.cuh).
#pragma unroll
    for (int qg = 0; qg < NQ; ++qg) {
      float pv[NG][4];
#pragma unroll
      for (int jj = 0; jj < NG; ++jj) pv[jj][0] = pv[jj][1] = pv[jj][2] = pv[jj][3] = 0.0f;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t ah[4], al[4];
        const float pa[4] = {s[j][0], s[j][2], s[j][1], s[j][3]};
        split4(pa, ah, al);
        const float* v0 = Vs + (8 * j + 2 * t) * S::kLdV + NG * g + qg * W;
        const float* v1 = v0 + S::kLdV;
        float b0[NG], b1[NG];
        if constexpr (NG == 4) {
          const float4 x0 = *reinterpret_cast<const float4*>(v0);
          const float4 x1 = *reinterpret_cast<const float4*>(v1);
          b0[0] = x0.x; b0[1] = x0.y; b0[2] = x0.z; b0[3] = x0.w;
          b1[0] = x1.x; b1[1] = x1.y; b1[2] = x1.z; b1[3] = x1.w;
        } else {
          const float2 x0 = *reinterpret_cast<const float2*>(v0);
          const float2 x1 = *reinterpret_cast<const float2*>(v1);
          b0[0] = x0.x; b0[1] = x0.y;
          b1[0] = x1.x; b1[1] = x1.y;
        }
#pragma unroll
        for (int jj = 0; jj < NG; ++jj) mma3(pv[jj], ah, al, b0[jj], b1[jj]);
      }
#pragma unroll
      for (int jj = 0; jj < NG; ++jj) {
        float (&on)[4] = o[qg * NG + jj];
        on[0] = on[0] * alpha[0] + pv[jj][0];
        on[1] = on[1] * alpha[0] + pv[jj][1];
        on[2] = on[2] * alpha[1] + pv[jj][2];
        on[3] = on[3] * alpha[1] + pv[jj][3];
      }
    }
  }

  // l over the quad; out = acc / l where l > 0. Thread t holds dims
  // qg·W + 2·NG·t + e of each group: e < NG in c0/c2, e >= NG in c1/c3.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int64_t row = r ? r1 : r0;
    if (row >= L) continue;
    const float safe = l[r] > 0.0f ? l[r] : 1.0f;
    if (lse != nullptr && t == 0)
      lse[static_cast<int64_t>(bh) * L + row] =
          l[r] > 0.0f ? m[r] * kLn2 + logf(l[r]) : __int_as_float(0xff800000);
    T* orow = out + (static_cast<int64_t>(bh) * L + row) * D;
    float* orow32 = out32 == nullptr ? nullptr : out32 + (static_cast<int64_t>(bh) * L + row) * D;
#pragma unroll
    for (int qg = 0; qg < NQ; ++qg) {
      float val[2 * NG];
#pragma unroll
      for (int e = 0; e < 2 * NG; ++e) val[e] = o[qg * NG + e % NG][2 * r + e / NG] / safe;
#pragma unroll
      for (int e = 0; e < 2 * NG; e += 4) {
        const float4 o4 = make_float4(val[e], val[e + 1], val[e + 2], val[e + 3]);
        storage::store4(orow + qg * W + 2 * NG * t + e, o4);
        if (orow32 != nullptr) *reinterpret_cast<float4*>(orow32 + qg * W + 2 * NG * t + e) = o4;
      }
    }
  }
}

template <int D>
int launch_d(dim3 grid, cudaStream_t st, T* out, float* lse, float* out32, const T* q, const T* k,
             const T* v, int Hq, int rep, int64_t L, int causal, int has_window,
             int64_t window, float scale) {
  const cudaError_t err = cudaFuncSetAttribute(
      attention_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, Shape<D>::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_kernel<D><<<grid, kThreads, Shape<D>::kSmem, st>>>(
      out, lse, out32, q, k, v, Hq, rep, L, causal, has_window, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Head dimensions this kernel takes: multiples of 16 up to 128. out32, (B,
// Hq, L, D) f32, may be null; lse, (B, Hq,
// L) f32, may be null.
extern "C" int launch(void* out, void* lse, void* out32, const void* q, const void* k,
                      const void* v, int64_t B, int64_t Hq, int64_t Hkv, int64_t L, int64_t D,
                      int64_t causal, int64_t has_window, int64_t window,
                      float scale, void* stream) {
  const dim3 grid(static_cast<unsigned>((L + kRows - 1) / kRows),
                  static_cast<unsigned>(B * Hq), 1);
  auto st = static_cast<cudaStream_t>(stream);
  auto o = static_cast<T*>(out);
  auto ls = static_cast<float*>(lse);
  auto o32 = static_cast<float*>(out32);
  auto qi = static_cast<const T*>(q);
  auto ki = static_cast<const T*>(k);
  auto vi = static_cast<const T*>(v);
  const int hq = static_cast<int>(Hq), rep = static_cast<int>(Hq / Hkv);
  const int c = static_cast<int>(causal), hw = static_cast<int>(has_window);
  switch (D) {
    case 16: return launch_d<16>(grid, st, o, ls, o32, qi, ki, vi, hq, rep, L, c, hw, window, scale);
    case 32: return launch_d<32>(grid, st, o, ls, o32, qi, ki, vi, hq, rep, L, c, hw, window, scale);
    case 48: return launch_d<48>(grid, st, o, ls, o32, qi, ki, vi, hq, rep, L, c, hw, window, scale);
    case 64: return launch_d<64>(grid, st, o, ls, o32, qi, ki, vi, hq, rep, L, c, hw, window, scale);
    case 80: return launch_d<80>(grid, st, o, ls, o32, qi, ki, vi, hq, rep, L, c, hw, window, scale);
    case 96: return launch_d<96>(grid, st, o, ls, o32, qi, ki, vi, hq, rep, L, c, hw, window, scale);
    case 112: return launch_d<112>(grid, st, o, ls, o32, qi, ki, vi, hq, rep, L, c, hw, window, scale);
    case 128: return launch_d<128>(grid, st, o, ls, o32, qi, ki, vi, hq, rep, L, c, hw, window, scale);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

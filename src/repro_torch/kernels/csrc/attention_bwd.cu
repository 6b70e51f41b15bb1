// Hand-written CUDA kernels for the backward pass of causal / sliding-window
// self-attention with GQA (csrc/attention.cu is the forward), FlashAttention-2's
// algorithm. With p[i, j] = exp(scale q_i·k_j - lse_i) on the allowed pairs (0
// elsewhere; lse is the forward's per-row log-sum-exp), o the forward's output
// and g = dL/do:
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
// causal) 43.0 GFLOP, 0.64 ms on the CUDA cores at 67 TFLOP/s (0.26 ms at
// the tensor cores' 3xTF32 rate), against 0.27 GB of inputs and outputs
// (0.08 ms at 3.35 TB/s). This design computes q·k and g·v twice, once in
// each of its two kernels below, so it does 14 D operations a pair.
//
// What the design does (the simple version, on the CUDA cores with f32 FMA;
// the tensor cores come with a later redesign):
// 1. attention_bwd_delta: one warp per row, delta_i by a butterfly.
// 2. attention_bwd_dkdv: one block of 256 threads per (b, key head, 32 keys)
//    keeps its K and V tile and its dk, dv sums (thread t: key t / 8, dims
//    t mod 8 + 8 m) in registers and walks the 32-row query tiles of every
//    query head of its group that can see the tile: no two blocks write one
//    key, so GQA needs no atomics. Per tile it recomputes S and dP (thread t:
//    row t / 8, keys t mod 8 + 8 c), writes P and dS to shared memory, and
//    adds P^T g and dS^T q.
// 3. attention_bwd_dq: one block per (b, query head, 32 rows) keeps its q and
//    g tile and its dq sums, and walks the key tiles its rows can see.
// Tiles in shared memory are padded to D + 1 words a row, so the column reads
// of the products meet no bank conflicts. Every sum runs in a fixed order:
// the same bits on every call.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kBQ = 32;  // query rows of a tile
constexpr int kBK = 32;  // keys of a tile

// Shared memory of either kernel, in floats: q, g, k, v tiles of D + 1
// words a row, p and ds tiles, lse and delta (kernels/attention.py::
// bwd_smem_floats computes the same).
__host__ __device__ constexpr int smem_floats(int D) {
  return 2 * kBQ * (D + 1) + 2 * kBK * (D + 1) + 2 * kBQ * (kBK + 1) + 2 * kBQ;
}

template <int D>
struct Tiles {
  float* q;
  float* g;
  float* k;
  float* v;
  float* p;
  float* ds;
  float* lse;
  float* delta;
  __device__ explicit Tiles(float* s)
      : q(s), g(s + kBQ * (D + 1)), k(s + 2 * kBQ * (D + 1)),
        v(s + 2 * kBQ * (D + 1) + kBK * (D + 1)),
        p(s + 2 * kBQ * (D + 1) + 2 * kBK * (D + 1)), ds(p + kBQ * (kBK + 1)),
        lse(ds + kBQ * (kBK + 1)), delta(lse + kBQ) {}
};

// rows [r0, r0 + 32) of a (L, D) matrix into a tile of D + 1 words a row,
// zero past L
template <int D>
__device__ __forceinline__ void load_rows(float* tile, const float* src, int64_t r0,
                                          int64_t L) {
  for (int i = threadIdx.x; i < 32 * D; i += kThreads) {
    const int r = i / D, d = i % D;
    tile[r * (D + 1) + d] = r0 + r < L ? src[(r0 + r) * D + d] : 0.0f;
  }
}

__device__ __forceinline__ bool allowed(int64_t i, int64_t j, int64_t L, int causal,
                                        int has_window, int64_t window) {
  return i < L && j < L && (!causal || j <= i) && (!has_window || j > i - window);
}

// s = q_i·k_j and dp = g_i·v_j for row i and keys jg + 8 c (c < 4) of the
// tiles, then p and ds into the p and ds tiles
template <int D>
__device__ __forceinline__ void scores(const Tiles<D>& s, int i, int jg, int64_t i0,
                                       int64_t k0, int64_t L, int causal, int has_window,
                                       int64_t window, float scale) {
  float sc[4] = {0.0f, 0.0f, 0.0f, 0.0f}, dp[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int d = 0; d < D; ++d) {
    const float qv = s.q[i * (D + 1) + d], gv = s.g[i * (D + 1) + d];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      sc[c] += qv * s.k[(jg + 8 * c) * (D + 1) + d];
      dp[c] += gv * s.v[(jg + 8 * c) * (D + 1) + d];
    }
  }
  const float lse = s.lse[i], delta = s.delta[i];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int j = jg + 8 * c;
    const bool ok = allowed(i0 + i, k0 + j, L, causal, has_window, window);
    const float p = ok ? expf(sc[c] * scale - lse) : 0.0f;
    s.p[i * (kBK + 1) + j] = p;
    s.ds[i * (kBK + 1) + j] = p * (dp[c] - delta);
  }
}

__global__ void __launch_bounds__(kThreads) attention_bwd_delta(
    float* __restrict__ delta, const float* __restrict__ o, const float* __restrict__ g,
    const int64_t rows, const int D) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float acc = 0.0f;
  if (row < rows)
    for (int d = lane; d < D; d += 32) acc += g[row * D + d] * o[row * D + d];
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) acc += __shfl_xor_sync(kFull, acc, off);
  if (row < rows && lane == 0) delta[row] = acc;
}

template <int D>
__global__ void __launch_bounds__(kThreads) attention_bwd_dkdv(
    float* __restrict__ dk, float* __restrict__ dv, const float* __restrict__ q,
    const float* __restrict__ k, const float* __restrict__ v, const float* __restrict__ g,
    const float* __restrict__ lse, const float* __restrict__ delta, const int Hkv,
    const int rep, const int64_t L, const int causal, const int has_window,
    const int64_t window, const float scale) {
  constexpr int M = D / 8;
  extern __shared__ float smem[];
  const Tiles<D> s(smem);
  const int tid = threadIdx.x;
  const int64_t k0 = static_cast<int64_t>(blockIdx.x) * kBK;
  const int bkv = blockIdx.y;
  const int64_t b = bkv / Hkv;
  const int hkv = bkv % Hkv;
  const int64_t kv = static_cast<int64_t>(bkv) * L * D;
  load_rows<D>(s.k, k + kv, k0, L);
  load_rows<D>(s.v, v + kv, k0, L);
  // rows that can see a key of this tile: [i_lo, i_hi)
  const int64_t i_lo = causal ? k0 : 0;
  int64_t i_hi = L;
  if (has_window && k0 + kBK - 1 + window < L) i_hi = k0 + kBK - 1 + window;
  const int jk = tid / 8, dg = tid % 8;   // this thread's key and dims of dk, dv
  const int ir = tid / 8, jg = tid % 8;   // this thread's row and keys of S
  float ak[M], av[M];
#pragma unroll
  for (int m = 0; m < M; ++m) ak[m] = av[m] = 0.0f;
  for (int r = 0; r < rep; ++r) {
    const int64_t bh = b * Hkv * rep + static_cast<int64_t>(hkv) * rep + r;
    const float* qb = q + bh * L * D;
    const float* gb = g + bh * L * D;
    for (int64_t i0 = i_lo; i0 < i_hi; i0 += kBQ) {
      __syncthreads();  // every thread is done with the previous tiles
      load_rows<D>(s.q, qb, i0, L);
      load_rows<D>(s.g, gb, i0, L);
      if (tid < kBQ) {
        const bool in = i0 + tid < L;
        s.lse[tid] = in ? lse[bh * L + i0 + tid] : 0.0f;
        s.delta[tid] = in ? delta[bh * L + i0 + tid] : 0.0f;
      }
      __syncthreads();
      scores<D>(s, ir, jg, i0, k0, L, causal, has_window, window, scale);
      __syncthreads();
      for (int i = 0; i < kBQ; ++i) {
        const float p = s.p[i * (kBK + 1) + jk], ds = s.ds[i * (kBK + 1) + jk];
#pragma unroll
        for (int m = 0; m < M; ++m) {
          av[m] += p * s.g[i * (D + 1) + dg + 8 * m];
          ak[m] += ds * s.q[i * (D + 1) + dg + 8 * m];
        }
      }
    }
  }
  if (k0 + jk < L) {
    const int64_t at = kv + (k0 + jk) * D;
#pragma unroll
    for (int m = 0; m < M; ++m) {
      dk[at + dg + 8 * m] = ak[m] * scale;
      dv[at + dg + 8 * m] = av[m];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) attention_bwd_dq(
    float* __restrict__ dq, const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ g, const float* __restrict__ lse,
    const float* __restrict__ delta, const int Hq, const int rep, const int64_t L,
    const int causal, const int has_window, const int64_t window, const float scale) {
  constexpr int M = D / 8;
  extern __shared__ float smem[];
  const Tiles<D> s(smem);
  const int tid = threadIdx.x;
  const int64_t i0 = static_cast<int64_t>(blockIdx.x) * kBQ;
  const int64_t bh = blockIdx.y;
  const int64_t b = bh / Hq;
  const int h = static_cast<int>(bh % Hq);
  const int64_t kv = (b * (Hq / rep) + h / rep) * L * D;
  load_rows<D>(s.q, q + bh * L * D, i0, L);
  load_rows<D>(s.g, g + bh * L * D, i0, L);
  if (tid < kBQ) {
    const bool in = i0 + tid < L;
    s.lse[tid] = in ? lse[bh * L + i0 + tid] : 0.0f;
    s.delta[tid] = in ? delta[bh * L + i0 + tid] : 0.0f;
  }
  // keys some row of this tile can see: [k_lo, k_hi)
  int64_t k_lo = 0;
  if (has_window && i0 - window + 1 > 0) k_lo = i0 - window + 1;
  const int64_t k_hi = causal && i0 + kBQ < L ? i0 + kBQ : L;
  const int ir = tid / 8, dg = tid % 8, jg = tid % 8;
  float aq[M];
#pragma unroll
  for (int m = 0; m < M; ++m) aq[m] = 0.0f;
  for (int64_t k0 = k_lo; k0 < k_hi; k0 += kBK) {
    __syncthreads();  // every thread is done with the previous tiles
    load_rows<D>(s.k, k + kv, k0, L);
    load_rows<D>(s.v, v + kv, k0, L);
    __syncthreads();
    scores<D>(s, ir, jg, i0, k0, L, causal, has_window, window, scale);
    __syncthreads();
    for (int j = 0; j < kBK; ++j) {
      const float ds = s.ds[ir * (kBK + 1) + j];
#pragma unroll
      for (int m = 0; m < M; ++m) aq[m] += ds * s.k[j * (D + 1) + dg + 8 * m];
    }
  }
  if (i0 + ir < L) {
    const int64_t at = (bh * L + i0 + ir) * D;
#pragma unroll
    for (int m = 0; m < M; ++m) dq[at + dg + 8 * m] = aq[m] * scale;
  }
}

template <int D>
int launch_d(cudaStream_t st, float* dq, float* dk, float* dv, const float* q,
             const float* k, const float* v, const float* g, const float* lse,
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
  {
    const dim3 grid(static_cast<unsigned>((L + kBK - 1) / kBK),
                    static_cast<unsigned>(B * Hkv), 1);
    attention_bwd_dkdv<D><<<grid, block, smem, st>>>(
        dk, dv, q, k, v, g, lse, delta, Hkv, rep, L, causal, has_window, window, scale);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  {
    const dim3 grid(static_cast<unsigned>((L + kBQ - 1) / kBQ),
                    static_cast<unsigned>(B * Hq), 1);
    attention_bwd_dq<D><<<grid, block, smem, st>>>(
        dq, q, k, v, g, lse, delta, Hq, rep, L, causal, has_window, window, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

int launch_delta(cudaStream_t st, float* delta, const float* o, const float* g, int64_t rows,
                 int D) {
  const dim3 grid(static_cast<unsigned>((rows + kThreads / 32 - 1) / (kThreads / 32)), 1, 1);
  const dim3 block(kThreads, 1, 1);
  attention_bwd_delta<<<grid, block, 0, st>>>(
      delta, o, g, rows, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// smem_floats for the host (kernels/attention.py::bwd_smem_floats is held to it)
extern "C" int64_t bwd_smem_floats(int64_t D) { return smem_floats(static_cast<int>(D)); }

// Head dimensions multiples of 16 up to 128 (attention.cu's). delta is a
// (B, Hq, L) f32 scratch; lse is the forward's.
extern "C" int launch(void* dq, void* dk, void* dv, void* delta, const void* q, const void* k,
                      const void* v, const void* o, const void* g, const void* lse, int64_t B,
                      int64_t Hq, int64_t Hkv, int64_t L, int64_t D, int64_t causal,
                      int64_t has_window, int64_t window, float scale, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto dl = static_cast<float*>(delta);
  const int err = launch_delta(st, dl, f(o), f(g), B * Hq * L, static_cast<int>(D));
  if (err != 0) return err;
  auto qo = static_cast<float*>(dq);
  auto ko = static_cast<float*>(dk);
  auto vo = static_cast<float*>(dv);
  const int hq = static_cast<int>(Hq), hkv = static_cast<int>(Hkv);
  const int c = static_cast<int>(causal), hw = static_cast<int>(has_window);
  switch (D) {
    case 16: return launch_d<16>(st, qo, ko, vo, f(q), f(k), f(v), f(g), f(lse), dl, B, hq, hkv, L, c, hw, window, scale);
    case 32: return launch_d<32>(st, qo, ko, vo, f(q), f(k), f(v), f(g), f(lse), dl, B, hq, hkv, L, c, hw, window, scale);
    case 48: return launch_d<48>(st, qo, ko, vo, f(q), f(k), f(v), f(g), f(lse), dl, B, hq, hkv, L, c, hw, window, scale);
    case 64: return launch_d<64>(st, qo, ko, vo, f(q), f(k), f(v), f(g), f(lse), dl, B, hq, hkv, L, c, hw, window, scale);
    case 80: return launch_d<80>(st, qo, ko, vo, f(q), f(k), f(v), f(g), f(lse), dl, B, hq, hkv, L, c, hw, window, scale);
    case 96: return launch_d<96>(st, qo, ko, vo, f(q), f(k), f(v), f(g), f(lse), dl, B, hq, hkv, L, c, hw, window, scale);
    case 112: return launch_d<112>(st, qo, ko, vo, f(q), f(k), f(v), f(g), f(lse), dl, B, hq, hkv, L, c, hw, window, scale);
    case 128: return launch_d<128>(st, qo, ko, vo, f(q), f(k), f(v), f(g), f(lse), dl, B, hq, hkv, L, c, hw, window, scale);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Hand-written CUDA kernel for the Mamba2 SSD (state-space duality) forward
// chunk scan (arXiv:2405.21060). For each batch row b and head h, over
// chunks of cs steps, with g = h / (H / G) the head's state group:
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
// (pl.pallas_call at :78, body _body at :27). f32 in, f32 state and
// accumulation, f32 out.
//
// What bounds it on the H100: operations. Per chunk and head it does four
// cs x cs x 64-deep or cs x P x N products (C·Bᵀ, W·x, C·h and the state
// update): at Zamba2's cs = P = N = 64, about 2 MFLOP for 64 x 64 x 4 bytes
// of x read and written, far above the card's ratio of f32 operations to
// memory bytes. This first kernel runs them on the CUDA cores in f32.
//
// What the design does: the TPU kernel holds all heads in one program and
// carries the state across the sequential grid axis; on Hopper blocks run
// in parallel and carry nothing, so one block owns one (b, h) and walks the
// chunks in a loop, with the (P, N) state in shared memory for the whole
// sequence. B and C are read by group (g = h / rep) straight from the
// (B, L, G, N) projections, not from a copy broadcast to heads. Each chunk
// stages x, B (transposed), C, the masked decay-weight matrix W and the
// state in shared memory (about 82 KB at cs = P = N = 64, above the 48 KB
// a launch gets without asking, so the entry point raises the limit with
// cudaFuncSetAttribute); every product is laid out so that a warp reads
// consecutive words or one broadcast word. The decay is masked before the
// exponential (W = 0 for u > t, where lc[t] - lc[u] > 0 could overflow).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) ssd_kernel(
    float* __restrict__ y, float* __restrict__ hout,
    const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const float* __restrict__ Bm,
    const float* __restrict__ Cm, const float* __restrict__ D,
    const float* __restrict__ h0, const int64_t L, const int H, const int P,
    const int G, const int N, const int cs) {
  const int h = blockIdx.x;
  const int64_t b = blockIdx.y;
  const int g = h / (H / G);
  const int tid = threadIdx.x;
  const int ldb = cs + 1;  // padded rows: transposed stores hit distinct banks
  const int ldh = P + 1;
  extern __shared__ float sm[];
  float* xs = sm;                  // [u][p]   cs x P
  float* BT = xs + cs * P;         // [n][u]   N x ldb
  float* Cs = BT + N * ldb;        // [t][n]   cs x N
  float* W = Cs + cs * N;          // [t][u]   cs x cs
  float* hT = W + cs * cs;         // [n][p]   N x ldh, the carried state
  float* lc = hT + N * ldh;        // cs: cumulative log decay
  float* dts = lc + cs;            // cs: dt
  float* co = dts + cs;            // cs: exp(lc[cs-1] - lc[u]) * dt[u]
  float* es = co + cs;             // cs: exp(lc[t])

  const float a = A[h];
  const float dskip = D != nullptr ? D[h] : 0.0f;
  const int64_t hbase = (b * H + h) * static_cast<int64_t>(P) * N;
  for (int i = tid; i < N * P; i += kThreads) {
    const int p = i / N, n = i % N;  // global layout [p][n]: n fastest
    hT[n * ldh + p] = h0 != nullptr ? h0[hbase + i] : 0.0f;
  }

  for (int64_t c0 = 0; c0 < L; c0 += cs) {
    for (int i = tid; i < cs * P; i += kThreads) {
      const int u = i / P, p = i % P;
      xs[i] = x[((b * L + c0 + u) * H + h) * P + p];
    }
    for (int i = tid; i < cs * N; i += kThreads) {
      const int t = i / N, n = i % N;
      const int64_t gi = ((b * L + c0 + t) * G + g) * N + n;
      Cs[i] = Cm[gi];
      BT[n * ldb + t] = Bm[gi];
    }
    for (int i = tid; i < cs; i += kThreads) dts[i] = dt[(b * L + c0 + i) * H + h];
    __syncthreads();
    if (tid == 0) {
      float acc = 0.0f;
      for (int t = 0; t < cs; ++t) {
        acc = acc + dts[t] * a;
        lc[t] = acc;
      }
    }
    __syncthreads();
    for (int i = tid; i < cs; i += kThreads) {
      es[i] = expf(lc[i]);
      co[i] = expf(lc[cs - 1] - lc[i]) * dts[i];
    }
    // W[t][u] = (C[t]·B[u]) * exp(lc[t] - lc[u]) * dt[u] for u <= t, else 0
    for (int i = tid; i < cs * cs; i += kThreads) {
      const int t = i / cs, u = i % cs;
      float w = 0.0f;
      if (u <= t) {
        float cb = 0.0f;
        for (int n = 0; n < N; ++n) cb = cb + Cs[t * N + n] * BT[n * ldb + u];
        w = cb * expf(lc[t] - lc[u]) * dts[u];
      }
      W[i] = w;
    }
    __syncthreads();
    for (int i = tid; i < cs * P; i += kThreads) {
      const int t = i / P, p = i % P;
      float yi = 0.0f;
      for (int n = 0; n < N; ++n) yi = yi + Cs[t * N + n] * hT[n * ldh + p];
      yi = yi * es[t];
      float ya = 0.0f;
      for (int u = 0; u <= t; ++u) ya = ya + W[t * cs + u] * xs[u * P + p];
      float out = yi + ya;
      if (D != nullptr) out = out + xs[i] * dskip;
      y[((b * L + c0 + t) * H + h) * P + p] = out;
    }
    __syncthreads();
    const float s_last = es[cs - 1];
    for (int i = tid; i < N * P; i += kThreads) {
      const int n = i / P, p = i % P;
      float dh = 0.0f;
      for (int u = 0; u < cs; ++u) dh = dh + co[u] * xs[u * P + p] * BT[n * ldb + u];
      hT[n * ldh + p] = hT[n * ldh + p] * s_last + dh;
    }
    __syncthreads();
  }
  for (int i = tid; i < N * P; i += kThreads) {
    const int p = i / N, n = i % N;
    hout[hbase + i] = hT[n * ldh + p];
  }
}

// Shared memory one launch needs, in bytes (kernels/ssd.py::smem_bytes
// computes the same to refuse a shape before the launch).
int64_t smem_bytes(int64_t P, int64_t N, int64_t cs) {
  return 4 * (cs * P + N * (cs + 1) + cs * N + cs * cs + N * (P + 1) + 4 * cs);
}

}  // namespace

extern "C" int launch(void* y, void* hout, const void* x, const void* dt,
                      const void* A, const void* Bm, const void* Cm,
                      const void* D, const void* h0, int64_t B, int64_t L,
                      int64_t H, int64_t P, int64_t G, int64_t N, int64_t cs,
                      void* stream) {
  const int64_t smem = smem_bytes(P, N, cs);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(H), static_cast<unsigned>(B), 1);
  ssd_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(y), static_cast<float*>(hout),
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(Bm),
      static_cast<const float*>(Cm), static_cast<const float*>(D),
      static_cast<const float*>(h0), L, static_cast<int>(H),
      static_cast<int>(P), static_cast<int>(G), static_cast<int>(N),
      static_cast<int>(cs));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

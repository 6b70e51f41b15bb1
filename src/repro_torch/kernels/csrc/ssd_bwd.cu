// Hand-written CUDA kernels for the backward pass of the Mamba2 SSD chunk
// scan (csrc/ssd.cu is the forward). Per batch row b and head h, with
// g = h / (H / G) the head's state group, the forward's recurrence is
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
// states and their gradients apart: one pass walks forward with h, one
// backward with G, and neither needs the other.
//
// The TPU kernel src/repro/kernels/ssd.py::ssd_chunk_scan (pl.pallas_call at
// :78) has no backward: the reference differentiates its chunked jnp twin
// (src/repro/kernels/ops.py:159-205). This kernel is the gradient of the
// port's forward kernels, which training runs inside a
// torch.autograd.Function (kernels/ssd.py::SSDFn).
//
// What bounds it on the H100: operations, on the CUDA cores (the simple
// design below; the tensor cores come with a later redesign). Per step and
// state element the two walks do 14 f32 operations (an FMA counts 2):
//   forward walk:  h = a h + (dt x) B   (a multiply and an FMA: 3)
//                  y's row sum h·C      (an FMA: 2)
//                  dC's column sum h dy (an FMA: 2)
//   backward walk: G = a G + dy C       (a multiply and an FMA: 3)
//                  G·B's row sum        (an FMA: 2)
//                  dB's column sum G x  (an FMA: 2)
// At Zamba2's training shape (B = 4, L = 1024, H = 64, P = N = 64, G = 1)
// that is 14 x 1.07e9 = 15.0 GFLOP, 0.224 ms at 67 TFLOP/s, against 0.34 GB
// of inputs, chunk-start states and outputs (0.10 ms at 3.35 TB/s).
//
// What the design does. A block is one warp and owns R rows of one head's
// state (R = 32 for N <= 64, 16 up to N = 128): each lane holds the R rows of
// its columns n = lane + 32 j in registers. Inputs are staged in shared
// memory 16 steps at a time. A sum over n (y's rows, G·B) is a transposed
// butterfly of 31 __shfl_xor_sync that leaves row (lane mod R) in each lane;
// a sum over the tile's rows (dB, dC) is each lane's own.
// 1. ssd_bwd_forward, one block per (chunk, row tile, b·h): starts from the
//    forward's saved chunk-start state, walks the chunk forward and writes,
//    per step, the tile's part of dC_t and of dy_t·(h_t C_t).
// 2. ssd_bwd_reverse, one block per (row tile, b·h): walks every chunk
//    backward with G, writes dx and, per step, the tile's part of dB_t and
//    of e_t; then dh0 and the tile's parts of dD and <dh_final, h_final>.
// 3. ssd_bwd_fold_bc folds dB and dC over the group's heads and the row
//    tiles; ssd_bwd_fold_dt walks each (b, h) backward for dla (in double),
//    ddt and dA; ssd_bwd_fold_heads folds dA and dD over b. Every sum runs in
//    a fixed order: no atomics, the same bits on every call.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kStage = 16;     // steps staged in shared memory at a time
constexpr int kFold = 128;     // threads of a fold block

// v[k]: this lane's part of row k's sum over the warp's lanes (R = 16 or 32).
// Returns row (lane mod R)'s sum, in 31 shuffles: a plain sum over the lanes
// above R, then halves of the rows traded at each offset below it.
template <int R>
__device__ __forceinline__ float rows_sum(const float (&v)[R], int lane) {
  float w[R];
#pragma unroll
  for (int k = 0; k < R; ++k) w[k] = v[k];
#pragma unroll
  for (int o = 16; o >= R; o >>= 1) {
#pragma unroll
    for (int k = 0; k < R; ++k) w[k] += __shfl_xor_sync(kFull, w[k], o);
  }
#pragma unroll
  for (int o = R / 2; o >= 1; o >>= 1) {
    const bool hi = (lane & o) != 0;
#pragma unroll
    for (int k = 0; k < o; ++k) {
      const float send = hi ? w[k] : w[k + o];
      const float keep = hi ? w[k + o] : w[k];
      w[k] = keep + __shfl_xor_sync(kFull, send, o);
    }
  }
  return w[0];
}

__device__ __forceinline__ float lanes_sum(float v) {
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

template <int NJ>
struct Shape {
  static constexpr int kR = NJ <= 2 ? 32 : 16;  // state rows of a block
  static constexpr int kCols = 32 * NJ;         // state columns, padded
};

// x and dy rows p0 .. p0 + R of steps t0 .. t0 + kStage (zero past t1 or P),
// B and C of the group, dt (pointers at batch row b); one warp.
template <int NJ>
struct Staged {
  float x[kStage][Shape<NJ>::kR];
  float dy[kStage][Shape<NJ>::kR];
  float b[kStage][Shape<NJ>::kCols];
  float c[kStage][Shape<NJ>::kCols];
  float dt[kStage];
};

template <int NJ>
__device__ __forceinline__ void stage(Staged<NJ>& s, const float* x, const float* dy,
                                      const float* Bm, const float* Cm, const float* dt,
                                      int64_t t0, int64_t t1, int h, int grp,
                                      int p0, int64_t H, int P, int64_t G, int N, int lane) {
  constexpr int R = Shape<NJ>::kR, NC = Shape<NJ>::kCols;
  __syncthreads();  // every lane is done with the previous stage
  for (int i = lane; i < kStage * R; i += 32) {
    const int u = i / R, r = i % R;
    const int64_t t = t0 + u;
    const bool ok = t < t1 && p0 + r < P;
    const int64_t at = (t * H + h) * P + p0 + r;
    s.x[u][r] = ok ? x[at] : 0.0f;
    s.dy[u][r] = ok ? dy[at] : 0.0f;
  }
  for (int i = lane; i < kStage * NC; i += 32) {
    const int u = i / NC, n = i % NC;
    const int64_t t = t0 + u;
    const bool ok = t < t1 && n < N;
    const int64_t at = (t * G + grp) * N + n;
    s.b[u][n] = ok ? Bm[at] : 0.0f;
    s.c[u][n] = ok ? Cm[at] : 0.0f;
  }
  for (int u = lane; u < kStage; u += 32) s.dt[u] = t0 + u < t1 ? dt[(t0 + u) * H + h] : 0.0f;
  __syncthreads();
}

// Pass 1: the states of one chunk from its saved start state; per step the
// tile's part of dC_t (cpart) and of dy_t·(h_t C_t) (upart).
template <int NJ>
__global__ void __launch_bounds__(32) ssd_bwd_forward(
    float* __restrict__ cpart, float* __restrict__ upart, const float* __restrict__ states,
    const float* __restrict__ x, const float* __restrict__ dy, const float* __restrict__ dt,
    const float* __restrict__ A, const float* __restrict__ Bm, const float* __restrict__ Cm,
    const int64_t L, const int H, const int P, const int G, const int N, const int cs,
    const int nc) {
  constexpr int R = Shape<NJ>::kR;
  __shared__ Staged<NJ> s;
  const int c = blockIdx.x, tile = blockIdx.y, bh = blockIdx.z;
  const int ntiles = gridDim.y;
  const int64_t b = bh / H;
  const int h = bh % H, grp = h / (H / G), p0 = tile * R;
  const int lane = threadIdx.x;
  const float a_log = A[h];
  const int64_t t0 = static_cast<int64_t>(c) * cs;
  const int64_t t1 = t0 + cs < L ? t0 + cs : L;
  const float* xb = x + b * L * H * P;
  const float* dyb = dy + b * L * H * P;
  const float* Bb = Bm + b * L * G * N;
  const float* Cb = Cm + b * L * G * N;
  const float* dtb = dt + b * L * H;

  float st[R][NJ];
  const float* h_start = states + ((b * nc + c) * H + h) * static_cast<int64_t>(P) * N;
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int n = lane + 32 * j;
      st[r][j] = (p0 + r < P && n < N) ? h_start[static_cast<int64_t>(p0 + r) * N + n] : 0.0f;
    }
  }
  for (int64_t ts = t0; ts < t1; ts += kStage) {
    stage<NJ>(s, xb, dyb, Bb, Cb, dtb, ts, t1, h, grp, p0, H, P, G, N, lane);
    const int steps = t1 - ts < kStage ? static_cast<int>(t1 - ts) : kStage;
    for (int u = 0; u < steps; ++u) {
      const float d = s.dt[u];
      const float a = expf(d * a_log);
      float yrow[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float dx = d * s.x[u][r];
        float acc = 0.0f;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          st[r][j] = st[r][j] * a + dx * s.b[u][lane + 32 * j];
          acc += st[r][j] * s.c[u][lane + 32 * j];
        }
        yrow[r] = acc;
      }
      const float y = rows_sum<R>(yrow, lane);
      const float dot = lanes_sum(lane < R ? s.dy[u][lane] * y : 0.0f);
      const int64_t t = ts + u;
      const int64_t at = ((b * L + t) * H + h) * ntiles + tile;
      if (lane == 0) upart[at] = dot;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int n = lane + 32 * j;
        float acc = 0.0f;
#pragma unroll
        for (int r = 0; r < R; ++r) acc += st[r][j] * s.dy[u][r];
        if (n < N) cpart[at * N + n] = acc;
      }
    }
  }
}

// Pass 2: G backward over every chunk; dx, and per step the tile's part of
// dB_t (bpart) and of e_t (epart); then dh0, and the tile's parts of dD
// (ddpart) and of <dh_final, h_final> (hfpart).
template <int NJ>
__global__ void __launch_bounds__(32) ssd_bwd_reverse(
    float* __restrict__ dx, float* __restrict__ dh0, float* __restrict__ bpart,
    float* __restrict__ epart, float* __restrict__ ddpart, float* __restrict__ hfpart,
    const float* __restrict__ dy, const float* __restrict__ dh_final,
    const float* __restrict__ h_final, const float* __restrict__ x,
    const float* __restrict__ dt, const float* __restrict__ A, const float* __restrict__ Bm,
    const float* __restrict__ Cm, const float* __restrict__ D, const int64_t L, const int H,
    const int P, const int G, const int N) {
  constexpr int R = Shape<NJ>::kR;
  __shared__ Staged<NJ> s;
  const int tile = blockIdx.x, bh = blockIdx.y;
  const int ntiles = gridDim.x;
  const int64_t b = bh / H;
  const int h = bh % H, grp = h / (H / G), p0 = tile * R;
  const int lane = threadIdx.x;
  const float a_log = A[h];
  const float dskip = D != nullptr ? D[h] : 0.0f;
  const int64_t state = static_cast<int64_t>(bh) * P * N;
  const float* xb = x + b * L * H * P;
  const float* dyb = dy + b * L * H * P;
  const float* Bb = Bm + b * L * G * N;
  const float* Cb = Cm + b * L * G * N;
  const float* dtb = dt + b * L * H;

  float gs[R][NJ];
  float hf = 0.0f;
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int n = lane + 32 * j;
      const bool ok = dh_final != nullptr && p0 + r < P && n < N;
      const int64_t at = state + static_cast<int64_t>(p0 + r) * N + n;
      gs[r][j] = ok ? dh_final[at] : 0.0f;
      if (ok) hf += gs[r][j] * h_final[at];
    }
  }
  hf = lanes_sum(hf);
  float a_next = 1.0f, dd = 0.0f;
  const int row = lane % R;
  const int64_t nstages = (L + kStage - 1) / kStage;
  for (int64_t k = nstages - 1; k >= 0; --k) {
    const int64_t ts = k * kStage;
    const int64_t t1 = ts + kStage < L ? ts + kStage : L;
    stage<NJ>(s, xb, dyb, Bb, Cb, dtb, ts, t1, h, grp, p0, H, P, G, N, lane);
    for (int u = static_cast<int>(t1 - ts) - 1; u >= 0; --u) {
      const float d = s.dt[u];
      float gb[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float dyr = s.dy[u][r];
        float acc = 0.0f;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          gs[r][j] = gs[r][j] * a_next + dyr * s.c[u][lane + 32 * j];
          acc += gs[r][j] * s.b[u][lane + 32 * j];
        }
        gb[r] = acc;
      }
      const float gbr = rows_sum<R>(gb, lane);
      const int64_t t = ts + u;
      const float xr = s.x[u][row], dyr = s.dy[u][row];
      if (lane < R && p0 + row < P) dx[((b * L + t) * H + h) * P + p0 + row] = d * gbr + dskip * dyr;
      const float e = lanes_sum(lane < R ? xr * gbr : 0.0f);
      if (lane < R) dd += dyr * xr;
      const int64_t at = ((b * L + t) * H + h) * ntiles + tile;
      if (lane == 0) epart[at] = e;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int n = lane + 32 * j;
        float acc = 0.0f;
#pragma unroll
        for (int r = 0; r < R; ++r) acc += gs[r][j] * s.x[u][r];
        if (n < N) bpart[at * N + n] = d * acc;
      }
      a_next = expf(d * a_log);
    }
  }
  if (dh0 != nullptr) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int n = lane + 32 * j;
        if (p0 + r < P && n < N) dh0[state + static_cast<int64_t>(p0 + r) * N + n] = a_next * gs[r][j];
      }
    }
  }
  dd = lanes_sum(dd);
  if (lane == 0) {
    ddpart[static_cast<int64_t>(bh) * ntiles + tile] = dd;
    hfpart[static_cast<int64_t>(bh) * ntiles + tile] = hf;
  }
}

// dB and dC (B, L, G, N): the parts of the group's heads and the row tiles,
// summed in order.
__global__ void __launch_bounds__(kFold) ssd_bwd_fold_bc(
    float* __restrict__ dB, float* __restrict__ dC, const float* __restrict__ bpart,
    const float* __restrict__ cpart, const int64_t total, const int H, const int G,
    const int N, const int ntiles) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kFold + threadIdx.x;
  if (i >= total) return;
  const int n = static_cast<int>(i % N);
  const int64_t bt = i / (static_cast<int64_t>(G) * N);
  const int grp = static_cast<int>((i / N) % G);
  const int rep = H / G;
  float sb = 0.0f, sc = 0.0f;
  for (int hh = grp * rep; hh < (grp + 1) * rep; ++hh) {
    for (int tile = 0; tile < ntiles; ++tile) {
      const int64_t at = ((bt * H + hh) * ntiles + tile) * N + n;
      sb += bpart[at];
      sc += cpart[at];
    }
  }
  dB[i] = sb;
  dC[i] = sc;
}

// Per (b, h): dla backward over t in double, ddt, and the (b, h) parts of
// dA and dD.
__global__ void __launch_bounds__(kFold) ssd_bwd_fold_dt(
    float* __restrict__ ddt, float* __restrict__ da_bh, float* __restrict__ dd_bh,
    const float* __restrict__ upart, const float* __restrict__ epart,
    const float* __restrict__ ddpart, const float* __restrict__ hfpart,
    const float* __restrict__ dt, const float* __restrict__ A, const int64_t BH,
    const int64_t L, const int H, const int ntiles) {
  const int64_t bh = static_cast<int64_t>(blockIdx.x) * kFold + threadIdx.x;
  if (bh >= BH) return;
  const int64_t b = bh / H;
  const int h = static_cast<int>(bh % H);
  const float a_log = A[h];
  double suffix = 0.0, da = 0.0, hf = 0.0, dd = 0.0;
  for (int tile = 0; tile < ntiles; ++tile) {
    hf += hfpart[bh * ntiles + tile];
    dd += ddpart[bh * ntiles + tile];
  }
  for (int64_t t = L - 1; t >= 0; --t) {
    const int64_t at = ((b * L + t) * H + h) * ntiles;
    float e = 0.0f, u = 0.0f;
    for (int tile = 0; tile < ntiles; ++tile) {
      e += epart[at + tile];
      u += upart[at + tile];
    }
    const float d = dt[(b * L + t) * H + h];
    suffix += static_cast<double>(u) - static_cast<double>(d) * e;
    const double dla = suffix + hf;
    ddt[(b * L + t) * H + h] = static_cast<float>(e + a_log * dla);
    da += d * dla;
  }
  da_bh[bh] = static_cast<float>(da);
  dd_bh[bh] = static_cast<float>(dd);
}

// dA[h] and dD[h]: the (b, h) parts summed over b in order.
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

template <int NJ>
int launch_nj(cudaStream_t st, float* dx, float* dh0, float* cpart, float* bpart, float* upart,
              float* epart, float* ddpart, float* hfpart, const float* dy,
              const float* dh_final, const float* h_final, const float* states,
              const float* x, const float* dt, const float* A, const float* Bm,
              const float* Cm, const float* D, int64_t B, int64_t L, int H, int P, int G,
              int N, int cs, int nc, int ntiles) {
  const dim3 block(32, 1, 1);
  if (nc > 0) {
    const dim3 grid(static_cast<unsigned>(nc), static_cast<unsigned>(ntiles),
                    static_cast<unsigned>(B * H));
    ssd_bwd_forward<NJ><<<grid, block, 0, st>>>(
        cpart, upart, states, x, dy, dt, A, Bm, Cm, L, H, P, G, N, cs, nc);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned>(ntiles), static_cast<unsigned>(B * H), 1);
  ssd_bwd_reverse<NJ><<<grid, block, 0, st>>>(
      dx, dh0, bpart, epart, ddpart, hfpart, dy, dh_final, h_final, x, dt, A, Bm, Cm, D, L,
      H, P, G, N);
  return static_cast<int>(cudaGetLastError());
}

int launch_folds(cudaStream_t st, float* ddt, float* dA, float* dB, float* dC, float* dD,
                 const float* cpart, const float* bpart, const float* upart,
                 const float* epart, const float* ddpart, const float* hfpart, float* da_bh,
                 float* dd_bh, const float* dt, const float* A, int64_t B, int64_t L, int H,
                 int G, int N, int ntiles) {
  const dim3 block(kFold, 1, 1);
  const int64_t total = B * L * G * N;
  if (total > 0) {
    const dim3 grid(static_cast<unsigned>((total + kFold - 1) / kFold), 1, 1);
    ssd_bwd_fold_bc<<<grid, block, 0, st>>>(
        dB, dC, bpart, cpart, total, H, G, N, ntiles);
  }
  {
    const dim3 grid(static_cast<unsigned>((B * H + kFold - 1) / kFold), 1, 1);
    ssd_bwd_fold_dt<<<grid, block, 0, st>>>(
        ddt, da_bh, dd_bh, upart, epart, ddpart, hfpart, dt, A, B * H, L, H, ntiles);
  }
  {
    const dim3 grid(static_cast<unsigned>((H + kFold - 1) / kFold), 1, 1);
    ssd_bwd_fold_heads<<<grid, block, 0, st>>>(
        dA, dD, da_bh, dd_bh, B, H);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Rows of the state a block owns at state size N (kernels/ssd.py::bwd_rows
// computes the same).
extern "C" int state_rows(int64_t N) { return N <= 64 ? 32 : 16; }

// f32 scratch the backward needs: the per-step parts of dB and dC, of e and
// of dy·(h C); the (b, h, tile) parts of dD and <dh_final, h_final>; the
// (b, h) parts of dA and dD.
extern "C" int64_t work_floats(int64_t B, int64_t L, int64_t H, int64_t N, int64_t ntiles) {
  return 2 * B * L * H * ntiles * N + 2 * B * L * H * ntiles + 2 * B * H * ntiles + 2 * B * H;
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
  const int rows = state_rows(N);
  const int ntiles = static_cast<int>((P + rows - 1) / rows);
  if (N < 1 || N > 128 || work_size < work_floats(B, L, H, N, ntiles))
    return static_cast<int>(cudaErrorInvalidValue);
  float* w = static_cast<float*>(work);
  float* cpart = w;
  float* bpart = cpart + B * L * H * ntiles * N;
  float* upart = bpart + B * L * H * ntiles * N;
  float* epart = upart + B * L * H * ntiles;
  float* ddpart = epart + B * L * H * ntiles;
  float* hfpart = ddpart + B * H * ntiles;
  float* da_bh = hfpart + B * H * ntiles;
  float* dd_bh = da_bh + B * H;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  const int h = static_cast<int>(H), p = static_cast<int>(P), g = static_cast<int>(G);
  const int n = static_cast<int>(N), c = static_cast<int>(cs), k = static_cast<int>(nc);
  int err = 0;
  switch ((N + 31) / 32) {
    case 1:
      err = launch_nj<1>(st, static_cast<float*>(dx), static_cast<float*>(dh0), cpart, bpart,
                         upart, epart, ddpart, hfpart, f(dy), f(dh_final), f(h_final),
                         f(states), f(x), f(dt), f(A), f(Bm), f(Cm), f(D), B, L, h, p, g, n,
                         c, k, ntiles);
      break;
    case 2:
      err = launch_nj<2>(st, static_cast<float*>(dx), static_cast<float*>(dh0), cpart, bpart,
                         upart, epart, ddpart, hfpart, f(dy), f(dh_final), f(h_final),
                         f(states), f(x), f(dt), f(A), f(Bm), f(Cm), f(D), B, L, h, p, g, n,
                         c, k, ntiles);
      break;
    case 3:
      err = launch_nj<3>(st, static_cast<float*>(dx), static_cast<float*>(dh0), cpart, bpart,
                         upart, epart, ddpart, hfpart, f(dy), f(dh_final), f(h_final),
                         f(states), f(x), f(dt), f(A), f(Bm), f(Cm), f(D), B, L, h, p, g, n,
                         c, k, ntiles);
      break;
    default:
      err = launch_nj<4>(st, static_cast<float*>(dx), static_cast<float*>(dh0), cpart, bpart,
                         upart, epart, ddpart, hfpart, f(dy), f(dh_final), f(h_final),
                         f(states), f(x), f(dt), f(A), f(Bm), f(Cm), f(D), B, L, h, p, g, n,
                         c, k, ntiles);
  }
  if (err != 0) return err;
  return launch_folds(st, static_cast<float*>(ddt), static_cast<float*>(dA),
                      static_cast<float*>(dB), static_cast<float*>(dC),
                      static_cast<float*>(dD), cpart, bpart, upart, epart, ddpart, hfpart,
                      da_bh, dd_bh, f(dt), f(A), B, L, h, g, n, ntiles);
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Hand-written CUDA kernel for the paper's Fig. 1 explicit diffusion step:
//
//   out[inn] = T + dt * ((lam * Ci) * lap(T)),
//   lap(T)   = ((T[x+1] - 2 T[x]) + T[x-1]) * idx2
//            + ((T[y+1] - 2 T[y]) + T[y-1]) * idy2
//            + ((T[z+1] - 2 T[z]) + T[z-1]) * idz2,
//   out      = T2 on the boundary ring,
//
// and its k-step form, k such steps in one launch.
//
// Replaces the Pallas TPU kernel src/repro/kernels/diffusion3d.py::
// diffusion3d_step (pl.pallas_call at :75, body _body at :30), nsteps = 1
// (diffusion3d_kernel) and nsteps = k > 1 (diffusion3d_steps_kernel).
//
// What bounds it on the H100: bytes. A step must read T and Ci and write the
// output once, 12 bytes per cell, against about 16 f32 operations per cell,
// far below the card's ratio of f32 operations to memory bytes (about 20), so
// the single step cannot beat 12 bytes per cell over the memory rate. k
// steps in one launch read T and Ci and write the output once, 12 / k bytes
// per cell-step, and do 16 (1 + o) operations per cell-step, o the share of
// cells a block recomputes in its halo; from k = 2 on the operations and
// the shared-memory traffic bound it, not device memory.
//
// What the single step's design does about it (the paper's `loopopt`): each
// thread owns one (y, z) column segment and marches along x, keeping
// T[x-1], T[x] and T[x+1] in registers, so the x neighbours cost no second
// load. threadIdx.x runs along z, the contiguous axis of the C-order
// layout, so a warp's loads of a plane coalesce into whole 128-byte lines;
// the y and z neighbours are loaded again by neighbouring threads and come
// from L1/L2, not from device memory. The x axis is cut into chunks (xc
// planes each) so that a 512^3 grid gives several waves of blocks over the
// card's SMs.
//
// The k-step form keeps the column march and pipelines the k sweeps along
// x, two planes per step of the march, in the layout the generated k-step
// kernel of the same update was fastest in (32 x 16 threads). At each step
// a block stages T's two planes k planes ahead over its tile and k cells of
// halo per side into a queue of 4 planes in shared memory, then sweep s
// (s < k - 1) computes its two planes k - 1 - s planes ahead over the tile
// and k - 1 - s cells of halo from the previous queue into its own, and the
// last sweep writes the tile's two planes from the queue of sweep k - 2. So
// T crosses device memory once, Ci is read once per sweep through L1, and
// only the last sweep writes. The halo cone costs (32 + 2h)(16 + 2h) / 512
// cells of work at halo h (the reference's halo_compute_overhead). One
// barrier per sweep and step. A sweep on an interior block runs unrolled,
// without a branch, its cells' values in registers before any store. As in
// the reference, an intermediate sweep keeps T's value on the boundary ring
// and the last takes T2's there: the result equals k rotated single steps
// when T2 and T agree on the ring.
//
// Storage: every kernel is a template on the storage type S of T2, T, Ci and
// the output (float, __nv_bfloat16 or __half). As in the reference, whose
// Pallas body computes at the fields' own dtype, a bf16 or f16 step computes
// at the storage type: each operation's f32 result is rounded to S
// (rnd<S>), the scalars arrive already rounded to S, and the queues of the
// k-step form hold S. Rounding an f32 +, - or x of two S values to S equals
// that operation in S, since f32 keeps at least 2p + 2 bits of S's p; so the
// kernel equals the plain version, which PyTorch runs on bf16 or f16
// tensors one operation at a time. A bf16 step reads and writes 6 bytes per
// cell, half the f32 step's.
//
// The order of operations is the plain version's (kernels/ref.py), and the
// build passes --fmad=false, so the kernel and the plain version agree
// bitwise. The output may be T2's own buffer (alias): T2 is read only on
// the ring, and there only where `out` is another buffer (in place, the
// ring already holds T2's values), so no element is reached through two of
// the __restrict__ pointers (T and Ci never share storage with `out`).
// Without __restrict__ on `out` and T2 the single step took 6% longer on
// the H100 (PERF.md), so it keeps them and is instantiated for each
// case, the in-place one never reading T2. The k-step form is instantiated
// for k = 2-4, the steps the card checks, each for the three storage types.
#include <cstdint>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>

namespace {

constexpr int kBlockZ = 32;
constexpr int kBlockY = 8;

// A stored value widened to f32, and an f32 value rounded to the storage
// type (to nearest even).
__device__ __forceinline__ float ld(const float v) { return v; }
__device__ __forceinline__ float ld(const __nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float ld(const __half v) { return __half2float(v); }
template <typename S> __device__ __forceinline__ S st(float v);
template <> __device__ __forceinline__ float st<float>(const float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 st<__nv_bfloat16>(const float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half st<__half>(const float v) {
  return __float2half_rn(v);
}
// An operation's f32 result rounded to S and widened back: arithmetic in S.
template <typename S> __device__ __forceinline__ float rnd(const float v) { return ld(st<S>(v)); }

// The explicit Euler update at one cell from its value tc, its six
// neighbours and Ci, in the plain version's order, each operation in S;
// the result stored as S.
template <typename S>
__device__ __forceinline__ S update(const float tc, const float xp, const float xm,
                                    const float yp, const float ym, const float zp,
                                    const float zm, const float ci, const float lam,
                                    const float dt, const float idx2, const float idy2,
                                    const float idz2) {
  const float c2 = rnd<S>(2.0f * tc);
  const float lap = rnd<S>(rnd<S>(rnd<S>(rnd<S>(rnd<S>(xp - c2) + xm) * idx2) +
                                  rnd<S>(rnd<S>(rnd<S>(yp - c2) + ym) * idy2)) +
                           rnd<S>(rnd<S>(rnd<S>(zp - c2) + zm) * idz2));
  return st<S>(tc + rnd<S>(dt * rnd<S>(rnd<S>(lam * ci) * lap)));
}

// kCopyRing: `out` is a buffer of its own and takes T2's ring; in place
// (`out` is T2's buffer) the ring already holds it and T2 is not read.
template <bool kCopyRing, typename S>
__global__ void __launch_bounds__(kBlockZ * kBlockY) diffusion3d_kernel(
    S* __restrict__ out, const S* __restrict__ T2,
    const S* __restrict__ T, const S* __restrict__ Ci,
    const float lam, const float dt, const float idx2, const float idy2,
    const float idz2, const int64_t nx, const int64_t ny, const int64_t nz,
    const int64_t xc) {
  const int64_t z = static_cast<int64_t>(blockIdx.x) * kBlockZ + threadIdx.x;
  const int64_t y = static_cast<int64_t>(blockIdx.y) * kBlockY + threadIdx.y;
  if (z >= nz || y >= ny) return;
  const int64_t sy = nz;
  const int64_t sx = ny * nz;
  const int64_t x0 = static_cast<int64_t>(blockIdx.z) * xc;
  const int64_t x1 = x0 + xc < nx ? x0 + xc : nx;
  int64_t i = x0 * sx + y * sy + z;
  if (y == 0 || y == ny - 1 || z == 0 || z == nz - 1) {
    if (kCopyRing) {
      for (int64_t x = x0; x < x1; ++x, i += sx) out[i] = T2[i];
    }
    return;
  }
  float tm = x0 > 0 ? ld(T[i - sx]) : 0.0f;
  float tc = ld(T[i]);
  for (int64_t x = x0; x < x1; ++x, i += sx) {
    if (x == 0 || x == nx - 1) {
      if (kCopyRing) out[i] = T2[i];
      tm = tc;
      if (x + 1 < nx) tc = ld(T[i + sx]);
      continue;
    }
    const float tp = ld(T[i + sx]);
    out[i] = update<S>(tc, tp, tm, ld(T[i + sy]), ld(T[i - sy]), ld(T[i + 1]), ld(T[i - 1]),
                       ld(Ci[i]), lam, dt, idx2, idy2, idz2);
    tm = tc;
    tc = tp;
  }
}

// The k-step kernel's layout, the one the generated k-step kernel of the
// same update was fastest in on the H100 (kernels/codegen_steps.py):
// 32 x 16 threads, two planes per step.
constexpr int kStepsY = 16;
constexpr int kThreads = kBlockZ * kStepsY;
constexpr int kP = 2;        // planes per step
constexpr int kSlots = 4;    // planes per queue: a step reads kP + 2 of them
constexpr int kMaxSteps = 4;   // the largest k the card checks

// Shared memory of the k-step kernel: queue q (0 <= q < k) of stored values
// over the tile and k - q cells of halo per side.
__host__ __device__ constexpr int queue_cells(int k, int q) {
  return kSlots * (kStepsY + 2 * (k - q)) * (kBlockZ + 2 * (k - q));
}

__host__ __device__ constexpr int shared_cells(int k) {
  int f = 0;
  for (int q = 0; q < k; ++q) f += queue_cells(k, q);
  return f;
}

// Resident blocks the k-step kernel's shared memory leaves room for, at most
// 2 (64 registers a thread: at 3 or 4 the unrolled sweeps spill).
template <typename S>
__host__ __device__ constexpr int min_blocks(int k) {
  return 232448 / (static_cast<int>(sizeof(S)) * shared_cells(k)) < 2
             ? 232448 / (static_cast<int>(sizeof(S)) * shared_cells(k)) : 2;
}

__device__ __forceinline__ int slot(int x) { return (x + (kSlots << 20)) & (kSlots - 1); }

// One sweep of the k-step kernel at planes x, x + 1 over the tile and H
// cells of halo: from queue `qin` (halo H + 1) into queue `qout`. On an
// interior block every cell takes the update, unrolled and without a branch,
// all of the thread's cells into registers before any is stored (a store to
// shared memory between them would hold back the next cell's loads);
// elsewhere a ring cell keeps T's value.
template <int H, typename S>
__device__ __forceinline__ void sweep(const S* __restrict__ qin, S* __restrict__ qout,
                                      const S* __restrict__ Ci, const int xa, const int y0,
                                      const int z0, const int tid, const int NX, const int NY,
                                      const int NZ, const int64_t sx, const int64_t sy,
                                      const float lam, const float dt, const float idx2,
                                      const float idy2, const float idz2) {
  constexpr int py = kStepsY + 2 * H, pz = kBlockZ + 2 * H, pzi = pz + 2;
  constexpr int pin = (py + 2) * pzi, n = py * pz, m = (n + kThreads - 1) / kThreads;
  if (xa >= 1 && xa + kP <= NX - 1 && y0 - H >= 1 && y0 + kStepsY + H <= NY - 1 &&
      z0 - H >= 1 && z0 + kBlockZ + H <= NZ - 1) {
    S v[kP * m];
    #pragma unroll
    for (int p = 0; p < kP; ++p) {
      const S* const cm = qin + slot(xa + p - 1) * pin;
      const S* const cc = qin + slot(xa + p) * pin;
      const S* const cp = qin + slot(xa + p + 1) * pin;
      const S* const ci = Ci + (xa + p) * sx;
      #pragma unroll
      for (int j = 0; j < m; ++j) {
        const int e = tid + j * kThreads;
        if (j < n / kThreads || e < n) {
          const int ly = e / pz, lz = e - ly * pz;
          const int i = (ly + 1) * pzi + lz + 1;
          v[p * m + j] = update<S>(ld(cc[i]), ld(cp[i]), ld(cm[i]), ld(cc[i + pzi]),
                                   ld(cc[i - pzi]), ld(cc[i + 1]), ld(cc[i - 1]),
                                   ld(ci[(y0 - H + ly) * sy + z0 - H + lz]), lam, dt, idx2,
                                   idy2, idz2);
        }
      }
    }
    #pragma unroll
    for (int p = 0; p < kP; ++p) {
      #pragma unroll
      for (int j = 0; j < m; ++j) {
        const int e = tid + j * kThreads;
        if (j < n / kThreads || e < n) qout[slot(xa + p) * n + e] = v[p * m + j];
      }
    }
    return;
  }
  #pragma unroll 1
  for (int p = 0; p < kP; ++p) {
    const int x = xa + p;
    const S* const cm = qin + slot(x - 1) * pin;
    const S* const cc = qin + slot(x) * pin;
    const S* const cp = qin + slot(x + 1) * pin;
    const bool xin = x >= 1 && x < NX - 1;
    #pragma unroll 1
    for (int e = tid; e < n; e += kThreads) {
      const int ly = e / pz, lz = e - ly * pz;
      const int y = y0 - H + ly, z = z0 - H + lz;
      const int i = (ly + 1) * pzi + lz + 1;
      S v = cc[i];  // the boundary ring keeps T's value
      if (xin && y >= 1 && y < NY - 1 && z >= 1 && z < NZ - 1) {
        v = update<S>(ld(cc[i]), ld(cp[i]), ld(cm[i]), ld(cc[i + pzi]), ld(cc[i - pzi]),
                      ld(cc[i + 1]), ld(cc[i - 1]), ld(Ci[x * sx + y * sy + z]), lam, dt, idx2,
                      idy2, idz2);
      }
      qout[slot(x) * n + e] = v;
    }
  }
}

template <int K, int Q, typename S>
__device__ __forceinline__ const S* sweeps(const S* qin, const S* __restrict__ Ci,
                                               const int xs, const int y0, const int z0,
                                               const int tid, const int NX, const int NY,
                                               const int NZ, const int64_t sx,
                                               const int64_t sy, const float lam,
                                               const float dt, const float idx2,
                                               const float idy2, const float idz2) {
  if constexpr (Q == K - 1) {
    return qin;
  } else {  // sweep Q: planes xs + H, xs + H + 1 over the tile and H cells of halo
    constexpr int H = K - 1 - Q;
    S* const qout = const_cast<S*>(qin) + queue_cells(K, Q);
    sweep<H, S>(qin, qout, Ci, xs + H, y0, z0, tid, NX, NY, NZ, sx, sy, lam, dt, idx2, idy2,
                idz2);
    __syncthreads();
    return sweeps<K, Q + 1, S>(qout, Ci, xs, y0, z0, tid, NX, NY, NZ, sx, sy, lam, dt, idx2,
                               idy2, idz2);
  }
}

template <int K, typename S>
__global__ void __launch_bounds__(kThreads, min_blocks<S>(K)) diffusion3d_steps_kernel(
    S* __restrict__ out, const S* __restrict__ T2,
    const S* __restrict__ T, const S* __restrict__ Ci,
    const float lam, const float dt, const float idx2, const float idy2,
    const float idz2, const int64_t nx, const int64_t ny, const int64_t nz,
    const int64_t xc) {
  extern __shared__ float smem[];
  S* const queues = reinterpret_cast<S*>(smem);
  const int tz = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kBlockZ + tz;
  const int z0 = blockIdx.x * kBlockZ, y0 = blockIdx.y * kStepsY;
  const int x0 = blockIdx.z * static_cast<int>(xc);
  const int x1 = min(x0 + static_cast<int>(xc), static_cast<int>(nx));
  const int NX = static_cast<int>(nx), NY = static_cast<int>(ny), NZ = static_cast<int>(nz);
  const int64_t sy = nz;
  const int64_t sx = ny * nz;
  constexpr int py = kStepsY + 2 * K, pz = kBlockZ + 2 * K, n = py * pz;
  constexpr int m = (n + kThreads - 1) / kThreads;
  #pragma unroll 1
  for (int xs = x0 - 2 * K; xs < x1; xs += kP) {
    {  // T's planes xs + K, xs + K + 1 over the tile and K cells of halo
      S v[kP * m];
      #pragma unroll
      for (int p = 0; p < kP; ++p) {
        const int x = xs + K + p;
        const bool xin = x >= 0 && x < NX;
        #pragma unroll
        for (int j = 0; j < m; ++j) {
          const int e = tid + j * kThreads;
          const int ly = e / pz, lz = e - ly * pz;
          const int y = y0 - K + ly, z = z0 - K + lz;
          v[p * m + j] = xin && e < n && y >= 0 && y < NY && z >= 0 && z < NZ
                             ? T[x * sx + y * sy + z] : S{};
        }
      }
      #pragma unroll
      for (int p = 0; p < kP; ++p) {
        #pragma unroll
        for (int j = 0; j < m; ++j) {
          const int e = tid + j * kThreads;
          if (j < n / kThreads || e < n) queues[slot(xs + K + p) * n + e] = v[p * m + j];
        }
      }
    }
    __syncthreads();
    const S* const qin = sweeps<K, 0, S>(queues, Ci, xs, y0, z0, tid, NX, NY, NZ, sx, sy, lam,
                                         dt, idx2, idy2, idz2);
    // the last sweep: the tile's planes xs, xs + 1, from the queue of sweep K - 2
    const int y = y0 + ty, z = z0 + tz;
    constexpr int pzi = kBlockZ + 2, pin = (kStepsY + 2) * pzi;
    const int i = (ty + 1) * pzi + tz + 1;
    #pragma unroll
    for (int p = 0; p < kP; ++p) {
      const int x = xs + p;
      if (x >= x0 && x < x1 && y < NY && z < NZ) {
        const S* const cc = qin + slot(x) * pin;
        const int64_t g = x * sx + y * sy + z;
        if (x >= 1 && x < NX - 1 && y >= 1 && y < NY - 1 && z >= 1 && z < NZ - 1) {
          out[g] = update<S>(ld(cc[i]), ld(qin[slot(x + 1) * pin + i]),
                             ld(qin[slot(x - 1) * pin + i]), ld(cc[i + pzi]), ld(cc[i - pzi]),
                             ld(cc[i + 1]), ld(cc[i - 1]), ld(Ci[g]), lam, dt, idx2, idy2, idz2);
        } else if (T2 != out) {
          out[g] = T2[g];
        }
      }
    }
  }
}

template <int K, typename S>
int launch_steps(const dim3 grid, const cudaStream_t st, S* out, const S* T2,
                 const S* T, const S* Ci, float lam, float dt, float idx2,
                 float idy2, float idz2, int64_t nx, int64_t ny, int64_t nz, int64_t xc,
                 int k) {
  if (k != K) {
    if constexpr (K < kMaxSteps) {
      return launch_steps<K + 1, S>(grid, st, out, T2, T, Ci, lam, dt, idx2, idy2, idz2, nx,
                                    ny, nz, xc, k);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  constexpr int bytes = static_cast<int>(sizeof(S)) * shared_cells(K);
  const cudaError_t set = cudaFuncSetAttribute(
      diffusion3d_steps_kernel<K, S>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (set != cudaSuccess) return static_cast<int>(set);
  const dim3 block(kBlockZ, kStepsY, 1);
  diffusion3d_steps_kernel<K, S><<<grid, block, bytes, st>>>(
      out, T2, T, Ci, lam, dt, idx2, idy2, idz2, nx, ny, nz, xc);
  return static_cast<int>(cudaGetLastError());
}

template <typename S>
int launch_typed(void* out, const void* T2, const void* T, const void* Ci, float lam, float dt,
                 float idx2, float idy2, float idz2, int64_t nx, int64_t ny, int64_t nz,
                 int64_t xc, int64_t nsteps, const dim3 grid, const cudaStream_t st) {
  if (nsteps == 1) {
    const dim3 block(kBlockZ, kBlockY, 1);
    const auto kernel = out == T2 ? diffusion3d_kernel<false, S> : diffusion3d_kernel<true, S>;
    kernel<<<grid, block, 0, st>>>(
        static_cast<S*>(out), static_cast<const S*>(T2), static_cast<const S*>(T),
        static_cast<const S*>(Ci), lam, dt, idx2, idy2, idz2, nx, ny, nz, xc);
    return static_cast<int>(cudaGetLastError());
  }
  return launch_steps<2, S>(grid, st, static_cast<S*>(out), static_cast<const S*>(T2),
                            static_cast<const S*>(T), static_cast<const S*>(Ci), lam, dt, idx2,
                            idy2, idz2, nx, ny, nz, xc, static_cast<int>(nsteps));
}

}  // namespace

// storage: 0 float, 1 __nv_bfloat16, 2 __half (the scalars already rounded
// to it by the caller).
extern "C" int launch(void* out, const void* T2, const void* T, const void* Ci,
                      float lam, float dt, float idx2, float idy2, float idz2,
                      int64_t nx, int64_t ny, int64_t nz, int64_t xc, int64_t nsteps,
                      int64_t storage, int64_t gz, int64_t gy, int64_t gx, void* stream) {
  const dim3 grid(static_cast<unsigned>(gz), static_cast<unsigned>(gy),
                  static_cast<unsigned>(gx));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (storage == 1) {
    return launch_typed<__nv_bfloat16>(out, T2, T, Ci, lam, dt, idx2, idy2, idz2, nx, ny, nz,
                                       xc, nsteps, grid, st);
  }
  if (storage == 2) {
    return launch_typed<__half>(out, T2, T, Ci, lam, dt, idx2, idy2, idz2, nx, ny, nz, xc,
                                nsteps, grid, st);
  }
  return launch_typed<float>(out, T2, T, Ci, lam, dt, idx2, idy2, idz2, nx, ny, nz, xc, nsteps,
                             grid, st);
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

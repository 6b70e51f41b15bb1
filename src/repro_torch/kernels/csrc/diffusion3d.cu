// Hand-written CUDA kernels for the paper's Fig. 1 explicit diffusion step:
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
// (diffusion3d_kernel, and diffusion3d_pairs_kernel for 2-byte fields) and
// nsteps = k > 1 (diffusion3d_steps_kernel).
//
// What bounds it on the H100: bytes. A step must read T and Ci and write the
// output once, 12 bytes per cell, against about 16 f32 operations per cell,
// far below the card's ratio of f32 operations to memory bytes (about 20), so
// the single step cannot beat 12 bytes per cell over the memory rate. k
// steps in one launch read T and Ci and write the output once, 12 / k bytes
// per cell-step, and do 16 (1 + o) operations per cell-step, o the share of
// cells a block recomputes in its halo; from k = 2 on the operations, the
// shared-memory traffic and the latency a block waits out at each barrier
// bound it, not device memory.
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
// Storage: every kernel is a template on the storage type S of T2, T, Ci and
// the output (float, __nv_bfloat16 or __half). As in the reference, whose
// Pallas body computes at the fields' own dtype, a bf16 or f16 step computes
// at the storage type: each operation's result is S's rounding of the exact
// one, and the scalars arrive already rounded to S. Rounding an f32 +, - or
// x of two S values to S equals that operation in S, since f32 keeps at
// least 2p + 2 bits of S's p; so the kernel equals the plain version, which
// PyTorch runs on bf16 or f16 tensors one operation at a time. A bf16 step
// reads and writes 6 bytes per cell, half the f32 step's.
//
// At 2 bytes two cells share each operation (Packed<S>): the packed
// arithmetic of the card's half-precision units, __hadd2_rn and __hmul2_rn
// (a - b as a + (-b), __hneg2; never __hfma2, which would round once for
// two operations), each rounding to nearest even with subnormals kept, so
// each equals f32-then-round (chip_smoke.py's packed_ops probe holds every
// pair of 16-bit operands to it on the card). The one-cell single step
// (diffusion3d_kernel) instead widens each value, computes in f32 and
// rounds each result (rnd<S>): 17 conversions a cell, nearly all of its
// time on the card (PERF.md), which is why a 2-byte step takes the pair
// layout wherever it fits. f32 keeps one cell an operation (Packed<float>
// is two plain f32 operations).
//
// The 2-byte single step in the pair layout (diffusion3d_pairs_kernel):
// each thread owns two adjacent z cells as one 4-byte word, so a warp's row
// is 128 bytes; a cell's z neighbours come from the neighbouring aligned
// words, each half moved exactly (__halves2bfloat162, __low2bfloat16,
// __high2bfloat16 and their __half2 counterparts). It needs nz even and
// every field 4-byte aligned; otherwise the one-cell kernel launches
// (pairs_fit, the rule kernels/diffusion3d.py sizes the grid by).
//
// The k-step form (diffusion3d_steps_kernel<K, S>) pipelines the K sweeps
// along x, two planes per step of the march, in a tile of 32 cells along z
// and R rows along y (tile_rows: fewer at larger k) walked by 256 threads:
// each phase (staging and each sweep) covers its region, the tile and its
// halo cone, in rounds of the block's threads, one cell a round. At each
// step T's two planes K planes ahead, over the tile and K cells of halo per
// side, arrive in a ring of 6 planes in shared memory: a step ahead, by
// cp.async at f32 (the copies land while the step before sweeps), through
// registers at 2 bytes (cp.async moves at least 4 bytes; the loads are
// issued a step ahead and stored after that step's last sweep). Then sweep
// s (s < K - 1) computes its two planes K - 1 - s planes ahead over the
// tile and h = K - 1 - s cells of halo from the queue before it into its
// own (4 planes: the 2 + 2 the next sweep reads), and the last sweep writes
// the tile's two planes to device memory. Every cell of a region takes the
// same branch-free code: the queues hold each region whole (T is zero
// outside the field), so a sweep loads every tap unconditionally and keeps
// the cell's input where the cell is not in the core (x, y, z in [1, n-1));
// only the last sweep's stores are guarded. Ci either arrives through a
// ring of its own (K + 3 planes over K - 1 cells of halo, one read of each
// cell) or is read by each sweep through L1 at clamped coordinates
// (stage_ci: the ring, 10-38% faster on the card where two blocks fit either
// way). One barrier a sweep. The halo cone costs (32 + 2h)(R + 2h) / 32R
// cells of work at halo h. Two blocks an SM, 128 registers a thread: at
// three the 2-byte sweeps spill. As in the reference, an intermediate sweep
// keeps T's value on the boundary ring and the last takes T2's there: the
// result equals k rotated single steps when T2 and T agree on the ring.
//
// The order of operations is the plain version's (kernels/ref.py), and the
// build passes --fmad=false, so the kernels and the plain version agree
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


// Two cells a value: an operation on both at once, each half S's rounding
// of the exact result. f32: two plain operations.
template <typename S> struct Packed;
template <> struct Packed<float> {
  using V = float2;
  static __device__ __forceinline__ V pack(const float lo, const float hi) {
    return make_float2(lo, hi);
  }
  static __device__ __forceinline__ float lo(const V v) { return v.x; }
  static __device__ __forceinline__ float hi(const V v) { return v.y; }
  static __device__ __forceinline__ V add(const V a, const V b) {
    return make_float2(a.x + b.x, a.y + b.y);
  }
  static __device__ __forceinline__ V sub(const V a, const V b) {
    return make_float2(a.x - b.x, a.y - b.y);
  }
  static __device__ __forceinline__ V mul(const V a, const V b) {
    return make_float2(a.x * b.x, a.y * b.y);
  }
};
template <> struct Packed<__nv_bfloat16> {
  using V = __nv_bfloat162;
  static __device__ __forceinline__ V pack(const __nv_bfloat16 lo, const __nv_bfloat16 hi) {
    return __halves2bfloat162(lo, hi);
  }
  static __device__ __forceinline__ __nv_bfloat16 lo(const V v) { return __low2bfloat16(v); }
  static __device__ __forceinline__ __nv_bfloat16 hi(const V v) { return __high2bfloat16(v); }
  static __device__ __forceinline__ V add(const V a, const V b) { return __hadd2_rn(a, b); }
  static __device__ __forceinline__ V sub(const V a, const V b) {
    return __hadd2_rn(a, __hneg2(b));
  }
  static __device__ __forceinline__ V mul(const V a, const V b) { return __hmul2_rn(a, b); }
};
template <> struct Packed<__half> {
  using V = __half2;
  static __device__ __forceinline__ V pack(const __half lo, const __half hi) {
    return __halves2half2(lo, hi);
  }
  static __device__ __forceinline__ __half lo(const V v) { return __low2half(v); }
  static __device__ __forceinline__ __half hi(const V v) { return __high2half(v); }
  static __device__ __forceinline__ V add(const V a, const V b) { return __hadd2_rn(a, b); }
  static __device__ __forceinline__ V sub(const V a, const V b) {
    return __hadd2_rn(a, __hneg2(b));
  }
  static __device__ __forceinline__ V mul(const V a, const V b) { return __hmul2_rn(a, b); }
};

// The scalars of the update, each in both halves (exact: they arrive
// rounded to S).
template <typename S> struct Scalars {
  using P = Packed<S>;
  typename P::V two, lam, dt, idx2, idy2, idz2;
  __device__ __forceinline__ Scalars(const float l, const float d, const float x2,
                                     const float y2, const float z2)
      : two(splat(2.0f)), lam(splat(l)), dt(splat(d)), idx2(splat(x2)), idy2(splat(y2)),
        idz2(splat(z2)) {}
  static __device__ __forceinline__ typename P::V splat(const float v) {
    return P::pack(st<S>(v), st<S>(v));
  }
};

// The update of two cells at once, in the plain version's order, each
// operation rounding to S.
template <typename S, typename V = typename Packed<S>::V>
__device__ __forceinline__ V update2(const V tc, const V xp, const V xm, const V yp, const V ym,
                                     const V zp, const V zm, const V ci, const Scalars<S>& c) {
  using P = Packed<S>;
  const V c2 = P::mul(c.two, tc);
  const V lap = P::add(P::add(P::mul(P::add(P::sub(xp, c2), xm), c.idx2),
                              P::mul(P::add(P::sub(yp, c2), ym), c.idy2)),
                       P::mul(P::add(P::sub(zp, c2), zm), c.idz2));
  return P::add(tc, P::mul(c.dt, P::mul(P::mul(c.lam, ci), lap)));
}

// Whether the 2-byte single step takes the pair layout: nz even and every
// field 4-byte aligned (kernels/diffusion3d.py::pairs_fit, by which the
// launch's grid is sized, is the same rule).
__host__ __device__ inline bool pairs_fit(const void* out, const void* T2, const void* T,
                                          const void* Ci, const int64_t nz) {
  const uintptr_t any = reinterpret_cast<uintptr_t>(out) | reinterpret_cast<uintptr_t>(T2) |
                        reinterpret_cast<uintptr_t>(T) | reinterpret_cast<uintptr_t>(Ci);
  return nz % 2 == 0 && any % 4 == 0;
}

// The 2-byte single step in the pair layout: thread (tz, ty) of a 32 x 8
// block owns word w (cells 2w, 2w + 1 of z) of row y and marches x. (ptxas
// gives the instance that copies T2's ring 60 registers, the in-place one
// 28; bounded to 40, the first spills and runs slower, PERF.md.)
template <bool kCopyRing, typename S>
__global__ void __launch_bounds__(kBlockZ * kBlockY) diffusion3d_pairs_kernel(
    S* __restrict__ out, const S* __restrict__ T2,
    const S* __restrict__ T, const S* __restrict__ Ci,
    const float lam, const float dt, const float idx2, const float idy2,
    const float idz2, const int64_t nx, const int64_t ny, const int64_t nz,
    const int64_t xc) {
  using P = Packed<S>;
  using V = typename P::V;
  const int64_t nw = nz / 2;  // words a row
  const int64_t w = static_cast<int64_t>(blockIdx.x) * kBlockZ + threadIdx.x;
  const int64_t y = static_cast<int64_t>(blockIdx.y) * kBlockY + threadIdx.y;
  if (w >= nw || y >= ny) return;
  V* const ow = reinterpret_cast<V*>(out);
  const V* const t2w = reinterpret_cast<const V*>(T2);
  const V* const tw = reinterpret_cast<const V*>(T);
  const V* const cw = reinterpret_cast<const V*>(Ci);
  const int64_t sy = nw;
  const int64_t sx = ny * nw;
  const int64_t x0 = static_cast<int64_t>(blockIdx.z) * xc;
  const int64_t x1 = x0 + xc < nx ? x0 + xc : nx;
  int64_t i = x0 * sx + y * sy + w;
  if (y == 0 || y == ny - 1) {
    if (kCopyRing) {
      for (int64_t x = x0; x < x1; ++x, i += sx) ow[i] = __ldg(t2w + i);
    }
    return;
  }
  // the words at a row's ends each hold a ring cell (z = 0, z = nz - 1),
  // whose neighbour beyond the row is taken from the word itself and whose
  // result is not stored: that word's other cell is stored alone
  const int64_t dm = w > 0 ? 1 : 0, dp = w < nw - 1 ? 1 : 0;
  const Scalars<S> c(lam, dt, idx2, idy2, idz2);
  V tm = x0 > 0 ? __ldg(tw + i - sx) : V{};
  V tc = __ldg(tw + i);
  for (int64_t x = x0; x < x1; ++x, i += sx) {
    if (x == 0 || x == nx - 1) {
      if (kCopyRing) ow[i] = __ldg(t2w + i);
      tm = tc;
      if (x + 1 < nx) tc = __ldg(tw + i + sx);
      continue;
    }
    const V tp = __ldg(tw + i + sx);
    const V prev = __ldg(tw + i - dm), next = __ldg(tw + i + dp);
    const V r = update2<S>(tc, tp, tm, __ldg(tw + i + sy), __ldg(tw + i - sy),
                           P::pack(P::hi(tc), P::lo(next)), P::pack(P::hi(prev), P::lo(tc)),
                           __ldg(cw + i), c);
    if (dm && dp) {
      ow[i] = r;
    } else if (dp) {  // z = 0 on the ring, z = 1 updated
      out[2 * i + 1] = P::hi(r);
      if (kCopyRing) out[2 * i] = __ldg(T2 + 2 * i);
    } else {          // z = nz - 2 updated, z = nz - 1 on the ring
      out[2 * i] = P::lo(r);
      if (kCopyRing) out[2 * i + 1] = __ldg(T2 + 2 * i + 1);
    }
    tm = tc;
    tc = tp;
  }
}

// The k-step kernel's layout: a tile of 32 cells along z and 16 to 32 rows
// along y (tile_rows), 256 threads, two planes a step (from the layout the
// generated k-step kernel of the same update was fastest in on the H100,
// kernels/codegen_steps.py::parallel_shape).
constexpr int kTile = 32;            // cells of the tile along z
constexpr int kStepThreads = 256;    // 8 warps
constexpr int kP = 2;                // planes per step
constexpr int kSlots = 4;            // a sweep's queue: the kP + 2 planes the next one reads
constexpr int kRing = kSlots + kP;   // T's ring: a step's kP + 2 planes and the next step's kP
constexpr int kMaxSteps = 4;         // the largest k the card checks

// The tile's rows along y (tuned, PERF.md): fewer at larger k, where the
// rings over the wider halo cone would leave room for one block only, or
// where 2-byte sweeps would spill at 128 registers.
__host__ __device__ constexpr int tile_rows(int k, int bytes) {
  return bytes == 4 ? (k == 2 ? 32 : k == 3 ? 24 : 16) : (k == 4 ? 24 : 32);
}

// A region of halo h over a tile of ty rows: its width along z, its cells,
// the rounds of the block's threads that cover it.
__host__ __device__ constexpr int side(int h) { return kTile + 2 * h; }
__host__ __device__ constexpr int area(int ty, int h) { return side(h) * (ty + 2 * h); }
__host__ __device__ constexpr int rounds(int ty, int h) {
  return (area(ty, h) + kStepThreads - 1) / kStepThreads;
}
// Ci's ring: the K + 1 planes a step's sweeps read and the next step's kP.
__host__ __device__ constexpr int ci_slots(int k) { return k + 1 + kP; }

// Whether Ci goes through its own staged ring (one read of each cell) or is
// read by each sweep from device memory (tuned on the H100, PERF.md:
// tune_stencil --hand times both where two blocks fit).
__host__ __device__ constexpr bool stage_ci(int k, int bytes) {
  return k > 0 && bytes > 0;
}

// Shared memory of the k-step kernel over a tile of ty rows, in cells of
// S: T's ring over halo k, Ci's ring over halo k - 1 where it is staged,
// and the queue of each sweep but the last, sweep k - 1 - h over halo h.
__host__ __device__ constexpr int shared_cells(int k, int ty, bool ci) {
  int n = kRing * area(ty, k) + (ci ? ci_slots(k) * area(ty, k - 1) : 0);
  for (int h = 1; h < k; ++h) n += kSlots * area(ty, h);
  return n;
}

// Where sweep k - 1 - h's queue begins among the queues.
__host__ __device__ constexpr int queue_offset(int k, int ty, int h) {
  int o = 0;
  for (int g = k - 1; g > h; --g) o += kSlots * area(ty, g);
  return o;
}

template <typename S>
__host__ __device__ constexpr int steps_bytes(int k) {
  constexpr int b = static_cast<int>(sizeof(S));
  return b * shared_cells(k, tile_rows(k, b), stage_ci(k, b));
}

// Resident blocks an SM: what shared memory leaves room for, at most
// kMaxResident (2: 128 registers a thread; tuned, PERF.md).
constexpr int kMaxResident = 2;
template <typename S>
__host__ __device__ constexpr int resident(int k) {
  return 232448 / steps_bytes<S>(k) < kMaxResident ? 232448 / steps_bytes<S>(k) : kMaxResident;
}

// Plane x's slot in a ring of n.
__device__ __forceinline__ int slot(int x, int n) { return (x + (n << 20)) % n; }

// copies: begin
// f32 staging: a 4-byte cp.async that reads nothing and zero-fills where
// not `valid`; commit_copies closes the thread's group, wait_copies waits
// until every copy of the thread has landed
__device__ __forceinline__ void copy_async(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 4 : 0) : "memory");
}
__device__ __forceinline__ void commit_copies() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// copies: end

// pinned: begin
// a field's base held in a register pair, so that a row of its taps is one
// wide multiply-add from it
template <class T> __device__ __forceinline__ const T* pinned(const T* p) {
  asm volatile("" : "+l"(p));
  return p;
}
// pinned: end

// What a block of the k-step kernel needs at every phase.
template <int K, typename S>
struct Block {
  static constexpr int kRows = tile_rows(K, sizeof(S));
  S* ring;     // T: kRing planes over halo K
  S* cring;    // Ci: ci_slots(K) planes over halo K - 1 (where staged)
  S* queues;   // sweep q < K - 1: kSlots planes over halo K - 1 - q
  const S* Ci;
  int tid, x0, x1, y0, z0, NX, NY, NZ;
  int64_t sx, sy;
};

// One field's planes x, x + 1 over the tile and h cells of halo into the
// ring `dst` of n slots: at f32 by cp.async (`held` unused), at 2 bytes
// into `held` now and into the ring at land() (zero outside the field).
template <int K, int H, typename S>
struct Stage {
  static constexpr int kRows = Block<K, S>::kRows;
  static constexpr int kRounds = rounds(kRows, H);
  typename Packed<S>::V held[sizeof(S) == 4 ? 1 : kRounds];

  __device__ __forceinline__ void issue(const Block<K, S>& b, const S* f, S* dst, const int n,
                                        const int x) {
    using P = Packed<S>;
    const bool in0 = x >= 0 && x < b.NX, in1 = x + 1 >= 0 && x + 1 < b.NX;
    const S* const f0 = f + (in0 ? x : 0) * b.sx;
    const S* const f1 = f + (in1 ? x + 1 : 0) * b.sx;
    S* const d0 = dst + slot(x, n) * area(kRows, H);
    S* const d1 = dst + slot(x + 1, n) * area(kRows, H);
    #pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      const int e = b.tid + r * kStepThreads;
      if (r == kRounds - 1 && e >= area(kRows, H)) break;
      const int ly = e / side(H), lz = e - ly * side(H);
      const int y = b.y0 - H + ly, z = b.z0 - H + lz;
      const bool yz = y >= 0 && y < b.NY && z >= 0 && z < b.NZ;
      const int64_t o = yz ? y * b.sy + z : 0;
      if constexpr (sizeof(S) == 4) {
        copy_async(d0 + e, f0 + o, in0 && yz);
        copy_async(d1 + e, f1 + o, in1 && yz);
      } else {
        held[r] = P::pack(in0 && yz ? __ldg(f0 + o) : S{}, in1 && yz ? __ldg(f1 + o) : S{});
      }
    }
    if constexpr (sizeof(S) == 4) commit_copies();
  }

  __device__ __forceinline__ void land(const Block<K, S>& b, S* dst, const int n, const int x) {
    using P = Packed<S>;
    if constexpr (sizeof(S) == 4) {
      wait_copies();
    } else {
      S* const d0 = dst + slot(x, n) * area(kRows, H);
      S* const d1 = dst + slot(x + 1, n) * area(kRows, H);
      #pragma unroll
      for (int r = 0; r < kRounds; ++r) {
        const int e = b.tid + r * kStepThreads;
        if (r == kRounds - 1 && e >= area(kRows, H)) break;
        d0[e] = P::lo(held[r]);
        d1[e] = P::hi(held[r]);
      }
    }
  }
};

// Ci at sweep halo H, plane x and x + 1 of a cell (ly, lz) of its region:
// from Ci's ring, or from device memory at clamped coordinates (the value
// is used only in the core).
template <int K, int H, typename S>
__device__ __forceinline__ typename Packed<S>::V ci_at(const Block<K, S>& b, const int x,
                                                        const int ly, const int lz) {
  using P = Packed<S>;
  if constexpr (stage_ci(K, sizeof(S))) {
    constexpr int d = K - 1 - H, a = area(Block<K, S>::kRows, K - 1);
    const int i = (ly + d) * side(K - 1) + lz + d;
    return P::pack(b.cring[slot(x, ci_slots(K)) * a + i],
                   b.cring[slot(x + 1, ci_slots(K)) * a + i]);
  } else {
    const int y = min(max(b.y0 - H + ly, 0), b.NY - 1);
    const int z = min(max(b.z0 - H + lz, 0), b.NZ - 1);
    const int xa = min(max(x, 0), b.NX - 2);
    const S* const c = pinned(b.Ci) + xa * b.sx + y * b.sy + z;
    return P::pack(__ldg(c), __ldg(c + b.sx));
  }
}

// The update at planes x, x + 1 of region cell e, from the input queue
// `in` (halo H + 1, n slots); ly, lz: the cell's row and column.
template <int K, int H, typename S>
__device__ __forceinline__ typename Packed<S>::V sweep_cell(const Block<K, S>& b, const S* in,
                                                            const int n, const int x,
                                                            const int e, const int ly,
                                                            const int lz,
                                                            const Scalars<S>& c) {
  using P = Packed<S>;
  constexpr int w = side(H + 1), a = area(Block<K, S>::kRows, H + 1);
  const int i = e + 2 * ly + w + 1;
  const S* const qm = in + slot(x - 1, n) * a + i;
  const S* const q0 = in + slot(x, n) * a + i;
  const S* const q1 = in + slot(x + 1, n) * a + i;
  const S* const qp = in + slot(x + 2, n) * a + i;
  const S t0 = q0[0], t1 = q1[0];
  const typename P::V tc = P::pack(t0, t1);
  const typename P::V r =
      update2<S>(tc, P::pack(t1, qp[0]), P::pack(qm[0], t0), P::pack(q0[w], q1[w]),
                 P::pack(q0[-w], q1[-w]), P::pack(q0[1], q1[1]), P::pack(q0[-1], q1[-1]),
                 ci_at<K, H>(b, x, ly, lz), c);
  const int y = b.y0 - H + ly, z = b.z0 - H + lz;
  const bool yz = y >= 1 && y < b.NY - 1 && z >= 1 && z < b.NZ - 1;
  // a cell off the core keeps its input (the reference's ring rule)
  return P::pack(yz && x >= 1 && x < b.NX - 1 ? P::lo(r) : t0,
                 yz && x + 1 >= 1 && x + 1 < b.NX - 1 ? P::hi(r) : t1);
}

// Sweep K - 1 - H at planes x, x + 1 over the tile and H cells of halo,
// from `in` (n slots) into its queue `out` (kSlots slots): every round's
// cells into registers before any is stored, so the loads of all rounds
// may be in flight together (a store to shared memory between them would
// hold back the next round's loads: 0.5-3% slower, PERF.md).
template <int K, int H, typename S>
__device__ __forceinline__ void sweep(const Block<K, S>& b, const S* in, const int n, S* out,
                                      const int x, const Scalars<S>& c) {
  using P = Packed<S>;
  constexpr int n_out = area(Block<K, S>::kRows, H), m = rounds(Block<K, S>::kRows, H);
  typename P::V v[m];
  #pragma unroll
  for (int r = 0; r < m; ++r) {
    const int e = min(b.tid + r * kStepThreads, n_out - 1);
    const int ly = e / side(H), lz = e - ly * side(H);
    v[r] = sweep_cell<K, H>(b, in, n, x, e, ly, lz, c);
  }
  S* const o0 = out + slot(x, kSlots) * n_out;
  S* const o1 = out + slot(x + 1, kSlots) * n_out;
  #pragma unroll
  for (int r = 0; r < m; ++r) {
    const int e = b.tid + r * kStepThreads;
    if (r < m - 1 || e < n_out) {
      o0[e] = P::lo(v[r]);
      o1[e] = P::hi(v[r]);
    }
  }
}

// The sweeps of one step at halo H down to 1, each behind a barrier, then
// the last sweep at planes xs, xs + 1 into `out` (T2's values on the ring
// where `out` is another buffer).
template <int K, int H, typename S>
__device__ __forceinline__ void sweeps(const Block<K, S>& b, const S* in, const int n,
                                       const int xs, const Scalars<S>& c, S* __restrict__ out,
                                       const S* __restrict__ T2) {
  using P = Packed<S>;
  if constexpr (H > 0) {
    S* const q = b.queues + queue_offset(K, Block<K, S>::kRows, H);
    sweep<K, H>(b, in, n, q, xs + H, c);
    __syncthreads();
    sweeps<K, H - 1>(b, q, kSlots, xs, c, out, T2);
  } else {
    constexpr int m = rounds(Block<K, S>::kRows, 0);
    typename P::V v[m];
    #pragma unroll
    for (int r = 0; r < m; ++r) {
      const int e = b.tid + r * kStepThreads;
      v[r] = sweep_cell<K, 0>(b, in, n, xs, e, e / kTile, e % kTile, c);
    }
    #pragma unroll
    for (int r = 0; r < m; ++r) {
      const int e = b.tid + r * kStepThreads;
      const int y = b.y0 + e / kTile, z = b.z0 + e % kTile;
      const bool core = y >= 1 && y < b.NY - 1 && z >= 1 && z < b.NZ - 1;
      #pragma unroll
      for (int p = 0; p < kP; ++p) {
        const int x = xs + p;
        if (x >= b.x0 && x < b.x1 && y < b.NY && z < b.NZ) {
          const int64_t g = x * b.sx + y * b.sy + z;
          if (core && x >= 1 && x < b.NX - 1) {
            out[g] = p == 0 ? P::lo(v[r]) : P::hi(v[r]);
          } else if (T2 != out) {
            out[g] = __ldg(T2 + g);
          }
        }
      }
    }
  }
}

template <int K, typename S>
__global__ void __launch_bounds__(kStepThreads, resident<S>(K)) diffusion3d_steps_kernel(
    S* __restrict__ out, const S* __restrict__ T2,
    const S* __restrict__ T, const S* __restrict__ Ci,
    const float lam, const float dt, const float idx2, const float idy2,
    const float idz2, const int64_t nx, const int64_t ny, const int64_t nz,
    const int64_t xc) {
  constexpr bool kCi = stage_ci(K, sizeof(S));
  extern __shared__ float smem[];
  Block<K, S> b;
  constexpr int ty = Block<K, S>::kRows;
  b.ring = reinterpret_cast<S*>(smem);
  b.cring = b.ring + kRing * area(ty, K);
  b.queues = b.cring + (kCi ? ci_slots(K) * area(ty, K - 1) : 0);
  b.Ci = Ci;
  b.tid = threadIdx.x;
  b.z0 = blockIdx.x * kTile;
  b.y0 = blockIdx.y * ty;
  b.x0 = blockIdx.z * static_cast<int>(xc);
  b.x1 = min(b.x0 + static_cast<int>(xc), static_cast<int>(nx));
  b.NX = static_cast<int>(nx);
  b.NY = static_cast<int>(ny);
  b.NZ = static_cast<int>(nz);
  b.sy = nz;
  b.sx = ny * nz;
  const Scalars<S> c(lam, dt, idx2, idy2, idz2);
  // T's planes xs + K, xs + K + 1 and Ci's xs + K - 1, xs + K of the step at
  // xs, staged a step ahead: the march starts 2K planes before the chunk,
  // where the last sweep's first plane needs T's plane x0 - K
  Stage<K, K, S> st;
  Stage<K, K - 1, S> sc;
  const int xs0 = b.x0 - 2 * K;
  st.issue(b, T, b.ring, kRing, xs0 + K);
  if constexpr (kCi) sc.issue(b, Ci, b.cring, ci_slots(K), xs0 + K - 1);
  #pragma unroll 1
  for (int xs = xs0; xs < b.x1; xs += kP) {
    st.land(b, b.ring, kRing, xs + K);
    if constexpr (kCi) sc.land(b, b.cring, ci_slots(K), xs + K - 1);
    __syncthreads();
    if (xs + kP < b.x1) {  // the next step's planes, in flight while this one sweeps
      st.issue(b, T, b.ring, kRing, xs + kP + K);
      if constexpr (kCi) sc.issue(b, Ci, b.cring, ci_slots(K), xs + kP + K - 1);
    }
    sweeps<K, K - 1>(b, b.ring, kRing, xs, c, out, T2);
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
  constexpr int bytes = steps_bytes<S>(K);
  const cudaError_t set = cudaFuncSetAttribute(
      diffusion3d_steps_kernel<K, S>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (set != cudaSuccess) return static_cast<int>(set);
  const dim3 block(kStepThreads, 1, 1);
  const auto kernel = diffusion3d_steps_kernel<K, S>;
  kernel<<<grid, block, bytes, st>>>(
      out, T2, T, Ci, lam, dt, idx2, idy2, idz2, nx, ny, nz, xc);
  return static_cast<int>(cudaGetLastError());
}

template <typename S>
int launch_typed(void* out, const void* T2, const void* T, const void* Ci, float lam, float dt,
                 float idx2, float idy2, float idz2, int64_t nx, int64_t ny, int64_t nz,
                 int64_t xc, int64_t nsteps, const dim3 grid, const cudaStream_t st) {
  if (nsteps == 1) {
    const dim3 block(kBlockZ, kBlockY, 1);
    auto kernel = out == T2 ? diffusion3d_kernel<false, S> : diffusion3d_kernel<true, S>;
    if constexpr (sizeof(S) == 2) {
      if (pairs_fit(out, T2, T, Ci, nz)) {
        kernel = out == T2 ? diffusion3d_pairs_kernel<false, S>
                           : diffusion3d_pairs_kernel<true, S>;
      }
    }
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
// to it by the caller). The grid is the caller's: for a 2-byte single step
// sized by the pair layout's 64 x 8 cells a block where pairs_fit holds.
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

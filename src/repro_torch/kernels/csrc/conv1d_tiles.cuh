// The tile layout shared by conv1d.cu and conv1d_bwd.cu: a block of 32 x 4
// threads covers 32 x VEC channels (C, the contiguous axis) by `tile`
// positions, VEC 4 (one copy and one store of 4 channels: 16 bytes at f32,
// 8 at bf16; C a multiple of 4 and the tensors read and written along C
// 16-byte aligned) or 1, tile 16 or 32 (kernels/conv1d.py::layout chooses;
// the sources refuse any other). x is staged in shared memory at its
// storage type T (storage.cuh) and converted to f32 where it is read from
// there. (At bf16, 8 channels a thread in 16-byte copies took 0.063 ms at
// Zamba2's shape, 4 in 8-byte ones 0.037, on two runs of the H100: half the
// blocks, each thread twice the work; PERF.md §6.) kernels/build.py::read_source inlines this file where a source
// includes it, after tf32x3.cuh and storage.cuh, whose cp.async copies and
// conversions it uses.
#ifndef REPRO_TORCH_CONV1D_TILES_CUH
#define REPRO_TORCH_CONV1D_TILES_CUH
#include <cstdint>
#include <cuda_runtime.h>

namespace conv1d_tiles {

constexpr int kLanes = 32;            // threads of a block along C
constexpr int kRows = 4;              // threads of a block along t
constexpr int kThreads = kLanes * kRows;
constexpr int kMaxK = 8;              // one instance per K up to this
using storage::kTwoByte;
using storage::T;
using storage::narrow;
using storage::widen;

// whether the sources take a launch's (vec, tile) for C channels, `aligned`
// saying whether every tensor read or written along C is 16-byte aligned
inline bool takes(int64_t C, int64_t vec, int64_t tile, bool aligned) {
  return (vec == 1 || (vec == 4 && C % 4 == 0 && aligned)) && (tile == 16 || tile == 32);
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// VEC adjacent values at p (aligned to VEC values) as f32: storage values
// converted, f32 ones (the backward's gp and partials) as they are
template <int VEC, class S>
__device__ __forceinline__ void load_vec(float (&v)[VEC], const S* p) {
  if constexpr (VEC == 4) {
    const float4 q = storage::load4(p);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
    v[0] = widen(*p);
  }
}

// VEC f32 values to p, rounded once to the type of p
template <int VEC, class S>
__device__ __forceinline__ void store_vec(S* p, const float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    storage::store4(p, make_float4(v[0], v[1], v[2], v[3]));
  } else {
    *p = narrow<S>(v[0]);
  }
}

// rows x (32 x VEC) channels of src (one batch row's (L, C) slab) from
// position t_first on into dst, by cp.async, every copy issued before any is
// waited for (16, 8 or 4 bytes a copy; a 2-byte value, which cp.async cannot
// copy, is loaded and stored at once); zero where the position lies outside
// [0, L) or the channel at or past C. The caller commits and waits.
template <int VEC>
__device__ __forceinline__ void stage(T* dst, const T* src, int64_t t_first, int rows,
                                      int64_t L, int64_t C, int64_t c0) {
  const int tid = threadIdx.y * kLanes + threadIdx.x;
  for (int i = tid; i < rows * kLanes; i += kThreads) {
    const int row = i / kLanes, lane = i % kLanes;
    const int64_t t = t_first + row, c = c0 + lane * VEC;
    const bool ok = t >= 0 && t < L && c < C;
    T* d = dst + row * (kLanes * VEC) + lane * VEC;
    const T* s = ok ? src + t * C + c : src;
    if constexpr (VEC * sizeof(T) == 16) {
      tf32x3::cp_async16(d, s, ok);
    } else if constexpr (VEC * sizeof(T) == 8) {
      tf32x3::cp_async8(d, s, ok);
    } else if constexpr (sizeof(T) == 4) {
      tf32x3::cp_async4(d, s, ok);
    } else {
      *d = ok ? *s : narrow<T>(0.0f);
    }
  }
}

}  // namespace conv1d_tiles

#endif  // REPRO_TORCH_CONV1D_TILES_CUH

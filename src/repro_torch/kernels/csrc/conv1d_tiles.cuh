// The tile layout shared by conv1d.cu and conv1d_bwd.cu: a block of 32 x 4
// threads covers 32 x VEC channels (C, the contiguous axis) by `tile`
// positions, VEC 4 (16-byte copies and stores; C a multiple of 4 and the
// tensors read and written along C 16-byte aligned) or 1, tile 16 or 32
// (kernels/conv1d.py::layout chooses; the sources refuse any other).
// kernels/build.py::read_source inlines this file where a source includes
// it, after tf32x3.cuh, whose cp.async helpers it uses.
#ifndef REPRO_TORCH_CONV1D_TILES_CUH
#define REPRO_TORCH_CONV1D_TILES_CUH
#include <cstdint>
#include <cuda_runtime.h>

namespace conv1d_tiles {

constexpr int kLanes = 32;            // threads of a block along C
constexpr int kRows = 4;              // threads of a block along t
constexpr int kThreads = kLanes * kRows;
constexpr int kMaxK = 8;              // one instance per K up to this

// whether the sources take a launch's (vec, tile) for C channels, `aligned`
// saying whether every tensor read or written along C is 16-byte aligned
inline bool takes(int64_t C, int64_t vec, int64_t tile, bool aligned) {
  return (vec == 1 || (vec == 4 && C % 4 == 0 && aligned)) && (tile == 16 || tile == 32);
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <int VEC>
__device__ __forceinline__ void load_vec(float (&v)[VEC], const float* p) {
  if constexpr (VEC == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
    v[0] = *p;
  }
}

template <int VEC>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *p = v[0];
  }
}

// rows x (32 x VEC) channels of src (one batch row's (L, C) slab) from
// position t_first on into dst, by cp.async, every copy issued before any is
// waited for; zero where the position lies outside [0, L) or the channel at
// or past C. The caller commits and waits.
template <int VEC>
__device__ __forceinline__ void stage(float* dst, const float* src, int64_t t_first, int rows,
                                      int64_t L, int64_t C, int64_t c0) {
  const int tid = threadIdx.y * kLanes + threadIdx.x;
  for (int i = tid; i < rows * kLanes; i += kThreads) {
    const int row = i / kLanes, lane = i % kLanes;
    const int64_t t = t_first + row, c = c0 + lane * VEC;
    const bool ok = t >= 0 && t < L && c < C;
    float* d = dst + row * (kLanes * VEC) + lane * VEC;
    const float* s = ok ? src + t * C + c : src;
    if constexpr (VEC == 4) {
      tf32x3::cp_async16(d, s, ok);
    } else {
      tf32x3::cp_async4(d, s, ok);
    }
  }
}

}  // namespace conv1d_tiles

#endif  // REPRO_TORCH_CONV1D_TILES_CUH

// The storage type of the LM sources (attention, SSD, conv1d, forward and
// backward): the tensors that the reference's Pallas kernels keep at the
// parameter dtype (src/repro/kernels/attention.py:106, ssd.py:121,
// conv1d.py:73-74) are `storage::T`, float, or __nv_bfloat16 where the
// source is built with REPRO_TORCH_BF16 defined (kernels/build.py::instance
// builds that instance as a library of its own). Everything else (dt, A, D,
// the states, lse, the scratch) stays float.
//
// A bf16 value is converted to f32 on load (__bfloat162float, exact), every
// operation runs in f32 exactly as in the float instance, and each output
// is rounded once on store (__float2bfloat16_rn). So the bf16 instance
// computes the float instance on the upcast inputs, rounded: bit for bit.
//
// kernels/build.py::read_source inlines this file where a source includes
// it, after tf32x3.cuh, whose cp.async copies it uses.
#ifndef REPRO_TORCH_STORAGE_CUH
#define REPRO_TORCH_STORAGE_CUH
#include <cstdint>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace storage {

#ifdef REPRO_TORCH_BF16
using T = __nv_bfloat16;
#else
using T = float;
#endif
constexpr bool kTwoByte = sizeof(T) == 2;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

template <class S>
__device__ __forceinline__ S narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// four adjacent bf16 values: one 8-byte access
struct __align__(8) bf16x4 { __nv_bfloat16 v[4]; };

// Four adjacent values from p (16-byte aligned for float, 8 for bf16) as f32.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const bf16x4 w = *reinterpret_cast<const bf16x4*>(p);
  return make_float4(widen(w.v[0]), widen(w.v[1]), widen(w.v[2]), widen(w.v[3]));
}

// Four f32 values to p, rounded to the storage type.
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  bf16x4 w;
  w.v[0] = narrow<__nv_bfloat16>(v.x);
  w.v[1] = narrow<__nv_bfloat16>(v.y);
  w.v[2] = narrow<__nv_bfloat16>(v.z);
  w.v[3] = narrow<__nv_bfloat16>(v.w);
  *reinterpret_cast<bf16x4*>(p) = w;
}

// Four values from global memory into f32 shared memory, zero where
// !valid: a float source by one 16-byte cp.async (the caller commits and
// waits), a bf16 one by an 8-byte load, converted and stored at once.
__device__ __forceinline__ void copy4(float* s, const float* g, bool valid) {
  tf32x3::cp_async16(s, g, valid);
}
__device__ __forceinline__ void copy4(float* s, const __nv_bfloat16* g, bool valid) {
  *reinterpret_cast<float4*>(s) = valid ? load4(g) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// One value, likewise (a 4-byte cp.async for float).
__device__ __forceinline__ void copy1(float* s, const float* g, bool valid) {
  tf32x3::cp_async4(s, g, valid);
}
__device__ __forceinline__ void copy1(float* s, const __nv_bfloat16* g, bool valid) {
  *s = valid ? widen(*g) : 0.0f;
}

}  // namespace storage

#endif  // REPRO_TORCH_STORAGE_CUH

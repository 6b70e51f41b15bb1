// f32-accurate products on Hopper's TF32 tensor cores (3xTF32), and the
// cp.async copies that feed them: the helpers shared by attention.cu and
// ssd.cu (and their backward sources; the conv1d sources use the copies).
// kernels/build.py::read_source inlines this file where a source includes
// it, so a change here rebuilds each of them.
//
// A TF32 operand keeps 10 mantissa bits, so one TF32 product is off by
// about 5e-4 relative. Each f32 operand x is split into hi = rna_tf32(x)
// and lo = rna_tf32(x - hi), and every product a·b is summed as
// a_lo·b_hi + a_hi·b_lo + a_hi·b_hi into f32 accumulators (the dropped
// a_lo·b_lo and the rounding of lo are about 2^-21 relative): three TF32
// products per f32 product, 495 / 3 = 165 TFLOP/s f32-accurate on the
// H100, against 67 TFLOP/s on the CUDA cores.
//
// The tensor cores do not round their f32 accumulation to nearest (NVIDIA's
// earlier tensor cores were measured to truncate), so a long chain of
// mma.sync into one accumulator drifts by up to an ulp of the accumulator
// per instruction. A sum over many tiles is therefore taken per tile in a
// fresh accumulator and added on the CUDA cores (round to nearest).
#ifndef REPRO_TORCH_TF32X3_CUH
#define REPRO_TORCH_TF32X3_CUH
#include <cstdint>
#include <cuda_runtime.h>

namespace tf32x3 {

// x rounded to TF32 (10 mantissa bits), to nearest, ties away from zero:
// cvt.rna.tf32.f32's result for every finite x, on the integer ALU (cvt
// runs on the conversion pipe, at a fraction of the ALU's rate)
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo, each a TF32 value in a 32-bit register
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void split4(const float (&a)[4], uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) split(a[r], hi[r], lo[r]);
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a·b at f32 accuracy: the two cross terms first, then hi·hi
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], float b0, float b1) {
  uint32_t b0h, b0l, b1h, b1l;
  split(b0, b0h, b0l);
  split(b1, b1h, b1l);
  mma_tf32(d, al, b0h, b1h);
  mma_tf32(d, ah, b0l, b1l);
  mma_tf32(d, ah, b0h, b1h);
}

// 16 (or 8, or 4) bytes from global to shared memory, zero-filled where !valid
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async8(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 8 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

}  // namespace tf32x3

#endif  // REPRO_TORCH_TF32X3_CUH

// Hand-written CUDA kernel for the paper's Fig. 1 explicit diffusion step:
//
//   out[inn] = T + dt * ((lam * Ci) * lap(T)),
//   lap(T)   = ((T[x+1] - 2 T[x]) + T[x-1]) * idx2
//            + ((T[y+1] - 2 T[y]) + T[y-1]) * idy2
//            + ((T[z+1] - 2 T[z]) + T[z-1]) * idz2,
//   out      = T2 on the boundary ring.
//
// Replaces the Pallas TPU kernel src/repro/kernels/diffusion3d.py::
// diffusion3d_step (pl.pallas_call at :75, body _body at :30), single-step
// case (nsteps = 1).
//
// What bounds it on the H100: bytes. A step must read T and Ci and write the
// output once, 12 bytes per cell, against about 16 f32 operations per cell,
// far below the card's ratio of f32 operations to memory bytes (about 20), so
// the kernel cannot beat 12 bytes per cell over the memory rate.
//
// What the design does about it (the paper's `loopopt`): each thread owns
// one (y, z) column segment and marches along x, keeping T[x-1], T[x] and
// T[x+1] in registers, so the x neighbours cost no second load.
// threadIdx.x runs along z, the contiguous axis of the C-order layout, so a
// warp's loads of a plane coalesce into whole 128-byte lines; the y and z
// neighbours are loaded again by neighbouring threads and come from L1/L2,
// not from device memory. The x axis is cut into chunks (xc planes each) so
// that a 512^3 grid gives several waves of blocks over the card's SMs.
//
// The order of operations is the plain version's (kernels/ref.py), and the
// build passes --fmad=false, so the kernel and the plain version agree
// bitwise. The kernel writes a new output; it reads T2 only on the ring.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlockZ = 32;
constexpr int kBlockY = 8;

__global__ void __launch_bounds__(kBlockZ * kBlockY) diffusion3d_kernel(
    float* __restrict__ out, const float* __restrict__ T2,
    const float* __restrict__ T, const float* __restrict__ Ci,
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
    for (int64_t x = x0; x < x1; ++x, i += sx) out[i] = T2[i];
    return;
  }
  float tm = x0 > 0 ? T[i - sx] : 0.0f;
  float tc = T[i];
  for (int64_t x = x0; x < x1; ++x, i += sx) {
    if (x == 0 || x == nx - 1) {
      out[i] = T2[i];
      tm = tc;
      if (x + 1 < nx) tc = T[i + sx];
      continue;
    }
    const float tp = T[i + sx];
    const float lap = ((tp - 2.0f * tc) + tm) * idx2 +
                      ((T[i + sy] - 2.0f * tc) + T[i - sy]) * idy2 +
                      ((T[i + 1] - 2.0f * tc) + T[i - 1]) * idz2;
    out[i] = tc + dt * ((lam * Ci[i]) * lap);
    tm = tc;
    tc = tp;
  }
}

}  // namespace

extern "C" int launch(void* out, const void* T2, const void* T, const void* Ci,
                      float lam, float dt, float idx2, float idy2, float idz2,
                      int64_t nx, int64_t ny, int64_t nz, int64_t xc,
                      int64_t gz, int64_t gy, int64_t gx, void* stream) {
  const dim3 grid(static_cast<unsigned>(gz), static_cast<unsigned>(gy),
                  static_cast<unsigned>(gx));
  const dim3 block(kBlockZ, kBlockY, 1);
  diffusion3d_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), static_cast<const float*>(T2),
      static_cast<const float*>(T), static_cast<const float*>(Ci), lam, dt,
      idx2, idy2, idz2, nx, ny, nz, xc);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

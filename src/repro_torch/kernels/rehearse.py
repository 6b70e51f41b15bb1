"""Run a generated ``@parallel`` kernel's CUDA C++ on the CPU.

The printed kernel is the part of the generated kernel that only a card can
check. This module compiles its source with the host's C++ compiler (``g++
-ffp-contract=off``, so every multiply and add rounds on its own,
as ``nvcc --fmad=false`` builds it) behind a few definitions that stand in
for CUDA's: the grid's blocks run one after another, each CUDA thread of a
block is a fiber (``ucontext``) on one OS thread, ``__syncthreads`` suspends
it until all of the block's threads have arrived, and ``__shfl_xor_sync``
exchanges through such a barrier of the warp's threads. So the staging, the
barriers, the march and the reduction fold run as the card runs them, phase
by phase, on one core; a fault in the printed indexing shows here as a value
that differs from the ``torch`` backend, and a barrier that not every thread
reaches stops the run.

One thing is patched: the kernel divides a tensor by a host scalar as
PyTorch's CUDA kernels do, by a product with the scalar's reciprocal, while
PyTorch on the CPU divides; the rehearsal prints a true division there (by
the same argument, which the rehearsal passes the divisor itself in), so
that the ``torch`` backend on CPU tensors is the bitwise reference.

    from repro_torch.kernels import rehearse
    outs, reds = rehearse.run(kernel.compiled(**fields, **scalars), fields, scalars)
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from typing import Any, Mapping

import torch

from . import build, codegen, codegen_steps, stencil

_SHIM = r'''
#include <cstdint>
#include <cmath>
#include <math.h>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <algorithm>
#include <functional>
#include <vector>
#include <ucontext.h>
struct U3 { unsigned x, y, z; };
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
static U3 threadIdx, blockIdx;
static dim3 gridDim, blockDim;
#define __global__
#define __host__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static
typedef void* cudaStream_t;
using std::min;
using std::max;
// Each CUDA thread of a block is a fiber on one OS thread; a barrier
// suspends it until every thread it waits for has arrived.
struct Barrier { int need = 0, arrived = 0, gen = 0; };
struct Fiber {
  ucontext_t ctx;
  std::vector<char> stack;
  U3 idx;
  Barrier* wait = nullptr;
  int wait_gen = 0;
  bool done = false;
};
static ucontext_t g_main;
static std::vector<Fiber>* g_fibers;
static int g_cur;
static std::function<void()>* g_body;
static Barrier g_block;
// Called before each block: fills a k-step kernel's dynamic shared memory
// with NaN, as a card may leave it holding anything.
static void (*g_block_start)() = nullptr;
static Barrier g_warp[64];
static float g_lanes[2048];
static void arrive(Barrier& b) {
  Fiber& f = (*g_fibers)[g_cur];
  const int gen = b.gen;
  if (++b.arrived == b.need) { b.arrived = 0; ++b.gen; return; }
  f.wait = &b;
  f.wait_gen = gen;
  swapcontext(&f.ctx, &g_main);
}
inline void __syncthreads() { arrive(g_block); }
inline float __shfl_xor_sync(unsigned, float v, int o) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  g_lanes[tid] = v;
  arrive(g_warp[tid >> 5]);
  const float r = g_lanes[tid ^ o];
  arrive(g_warp[tid >> 5]);
  return r;
}
inline float __int_as_float(int i) { float f; std::memcpy(&f, &i, 4); return f; }
static void fiber_main() {
  (*g_body)();
  (*g_fibers)[g_cur].done = true;
  swapcontext(&(*g_fibers)[g_cur].ctx, &g_main);
}
static void run_grid(dim3 grid, dim3 block, std::function<void()> body) {
  gridDim = grid;
  blockDim = block;
  g_body = &body;
  const int n = block.x * block.y;
  std::vector<Fiber> fibers(n);
  g_fibers = &fibers;
  for (auto& f : fibers) f.stack.resize(1 << 18);
  for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; ++bx) {
        blockIdx = {bx, by, bz};
        if (g_block_start) g_block_start();
        g_block = Barrier{n};
        for (int w = 0; w < n / 32; ++w) g_warp[w] = Barrier{32};
        for (int t = 0; t < n; ++t) {
          Fiber& f = fibers[t];
          f.idx = {unsigned(t) % block.x, unsigned(t) / block.x, 0};
          f.wait = nullptr;
          f.done = false;
          getcontext(&f.ctx);
          f.ctx.uc_stack.ss_sp = f.stack.data();
          f.ctx.uc_stack.ss_size = f.stack.size();
          f.ctx.uc_link = nullptr;
          makecontext(&f.ctx, fiber_main, 0);
        }
        for (int left = n; left > 0;) {
          bool ran = false;
          for (g_cur = 0; g_cur < n; ++g_cur) {
            Fiber& f = fibers[g_cur];
            if (f.done || (f.wait && f.wait->gen == f.wait_gen)) continue;
            f.wait = nullptr;
            threadIdx = f.idx;
            ran = true;
            swapcontext(&g_main, &f.ctx);
            left -= f.done;
          }
          if (!ran) {
            std::fprintf(stderr, "rehearsal: threads of block (%u, %u, %u) wait at a barrier "
                         "that the others never reach\n", bx, by, bz);
            std::abort();
          }
        }
      }
}
'''
_LAUNCH = re.compile(r"(stencil_kernel|diffusion3d_steps_kernel<K>|kernel)"
                     r"<<<grid, block, [A-Za-z0-9]+, "
                     r"(?:st|static_cast<cudaStream_t>\(stream\))>>>\(")
_LAUNCHED = re.compile(r"(run_grid\(grid, block, \[&\] \{ [A-Za-z0-9_<>]+\(\n[^;]*\));")
_SET_SHARED = re.compile(r"  const cudaError_t set = cudaFuncSetAttribute\([^;]*;\n"
                         r"  if \(set != cudaSuccess\) [^\n]*\n")


def _host_text(text: str, shared_floats: int = 0) -> str:
    """CUDA source as C++ for the host behind :data:`_SHIM`: each launch a
    loop over the grid's blocks and threads; dynamic shared memory (of
    ``shared_floats``) a static array filled with NaN before each block, as
    a card may leave it holding anything."""
    if "extern __shared__ float smem[];" in text:
        shared_floats = max(shared_floats, 1)     # a launch may need none
        text = text.replace("extern __shared__ float smem[];", "float* const smem = g_smem;")
        text = text.replace("namespace {\n", "namespace {\n"
                            f"float g_smem[{shared_floats}];\n"
                            "void nan_smem() { std::fill(g_smem, g_smem + "
                            f"{shared_floats}, NAN); }}\n"
                            "const int g_smem_hook = (g_block_start = nan_smem, 0);\n", 1)
    text = text.replace("#include <cuda_runtime.h>\n", "")
    text = _SET_SHARED.sub("", text)
    text = _LAUNCH.sub(r"run_grid(grid, block, [&] { \1(", text)
    text = _LAUNCHED.sub(r"\1; });", text)
    text = text.replace("return static_cast<int>(cudaGetLastError());", "return 0;")
    text = text.replace("static_cast<int>(cudaErrorInvalidValue)", "1")
    return _SHIM + text[:text.index('extern "C" const char* error_string')]


def _cpu_division(kind, args, raw):
    if kind == "div" and raw[1][0] in ("param", "const") and raw[0][0] not in ("param", "const"):
        by = f"r{raw[1][1]}" if raw[1][0] == "param" else codegen.float_literal(raw[1][1])
        return f"({args[0]} / {by})"
    return _c_expr(kind, args, raw)


_c_expr = codegen._c_expr


def source(call: stencil.StencilCall) -> str:
    """The call's kernel as C++ for the host: CUDA's names defined, the
    launch a loop over blocks and threads, scalar divisions true, a k-step
    kernel's dynamic shared memory a static array."""
    codegen._c_expr = _cpu_division
    try:
        if call.rotations is None:
            return _host_text(codegen.cuda_source(call.program, call.shape))
        text = codegen_steps.cuda_source(call.program, call.rotations, call.nsteps, call.shape)
        return _host_text(text, codegen_steps.shared_bytes(call.program, call.plan,
                                                           call.shape) // 4)
    finally:
        codegen._c_expr = _c_expr


def compiler() -> str | None:
    """The host's C++ compiler, or None."""
    return shutil.which("g++")


def library(call: stencil.StencilCall) -> ctypes.CDLL:
    """Compile the call's rehearsal into ``build/repro_torch/rehearse/``
    (cached by a hash of its text)."""
    return _compile(source(call), call.lib_name)


def _compile(text: str, name: str) -> ctypes.CDLL:
    build_dir = build.BUILD_DIR / "rehearse"
    build_dir.mkdir(parents=True, exist_ok=True)
    lib = build_dir / f"{hashlib.sha256(text.encode()).hexdigest()[:16]}.so"
    if not lib.exists():
        cxx = compiler()
        if cxx is None:
            raise RuntimeError("the rehearsal needs a host C++ compiler (g++)")
        src = lib.with_suffix(f".{os.getpid()}.cpp")
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        src.write_text(text)
        done = subprocess.run([cxx, "-std=c++17", "-O1", "-ffp-contract=off", "-fPIC",
                               "-shared", "-w", "-o", str(tmp), str(src)],
                              capture_output=True, text=True)
        if done.returncode != 0:
            raise RuntimeError(f"g++ failed on the rehearsal of {name}:\n"
                               f"{done.stderr[:8000]}")
        os.replace(tmp, lib)
        src.unlink()
    return ctypes.CDLL(str(lib))


def run(call: stencil.StencilCall, fields: Mapping[str, torch.Tensor],
        scalars: Mapping[str, Any], n_sm: int = 132, xc: int | None = None):
    """``(outs, reds)`` of the printed kernel on CPU tensors, launched as
    ``StencilCall.run`` launches it on a card with ``n_sm`` SMs, or with
    chunks of ``xc`` planes."""
    ins = {f: fields[f].contiguous() for f in call.program.fields}
    _, outs, parts, args = call.arguments(ins, scalars, n_sm, xc, divisor=float)
    for part in parts:
        part.fill_(float("nan"))      # a block that writes no partial shows
    fn = library(call).launch
    fn.argtypes = call.argtypes()
    fn.restype = ctypes.c_int
    fn(*args, None)
    return call.finish(outs, parts)


def diffusion3d_step(T2, T, Ci, lam, dt, inv_dx, inv_dy, inv_dz, nsteps: int = 1,
                     n_sm: int = 132, xc: int | None = None) -> torch.Tensor:
    """The hand kernel ``csrc/diffusion3d.cu`` on CPU tensors, launched as
    ``diffusion3d.diffusion3d_step`` launches it on a card with ``n_sm`` SMs
    (or with chunks of ``xc`` planes), into a new tensor."""
    from . import diffusion3d

    text = _host_text(build.read_source(diffusion3d.SOURCE),
                      diffusion3d.shared_bytes(diffusion3d.MAX_STEPS) // 4)
    fn = _compile(text, "diffusion3d").launch
    fn.argtypes = diffusion3d._ARGTYPES
    fn.restype = ctypes.c_int
    launch = diffusion3d.column_launch(tuple(T.shape), n_sm, nsteps)
    if xc is not None:
        launch = stencil.Launch((*launch.grid[:2], -(-T.shape[0] // xc)), launch.block, xc)
    out = torch.empty_like(T)
    ins = [t.contiguous() for t in (T2, T, Ci)]
    err = fn(out.data_ptr(), *(t.data_ptr() for t in ins), float(lam), float(dt),
             float(inv_dx ** 2), float(inv_dy ** 2), float(inv_dz ** 2), *T.shape, launch.xc,
             int(nsteps), *launch.grid, None)
    if err:
        raise RuntimeError(f"the rehearsed diffusion3d launch refused nsteps={nsteps}")
    return out

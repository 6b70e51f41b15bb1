"""Run a generated ``@parallel`` kernel's CUDA C++ on the CPU.

The printed kernel is the part of the generated kernel that only a card can
check. This module compiles its source with the host's C++ compiler (``g++
-ffp-contract=off``, so every multiply and add rounds on its own,
as ``nvcc --fmad=false`` builds it) behind a few definitions that stand in
for CUDA's: the grid's blocks run one after another, each CUDA thread of a
block is a fiber (``ucontext``) on one OS thread, ``__syncthreads`` suspends
it until all of the block's threads have arrived, and ``__shfl_xor_sync``
exchanges through such a barrier of the warp's threads, and ``__ldg`` counts
each load that falls outside every input field. So the staging, the
barriers, the march and the reduction fold run as the card runs them, phase
by phase, on one core; a fault in the printed indexing shows here as a value
that differs from the ``torch`` backend, and a barrier that not every thread
reaches stops the run.

CUDA's bf16 and f16 types are their 16 bits here, and their conversions
(``__bfloat162float``, ``__float2bfloat16_rn``, ``__half2float``,
``__float2half_rn``) are written as integer arithmetic on those bits: round
to nearest even, NaN kept quiet, f16 subnormals, and f16 overflow to inf
from 65520 on. ``tests/test_torch_rehearse_mixed.py`` holds each bitwise
to PyTorch's conversions on every bf16 and f16 value, their midpoints and
random words (:func:`convert`), since a wrong one would make every
rehearsal of a bf16 or f16 kernel lie. The packed 2-byte arithmetic of the
hand kernel (``__hadd2_rn``, ``__hmul2_rn``, ``__hneg2``) computes each
half in f32 and rounds it, and its word moves (``__halves2bfloat162``,
``__low2bfloat16``, ``__high2bfloat16`` and the ``__half2`` ones) move bits;
the same tests hold them to PyTorch's operations (:func:`packed_op`,
:func:`word_moves`). An asynchronous copy from outside the input fields is
counted as a stray ``__ldg`` is.

One thing is patched: the kernel divides a tensor by a host scalar as
PyTorch's CUDA kernels do, by a product with the scalar's reciprocal, while
PyTorch on the CPU divides; the rehearsal prints a true division there (by
the same argument, which the rehearsal passes the divisor itself in), so
that the ``torch`` backend on CPU tensors is the bitwise reference.

    from repro_torch.kernels import rehearse
    outs, reds = rehearse.run(kernel.compiled(**fields, **scalars), fields, scalars)

The conv1d forward kernel (``csrc/conv1d.cu``) and the LM backward kernels
(``csrc/conv1d_bwd.cu``, ``csrc/ssd_bwd.cu``, ``csrc/attention_bwd.cu``)
are rehearsed the same way through :func:`conv1d`, :func:`conv1d_bwd`,
:func:`ssd_bwd` and :func:`attention_bwd`, which pass their wrappers' own
arguments (``fwd_arguments``, ``bwd_arguments``) to the source's entry
point; every output and scratch buffer is NaN before the launch, so an
element no thread writes shows. Their tensor-core code runs too: the
inlined ``csrc/tf32x3.cuh`` becomes a host twin whose ``mma_tf32`` is
``mma.sync.m16n8k8`` computed from the warp's fragments in PTX's layout
(:data:`_TF32X3_HOST`, :func:`mma_tf32_lanes`). bf16 inputs run each
source's bf16 instance (``build.instance``: ``csrc/storage.cuh`` with
``REPRO_TORCH_BF16``), whose ``cp.async`` copies move the 2-byte values as
bytes; :func:`compile_lm` builds several instances at once.
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
#include <utility>
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
#define __align__(n) __attribute__((aligned(n)))
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
  std::vector<std::function<void()>> copies;  // issued, not yet waited for
  // cp.async copies of the LM sources: (group, copy), performed at a wait
  std::vector<std::pair<int, std::function<void()>>> groups;
  int open = 0;                                // the group being issued
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
// The inputs' bytes, as run() registers them: a load through __ldg that
// lies outside all of them (on a card a fault, or a read of another
// allocation) reads nothing and is counted, and run() raises.
static std::vector<std::pair<const char*, const char*>> g_inputs;
static long g_stray = 0;
static bool inside_inputs(const void* p, size_t size) {
  const char* a = static_cast<const char*>(p);
  bool inside = g_inputs.empty();
  for (const auto& r : g_inputs) inside = inside || (a >= r.first && a + size <= r.second);
  return inside;
}
template <class T> inline T __ldg(const T* p) {
  if (inside_inputs(p, sizeof(T))) return *p;
  ++g_stray;
  return T{};
}
extern "C" void rehearse_inputs(int n, const int64_t* lo, const int64_t* hi) {
  g_inputs.clear();
  for (int i = 0; i < n; ++i)
    g_inputs.emplace_back(reinterpret_cast<const char*>(lo[i]),
                          reinterpret_cast<const char*>(hi[i]));
  g_stray = 0;
}
extern "C" long rehearse_stray() { return g_stray; }
template <class T> inline const T* pinned(const T* p) { return p; }
// bf16 and f16 as their bits; CUDA's conversions as integer arithmetic.
struct __nv_bfloat16 { uint16_t x; };
struct __half { uint16_t x; };
inline uint32_t f32_bits(float f) { uint32_t u; std::memcpy(&u, &f, 4); return u; }
inline float bits_f32(uint32_t u) { float f; std::memcpy(&f, &u, 4); return f; }
inline float __bfloat162float(__nv_bfloat16 h) { return bits_f32(uint32_t(h.x) << 16); }
inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  const uint32_t u = f32_bits(f);
  if ((u & 0x7fffffffu) > 0x7f800000u) return {uint16_t((u >> 16) | 0x40u)};  // quiet NaN
  return {uint16_t((u + 0x7fffu + ((u >> 16) & 1u)) >> 16)};  // to nearest even
}
inline float __half2float(__half h) {
  const uint32_t sign = uint32_t(h.x & 0x8000u) << 16, e = (h.x >> 10) & 0x1fu;
  uint32_t m = h.x & 0x3ffu;
  if (e == 0x1fu) return bits_f32(sign | 0x7f800000u | (m << 13));  // inf, NaN
  if (e) return bits_f32(sign | ((e + 112u) << 23) | (m << 13));
  if (!m) return bits_f32(sign);
  uint32_t k = 113u;  // a subnormal, m 2^-24: normalised
  while (!(m & 0x400u)) { m <<= 1; --k; }
  return bits_f32(sign | (k << 23) | ((m & 0x3ffu) << 13));
}
inline __half __float2half_rn(float f) {
  const uint32_t u = f32_bits(f), sign = (u >> 16) & 0x8000u, a = u & 0x7fffffffu;
  if (a > 0x7f800000u) return {uint16_t(sign | 0x7e00u | ((a >> 13) & 0x3ffu))};  // quiet NaN
  if (a >= 0x477ff000u) return {uint16_t(sign | 0x7c00u)};  // 65520 and above: inf
  if (a >= 0x38800000u) {  // a normal f16: rebias, then to nearest even
    const uint32_t m = a - 0x38000000u;
    return {uint16_t(sign | ((m + 0xfffu + ((m >> 13) & 1u)) >> 13))};
  }
  const int shift = 126 - int(a >> 23);  // a subnormal f16: (1.m) 2^(e - 127) / 2^-24
  if (shift > 24) return {uint16_t(sign)};
  const uint32_t mant = (a & 0x7fffffu) | 0x800000u, half = 1u << (shift - 1);
  const uint32_t rem = mant & ((1u << shift) - 1u);
  uint32_t r = mant >> shift;
  if (rem > half || (rem == half && (r & 1u))) ++r;
  return {uint16_t(sign | r)};
}
// A word of two adjacent cells, and the packed conversions: each half
// converted as the one-cell conversion converts it.
struct __nv_bfloat162 { __nv_bfloat16 x, y; };
struct __half2 { __half x, y; };
struct alignas(8) float2 { float x, y; };
struct alignas(16) float4 { float x, y, z, w; };
inline float2 make_float2(float a, float b) { return {a, b}; }
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
inline float2 __bfloat1622float2(__nv_bfloat162 v) {
  return {__bfloat162float(v.x), __bfloat162float(v.y)};
}
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) {
  return {__float2bfloat16_rn(a), __float2bfloat16_rn(b)};
}
inline float2 __half22float2(__half2 v) { return {__half2float(v.x), __half2float(v.y)}; }
inline __half2 __floats2half2_rn(float a, float b) {
  return {__float2half_rn(a), __float2half_rn(b)};
}
// The word moves and the packed arithmetic of 2-byte values: each half of
// an operation the f32 operation on the widened halves, rounded to the
// type, which is what the card's __hadd2_rn and __hmul2_rn give (chip_smoke.py
// holds them to it over every pair of operands); __hneg2 flips each sign.
inline __nv_bfloat162 __halves2bfloat162(__nv_bfloat16 a, __nv_bfloat16 b) { return {a, b}; }
inline __nv_bfloat16 __low2bfloat16(__nv_bfloat162 v) { return v.x; }
inline __nv_bfloat16 __high2bfloat16(__nv_bfloat162 v) { return v.y; }
inline __half2 __halves2half2(__half a, __half b) { return {a, b}; }
inline __half __low2half(__half2 v) { return v.x; }
inline __half __high2half(__half2 v) { return v.y; }
inline __nv_bfloat162 __hadd2_rn(__nv_bfloat162 a, __nv_bfloat162 b) {
  return {__float2bfloat16_rn(__bfloat162float(a.x) + __bfloat162float(b.x)),
          __float2bfloat16_rn(__bfloat162float(a.y) + __bfloat162float(b.y))};
}
inline __nv_bfloat162 __hmul2_rn(__nv_bfloat162 a, __nv_bfloat162 b) {
  return {__float2bfloat16_rn(__bfloat162float(a.x) * __bfloat162float(b.x)),
          __float2bfloat16_rn(__bfloat162float(a.y) * __bfloat162float(b.y))};
}
inline __nv_bfloat162 __hneg2(__nv_bfloat162 v) {
  return {{uint16_t(v.x.x ^ 0x8000u)}, {uint16_t(v.y.x ^ 0x8000u)}};
}
inline __half2 __hadd2_rn(__half2 a, __half2 b) {
  return {__float2half_rn(__half2float(a.x) + __half2float(b.x)),
          __float2half_rn(__half2float(a.y) + __half2float(b.y))};
}
inline __half2 __hmul2_rn(__half2 a, __half2 b) {
  return {__float2half_rn(__half2float(a.x) * __half2float(b.x)),
          __float2half_rn(__half2float(a.y) * __half2float(b.y))};
}
inline __half2 __hneg2(__half2 v) {
  return {{uint16_t(v.x.x ^ 0x8000u)}, {uint16_t(v.y.x ^ 0x8000u)}};
}
// An async slab's copies: each is queued and performed only at the thread's
// wait_copies(), its destination NaN until then, so a read before the wait
// shows as a wrong value.
inline float copy_value(float v) { return v; }
inline float copy_value(__nv_bfloat16 v) { return __bfloat162float(v); }
inline float copy_value(__half v) { return __half2float(v); }
template <class T> inline void copy_async(float* dst, const T* src, bool valid) {
  const uint32_t nan = 0x7fc00000u;
  std::memcpy(dst, &nan, 4);
  if (valid && !inside_inputs(src, sizeof(T))) {   // counted as a stray __ldg is
    ++g_stray;
    valid = false;
  }
  (*g_fibers)[g_cur].copies.push_back([=] { *dst = valid ? copy_value(*src) : 0.0f; });
}
inline void commit_copies() {}
inline void wait_copies() {
  auto& copies = (*g_fibers)[g_cur].copies;
  for (auto& c : copies) c();
  copies.clear();
}
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
          f.copies.clear();
          f.groups.clear();
          f.open = 0;
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
_LAUNCH = re.compile(r"(stencil_kernel|diffusion3d_steps_kernel<K, S>|kernel)"
                     r"<<<grid, block, [A-Za-z0-9]+, "
                     r"(?:st|static_cast<cudaStream_t>\(stream\))>>>\(")
# any kernel launched as ``name<<<grid, block, smem, st>>>(`` (the LM
# backward sources)
_LAUNCH_ANY = re.compile(r"([A-Za-z_]\w*(?:<[^<>;]*>)?)<<<grid, block, [A-Za-z0-9_]+, st>>>\(")
_LAUNCHED = re.compile(r"(run_grid\(grid, block, \[&\] \{ [A-Za-z0-9_<>, ]+\(\n[^;]*\));")
_SET_SHARED = re.compile(r"  const cudaError_t set = cudaFuncSetAttribute\([^;]*;\n"
                         r"  if \(set != cudaSuccess\) [^\n]*\n")


def _host_text(text: str, shared_floats: int = 0, launch: re.Pattern = _LAUNCH) -> str:
    """CUDA source as C++ for the host behind :data:`_SHIM`: each launch a
    loop over the grid's blocks and threads; dynamic shared memory (of
    ``shared_floats`` 4-byte words) a static array whose bytes are all set
    to 0xff before each block, as a card may leave it holding anything
    (a NaN as f32, bf16 and f16 alike). ``launch`` finds the launches."""
    if "extern __shared__ float smem[];" in text:
        shared_floats = max(shared_floats, 1)     # a launch may need none
        text = text.replace("extern __shared__ float smem[];", "float* const smem = g_smem;")
        text = text.replace("namespace {\n", "namespace {\n"
                            f"alignas(16) float g_smem[{shared_floats}];\n"
                            "void nan_smem() { std::memset(g_smem, 0xff, sizeof g_smem); }\n"
                            "const int g_smem_hook = (g_block_start = nan_smem, 0);\n", 1)
    for part in ("copies", "pinned"):      # the shim's stand-ins take their place
        if f"// {part}: begin\n" in text:
            a, b = text.index(f"// {part}: begin\n"), text.index(f"// {part}: end\n")
            text = text[:a] + text[b + len(f"// {part}: end\n"):]
    for header in ("cuda_runtime.h", "cuda_bf16.h", "cuda_fp16.h"):
        text = text.replace(f"#include <{header}>\n", "")
    text = _SET_SHARED.sub("", text)
    text = launch.sub(r"run_grid(grid, block, [&] { \1(", text)
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
            return _host_text(codegen.cuda_source(call.program, call.shape, call.dtype,
                                                  batched=call.batched),
                              codegen.shared_bytes(call.program, call.shape) // 4)
        text = codegen_steps.cuda_source(call.program, call.rotations, call.nsteps, call.shape,
                                         call.dtype)
        return _host_text(text, codegen_steps.shared_bytes(call.program, call.plan,
                                                           call.shape, call.dtype) // 4)
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
        done = subprocess.run([cxx, "-std=c++17", "-O1", "-ffp-contract=off",
                               "-fno-strict-aliasing", "-fPIC", "-shared", "-w", "-o", str(tmp),
                               str(src)],
                              capture_output=True, text=True)
        if done.returncode != 0:
            raise RuntimeError(f"g++ failed on the rehearsal of {name}:\n"
                               f"{done.stderr[:8000]}")
        os.replace(tmp, lib)
        src.unlink()
    return ctypes.CDLL(str(lib))


_CONVERT = r'''
extern "C" void narrow(const float* x, uint16_t* out, int64_t n, int half) {
  for (int64_t i = 0; i < n; ++i)
    out[i] = half ? __float2half_rn(x[i]).x : __float2bfloat16_rn(x[i]).x;
}
extern "C" void widen(const uint16_t* h, float* out, int64_t n, int half) {
  for (int64_t i = 0; i < n; ++i)
    out[i] = half ? __half2float(__half{h[i]}) : __bfloat162float(__nv_bfloat16{h[i]});
}
extern "C" void narrow_pairs(const float* x, uint16_t* out, int64_t n, int half) {
  for (int64_t i = 0; i + 1 < n; i += 2) {
    if (half) {
      const __half2 p = __floats2half2_rn(x[i], x[i + 1]);
      out[i] = p.x.x, out[i + 1] = p.y.x;
    } else {
      const __nv_bfloat162 p = __floats2bfloat162_rn(x[i], x[i + 1]);
      out[i] = p.x.x, out[i + 1] = p.y.x;
    }
  }
}
template <class V, class S> V word(const uint16_t* h, int64_t i) { return V{S{h[i]}, S{h[i + 1]}}; }
// each pair (a[i], a[i + 1]) op (b[i], b[i + 1]) as one packed operation;
// op 0: __hadd2_rn, 1: __hadd2_rn of __hneg2 (a - b), 2: __hmul2_rn
extern "C" void packed_op(const uint16_t* a, const uint16_t* b, uint16_t* out, int64_t n,
                          int op, int half) {
  for (int64_t i = 0; i + 1 < n; i += 2) {
    if (half) {
      const __half2 x = word<__half2, __half>(a, i), y = word<__half2, __half>(b, i);
      const __half2 r = op == 0 ? __hadd2_rn(x, y) : op == 1 ? __hadd2_rn(x, __hneg2(y))
                                                             : __hmul2_rn(x, y);
      out[i] = __low2half(r).x, out[i + 1] = __high2half(r).x;
    } else {
      using B = __nv_bfloat162;
      const B x = word<B, __nv_bfloat16>(a, i), y = word<B, __nv_bfloat16>(b, i);
      const B r = op == 0 ? __hadd2_rn(x, y) : op == 1 ? __hadd2_rn(x, __hneg2(y))
                                                       : __hmul2_rn(x, y);
      out[i] = __low2bfloat16(r).x, out[i + 1] = __high2bfloat16(r).x;
    }
  }
}
// the z neighbours of each word w of a row as the pair kernel moves them:
// below (w - 1's high half, w's low half), above (w's high half, w + 1's low)
extern "C" void word_moves(const uint16_t* h, uint16_t* below, uint16_t* above, int64_t n,
                           int half) {
  for (int64_t i = 2; i + 3 < n; i += 2) {
    if (half) {
      const __half2 p = word<__half2, __half>(h, i - 2), c = word<__half2, __half>(h, i),
                    q = word<__half2, __half>(h, i + 2);
      const __half2 m = __halves2half2(__high2half(p), __low2half(c));
      const __half2 u = __halves2half2(__high2half(c), __low2half(q));
      below[i] = m.x.x, below[i + 1] = m.y.x, above[i] = u.x.x, above[i + 1] = u.y.x;
    } else {
      using B = __nv_bfloat162;
      const B p = word<B, __nv_bfloat16>(h, i - 2), c = word<B, __nv_bfloat16>(h, i),
              q = word<B, __nv_bfloat16>(h, i + 2);
      const B m = __halves2bfloat162(__high2bfloat16(p), __low2bfloat16(c));
      const B u = __halves2bfloat162(__high2bfloat16(c), __low2bfloat16(q));
      below[i] = m.x.x, below[i + 1] = m.y.x, above[i] = u.x.x, above[i + 1] = u.y.x;
    }
  }
}
extern "C" void widen_pairs(const uint16_t* h, float* out, int64_t n, int half) {
  for (int64_t i = 0; i + 1 < n; i += 2) {
    const float2 f = half ? __half22float2(__half2{__half{h[i]}, __half{h[i + 1]}})
                          : __bfloat1622float2(__nv_bfloat162{__nv_bfloat16{h[i]},
                                                              __nv_bfloat16{h[i + 1]}});
    out[i] = f.x, out[i + 1] = f.y;
  }
}
'''


def convert(x: torch.Tensor, dtype: torch.dtype, pairs: bool = False) -> torch.Tensor:
    """The rehearsal's own conversions on a CPU tensor: f32 to ``dtype``
    (bf16 or f16) with ``__float2bfloat16_rn``/``__float2half_rn``, or a
    bf16/f16 tensor to f32 with ``__bfloat162float``/``__half2float``; with
    ``pairs`` (an even number of elements) the packed conversions of each
    two adjacent elements, ``__floats2bfloat162_rn``/``__floats2half2_rn``
    and ``__bfloat1622float2``/``__half22float2``."""
    lib = _compile(_SHIM + _CONVERT, "convert")
    src = x.contiguous()
    if pairs and src.numel() % 2:
        raise ValueError("the packed conversions take an even number of elements")
    if src.dtype == torch.float32:
        out = torch.empty(src.shape, dtype=dtype)
        fn, half = lib.narrow_pairs if pairs else lib.narrow, dtype == torch.float16
    else:
        out = torch.empty(src.shape, dtype=torch.float32)
        fn, half = lib.widen_pairs if pairs else lib.widen, src.dtype == torch.float16
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int]
    fn.restype = None
    fn(src.data_ptr(), out.data_ptr(), src.numel(), int(half))
    return out


PACKED_OPS = ("add", "sub", "mul")


def packed_op(a: torch.Tensor, b: torch.Tensor, op: str) -> torch.Tensor:
    """The rehearsal's packed 2-byte arithmetic on CPU tensors of bf16 or
    f16 (an even number of elements): each adjacent pair of ``a`` with the
    same pair of ``b`` as one ``__hadd2_rn`` (``add``), ``__hadd2_rn`` of
    ``__hneg2`` (``sub``) or ``__hmul2_rn`` (``mul``)."""
    lib = _compile(_SHIM + _CONVERT, "convert")
    x, y = a.contiguous(), b.contiguous()
    if x.numel() % 2 or x.shape != y.shape or x.dtype != y.dtype:
        raise ValueError("the packed operations take two tensors of one even size and dtype")
    out = torch.empty_like(x)
    fn = lib.packed_op
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_int, ctypes.c_int]
    fn.restype = None
    fn(x.data_ptr(), y.data_ptr(), out.data_ptr(), x.numel(), PACKED_OPS.index(op),
       int(x.dtype == torch.float16))
    return out


def word_moves(h: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The z neighbours of a 2-byte row (even length) as the pair kernel
    moves them out of its aligned words: ``below[i] = h[i - 1]`` and
    ``above[i] = h[i + 1]`` for every cell of a word with words on both
    sides (0 elsewhere)."""
    lib = _compile(_SHIM + _CONVERT, "convert")
    x = h.contiguous()
    below, above = torch.zeros_like(x), torch.zeros_like(x)
    fn = lib.word_moves
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_int]
    fn.restype = None
    fn(x.data_ptr(), below.data_ptr(), above.data_ptr(), x.numel(),
       int(x.dtype == torch.float16))
    return below, above


def run(call: stencil.StencilCall, fields: Mapping[str, torch.Tensor],
        scalars: Mapping[str, Any], n_sm: int = 132, xc: int | None = None,
        text: str | None = None):
    """``(outs, reds)`` of the printed kernel on CPU tensors, launched as
    ``StencilCall.run`` launches it on a card with ``n_sm`` SMs, or with
    chunks of ``xc`` planes; ``text`` runs that C++ (an edited
    :func:`source`) instead of the call's own. Each input field lies in
    the middle of a NaN buffer (:func:`_guarded`), and a load through
    ``__ldg`` outside every field raises."""
    ins = {f: _guarded(fields[f]) for f in call.program.fields}
    call, outs, parts, args = call.prepare(ins, scalars, n_sm, xc, divisor=float)
    _launch(call, library(call) if text is None else _compile(text, call.lib_name), ins,
            parts, args)
    return call.finish(outs, parts)


def _launch(call: stencil.StencilCall, lib, ins: Mapping[str, torch.Tensor], parts,
            args) -> None:
    """One rehearsed launch of ``call``'s entry point: its partials NaN
    first (a block that writes none shows), ``ins`` registered as the
    inputs, and a load outside them raising."""
    for part in parts:
        part.fill_(float("nan"))
    bounds = [(t.data_ptr(), t.data_ptr() + t.numel() * t.element_size()) for t in ins.values()]
    lo, hi = ((ctypes.c_int64 * len(bounds))(*b) for b in zip(*bounds))
    lib.rehearse_inputs(len(bounds), lo, hi)
    fn = lib.launch
    fn.argtypes = call.argtypes()
    fn.restype = ctypes.c_int
    if fn(*args, None):
        raise RuntimeError(f"the rehearsed {call.lib_name} refused its launch")
    lib.rehearse_stray.restype = ctypes.c_long
    stray = lib.rehearse_stray()
    if stray:
        raise RuntimeError(f"the rehearsed {call.lib_name} made {stray} loads outside its "
                           "input fields")


def run_batch(call: stencil.StencilCall, bufs: Mapping[str, torch.Tensor], scalars,
              live: torch.Tensor, odd: torch.Tensor, flip: int = 0, n_sm: int = 132,
              xc: int | None = None):
    """``(bufs, reds)`` of the printed batched kernel (``call.batched``)
    on CPU buffers, launched as ``StencilCall.run_batch`` launches it on a
    card with ``n_sm`` SMs (or with chunks of ``xc`` planes): copies of
    ``bufs``, each in the middle of a NaN buffer, advanced in place, and
    each reduction as a ``(B,)`` vector."""
    ins = {n: _guarded(t) for n, t in bufs.items()}
    params = call.batch_params(scalars, divisor=float)
    launch, parts, args = call.batch_arguments(ins, params, live.contiguous(),
                                               odd.contiguous(), flip, n_sm, xc)
    _launch(call, library(call), ins, parts, args)
    return ins, call.finish_batch(parts, launch.samples)


def _guarded(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` at the same address modulo 256 bytes (so
    it takes the same layout), with NaN of at least its own size on either
    side: a load past the field's ends by up to its size lands in no other
    input, so :func:`run` counts it."""
    src = t.contiguous()
    n, item = src.numel(), src.element_size()
    lanes = 256 // item
    buf = torch.full((3 * n + lanes,), float("nan"), dtype=src.dtype)
    shift = ((src.data_ptr() - buf.data_ptr()) // item - n) % lanes
    return buf[n + shift:2 * n + shift].view(src.shape).copy_(src)


def diffusion3d_step(T2, T, Ci, lam, dt, inv_dx, inv_dy, inv_dz, nsteps: int = 1,
                     n_sm: int = 132, xc: int | None = None, alias: bool = False,
                     text: str | None = None) -> torch.Tensor:
    """The hand kernel ``csrc/diffusion3d.cu`` on CPU tensors (f32, bf16 or
    f16), launched as ``diffusion3d.diffusion3d_step`` launches it on a card
    with ``n_sm`` SMs (or with chunks of ``xc`` planes; the layout, one
    cell or a pair a thread, by ``diffusion3d.pairs_fit``), into a new
    tensor or, with ``alias``, into T2's own buffer. ``text`` runs that
    source (an edited ``csrc/diffusion3d.cu``) instead of the repo's. T2, T
    and Ci each lie in the middle of a NaN buffer, and a load through
    ``__ldg`` or an asynchronous copy outside them raises."""
    from . import diffusion3d, ref

    text = build.read_source(diffusion3d.SOURCE) if text is None else text
    # room for every variant of the source's k-step layout (tune_stencil's)
    shared = max(diffusion3d.shared_bytes(k, 4, ci, 32)
                 for k in range(2, diffusion3d.MAX_STEPS + 1) for ci in (False, True))
    lib = _compile(_host_text(text, shared // 4), "diffusion3d")
    fn = lib.launch
    fn.argtypes = diffusion3d._ARGTYPES
    fn.restype = ctypes.c_int
    ins = [_guarded(t) for t in (T2, T, Ci)]
    out = ins[0] if alias else torch.empty_like(T)
    pairs = nsteps == 1 and diffusion3d.pairs_fit(T.shape[2], out, *ins)
    launch = diffusion3d.column_launch(tuple(T.shape), n_sm, nsteps, T.element_size(), pairs)
    if xc is not None:
        launch = stencil.Launch((*launch.grid[:2], -(-T.shape[0] // xc)), launch.block, xc)
    bounds = [(t.data_ptr(), t.data_ptr() + t.numel() * t.element_size()) for t in ins]
    lo, hi = ((ctypes.c_int64 * len(bounds))(*b) for b in zip(*bounds))
    lib.rehearse_inputs(len(bounds), lo, hi)
    err = fn(out.data_ptr(), *(t.data_ptr() for t in ins),
             *ref.stored_scalars(T.dtype, lam, dt, inv_dx, inv_dy, inv_dz), *T.shape,
             launch.xc, int(nsteps), stencil.STORAGE_DTYPES.index(T.dtype), *launch.grid, None)
    if err:
        raise RuntimeError(f"the rehearsed diffusion3d launch refused nsteps={nsteps}")
    lib.rehearse_stray.restype = ctypes.c_long
    stray = lib.rehearse_stray()
    if stray:
        raise RuntimeError(f"the rehearsed diffusion3d made {stray} loads outside its fields")
    return out.clone() if alias else out


# The runtime calls of the LM sources: every one succeeds. Warp shuffles of
# any 4- or 8-byte type, each through a barrier of the warp's 32 threads.
_LM_SHIM = r"""
typedef int cudaError_t;
static const int cudaSuccess = 0;
static const int cudaErrorInvalidValue = 1;
static const int cudaFuncAttributeMaxDynamicSharedMemorySize = 8;
template <class F> inline cudaError_t cudaFuncSetAttribute(F, int, int) { return 0; }
inline cudaError_t cudaGetLastError() { return 0; }
inline uint32_t __float_as_uint(float f) { return f32_bits(f); }
inline float __uint_as_float(uint32_t u) { return bits_f32(u); }
static uint64_t g_lane_bits[2048];
inline int lane_tid() { return threadIdx.y * blockDim.x + threadIdx.x; }
// v of lane `from` of the calling warp (v itself where `keep`)
template <class T> inline T lane_value(T v, int from, bool keep) {
  static_assert(sizeof(T) <= 8, "a shuffle moves at most 8 bytes");
  const int tid = lane_tid();
  uint64_t bits = 0;
  std::memcpy(&bits, &v, sizeof(T));
  g_lane_bits[tid] = bits;
  arrive(g_warp[tid >> 5]);
  T r = v;
  if (!keep) std::memcpy(&r, &g_lane_bits[(tid & ~31) | (from & 31)], sizeof(T));
  arrive(g_warp[tid >> 5]);
  return r;
}
template <class T> inline T __shfl_xor_sync(unsigned, T v, int o) {
  return lane_value(v, (lane_tid() & 31) ^ o, false);
}
template <class T> inline T __shfl_up_sync(unsigned, T v, unsigned d) {
  const int lane = lane_tid() & 31;
  return lane_value(v, lane - int(d), lane < int(d));
}
template <class T> inline T __shfl_down_sync(unsigned, T v, unsigned d) {
  const int lane = lane_tid() & 31;
  return lane_value(v, lane + int(d), lane + int(d) > 31);
}
"""

# The host twin of csrc/tf32x3.cuh, which takes its place where an LM source
# inlines it. The splits are the card's integer arithmetic. mma_tf32 is
# mma.sync.m16n8k8 on the warp's fragments in PTX's layout (group g = lane /
# 4, t = lane % 4: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4);
# b0 (t, g), b1 (t + 4, g); c0, c1 (g, 2t, 2t + 1), c2, c3 (g + 8, 2t, 2t +
# 1)): each lane posts its fragments, passes the warp's barrier and sums its
# D elements in f32 over k in order (a product of two TF32 values is exact
# in f32). Every lane of the warp must reach it, as on the card. A cp.async
# copy writes NaN at once and its value only at a wait that covers its
# group, so a read before the wait shows.
_TF32X3_HOST = r"""
// two banks a lane, taken in turns: a lane posts its next fragments into the
// other bank, which every lane of its warp finished reading before the
// barrier that let it go on, so a product needs one barrier
static float g_mma[2][2048][12];
static unsigned g_mma_calls[2048];
inline void* __cvta_generic_to_shared(const void* p) { return const_cast<void*>(p); }
namespace tf32x3 {
inline uint32_t to_tf32(float x) { return (__float_as_uint(x) + 0x1000u) & 0xffffe000u; }
inline void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}
inline void split4(const float (&a)[4], uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  for (int r = 0; r < 4; ++r) split(a[r], hi[r], lo[r]);
}
// d += A·B of m16n8k8 from the fragments the warp's lanes posted in g_mma:
// A's a0..a3 in slots sa..sa+3 and B's b0, b1 in slots sb, sb+1 of each lane
inline void mma_posted(float (&d)[4], const float (*post)[12], int lane, int sa, int sb) {
  const int g = lane >> 2, t = lane & 3;
  for (int e = 0; e < 4; ++e) {
    const int row = g + 8 * (e >> 1), col = 2 * t + (e & 1);
    float s = d[e];
    for (int k = 0; k < 8; ++k)
      s += post[4 * (row & 7) + (k & 3)][sa + (row >> 3) + 2 * (k >> 2)] *
           post[4 * col + (k & 3)][sb + (k >> 2)];
    d[e] = s;
  }
}
inline void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  const int tid = lane_tid();
  const float (*post)[12] = g_mma[g_mma_calls[tid]++ & 1] + (tid & ~31);
  float* mine = g_mma[g_mma_calls[tid] - 1 & 1][tid];
  for (int r = 0; r < 4; ++r) mine[r] = __uint_as_float(a[r]);
  mine[4] = __uint_as_float(b0);
  mine[5] = __uint_as_float(b1);
  arrive(g_warp[tid >> 5]);
  mma_posted(d, post, tid & 31, 0, 4);
}
// the device's three mma_tf32 in its order, on one posting of the fragments
inline void mma3(float (&d)[4], const uint32_t (&ah)[4], const uint32_t (&al)[4], float b0,
                 float b1) {
  const int tid = lane_tid();
  const float (*post)[12] = g_mma[g_mma_calls[tid]++ & 1] + (tid & ~31);
  float* mine = g_mma[g_mma_calls[tid] - 1 & 1][tid];
  uint32_t b[4];  // b0 hi, b1 hi, b0 lo, b1 lo
  split(b0, b[0], b[2]);
  split(b1, b[1], b[3]);
  for (int r = 0; r < 4; ++r) {
    mine[r] = __uint_as_float(ah[r]);
    mine[4 + r] = __uint_as_float(al[r]);
    mine[8 + r] = __uint_as_float(b[r]);
  }
  arrive(g_warp[tid >> 5]);
  mma_posted(d, post, tid & 31, 4, 8);
  mma_posted(d, post, tid & 31, 0, 10);
  mma_posted(d, post, tid & 31, 0, 8);
}
// the words are moved as bytes (two bf16 values a word at 2 bytes); a NaN
// in every 2- and 4-byte value until the wait
inline void async_words(void* smem, const void* gmem, int words, bool valid) {
  char* dst = static_cast<char*>(smem);
  const char* src = static_cast<const char*>(gmem);
  std::memset(dst, 0xff, 4 * words);
  Fiber& f = (*g_fibers)[g_cur];
  f.groups.emplace_back(f.open, [=] {
    if (valid) std::memcpy(dst, src, 4 * words);
    else std::memset(dst, 0, 4 * words);
  });
}
inline void cp_async16(void* smem, const void* gmem, bool valid) {
  async_words(smem, gmem, 4, valid);
}
inline void cp_async8(void* smem, const void* gmem, bool valid) {
  async_words(smem, gmem, 2, valid);
}
inline void cp_async4(void* smem, const void* gmem, bool valid) {
  async_words(smem, gmem, 1, valid);
}
inline void cp_async_commit() { ++(*g_fibers)[g_cur].open; }
// the copies of every committed group
inline void cp_async_wait_all() {
  Fiber& f = (*g_fibers)[g_cur];
  std::vector<std::pair<int, std::function<void()>>> left;
  for (auto& c : f.groups) {
    if (c.first < f.open) c.second();
    else left.push_back(c);
  }
  f.groups.swap(left);
}
}  // namespace tf32x3
"""


def lm_library(path, name: str, shared_floats: int = 0, bf16: bool = False) -> ctypes.CDLL:
    """The hand-written source at ``path`` compiled for the CPU, with
    ``shared_floats`` words of dynamic shared memory; ``csrc/tf32x3.cuh``
    where it is inlined becomes its host twin (``_TF32X3_HOST``). With
    ``bf16``, its bfloat16 instance (``build.instance``)."""
    name, text = build.instance(name, path, bf16)
    return _lm_compile(text, name, shared_floats)


def _lm_compile(text: str, name: str, shared_floats: int = 0) -> ctypes.CDLL:
    header = (build.CSRC_DIR / "tf32x3.cuh").read_text()
    text = _host_text(text.replace(header, _TF32X3_HOST), shared_floats, _LAUNCH_ANY)
    return _compile(text.replace(_SHIM, _SHIM + _LM_SHIM, 1), name)


# One warp's mma_tf32 on fragments given per lane: what
# tests/test_torch_train_kernels.py holds to the product in PTX's layout.
_MMA_SOURCE = r"""#include <cstdint>
#include <cuda_runtime.h>
#include "tf32x3.cuh"
namespace {
using namespace tf32x3;
__global__ void mma_lanes(float* d, const uint32_t* a, const uint32_t* b, const float* c) {
  const int lane = threadIdx.x;
  const uint32_t af[4] = {a[4 * lane], a[4 * lane + 1], a[4 * lane + 2], a[4 * lane + 3]};
  float acc[4] = {c[4 * lane], c[4 * lane + 1], c[4 * lane + 2], c[4 * lane + 3]};
  mma_tf32(acc, af, b[2 * lane], b[2 * lane + 1]);
  for (int e = 0; e < 4; ++e) d[4 * lane + e] = acc[e];
}
}  // namespace
extern "C" int launch(float* d, const uint32_t* a, const uint32_t* b, const float* c) {
  const dim3 grid(1, 1, 1), block(32, 1, 1);
  cudaStream_t st = nullptr;
  mma_lanes<<<grid, block, 0, st>>>(
      d, a, b, c);
  return static_cast<int>(cudaGetLastError());
}
extern "C" const char* error_string(int) { return ""; }
"""


def mma_tf32_lanes(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """One warp's ``tf32x3::mma_tf32`` of the host twin on fragments given per
    lane: ``a`` (32, 4) and ``b`` (32, 2) TF32 values (f32 with the low 13
    mantissa bits 0), ``c`` (32, 4) f32. Returns each lane's D fragment (32,
    4)."""
    text = build._LOCAL_INCLUDE.sub(
        lambda m: (build.CSRC_DIR / m.group(1)).read_text(), _MMA_SOURCE)
    lib = _lm_compile(text, "mma_lanes")
    lib.rehearse_inputs(0, None, None)
    d = torch.full((32, 4), float("nan"))
    a, b, c = (t.to(torch.float32).contiguous() for t in (a, b, c))
    lib.launch.argtypes = [ctypes.c_void_p] * 4
    lib.launch.restype = ctypes.c_int
    if lib.launch(d.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr()):
        raise RuntimeError("the rehearsed mma_tf32 refused its launch")
    return d


def lm_instance(name: str, bf16: bool = False) -> tuple:
    """(source path, shared memory in floats) of the rehearsed LM source
    ``name`` (conv1d, conv1d_bwd, ssd_bwd, attention_bwd), for its float32
    instance or with ``bf16`` its bfloat16 one: room for every launch the
    wrapper makes."""
    from . import attention, conv1d as conv, ssd

    size = 2 if bf16 else 4
    return {"conv1d": (conv.SOURCE, conv.smem_floats(conv.MAX_K, 4, conv.MAX_TILE, size)),
            "conv1d_bwd": (conv.BWD_SOURCE, conv.bwd_smem_floats(conv.MAX_K, 4, conv.MAX_TILE,
                                                                 size)),
            "ssd_bwd": (ssd.BWD_SOURCE, ssd.bwd_smem_floats(ssd.MAX_N_BWD)),
            "attention_bwd": (attention.BWD_SOURCE,
                              max(map(attention.bwd_smem_floats, attention.HEAD_DIMS)))}[name]


LM_REHEARSED = ("conv1d", "conv1d_bwd", "ssd_bwd", "attention_bwd")


def compile_lm(instances) -> None:
    """Compile the rehearsals of ``instances`` ((name, bf16) pairs of
    :data:`LM_REHEARSED`) together, one g++ each in its own thread; each is
    then loaded from its file as the rehearsal calls it."""
    import concurrent.futures

    jobs = [(*lm_instance(name, bf16), bf16, name) for name, bf16 in instances]
    with concurrent.futures.ThreadPoolExecutor(max(len(jobs), 1)) as pool:
        list(pool.map(lambda j: lm_library(j[0], j[3], j[1], j[2]), jobs))


def _run_lm(name: str, argtypes, args, dtype: torch.dtype) -> None:
    """The rehearsed LM source ``name`` (its instance for ``dtype``) run on
    the CPU through its ``launch`` entry point with ``args`` (the stream
    None)."""
    bf16 = dtype == torch.bfloat16
    path, shared = lm_instance(name, bf16)
    lib = lm_library(path, name, shared, bf16)
    lib.rehearse_inputs(0, None, None)
    fn = lib.launch
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    if fn(*args, None):
        raise RuntimeError(f"the rehearsed {name} refused its launch")


def _nan(*tensors) -> None:
    for t in tensors:
        if t is not None:
            t.fill_(float("nan"))


def conv1d(x, w, b, silu: bool = False):
    """``csrc/conv1d.cu`` on CPU tensors (its bf16 instance for bf16 ones):
    the output, as ``conv1d.conv1d_causal`` launches it on a card (a
    contiguous view that is not 16-byte aligned takes the one-channel
    copies here too)."""
    from . import conv1d as conv

    b = torch.zeros(x.shape[2], dtype=x.dtype) if b is None else b
    out, args = conv.fwd_arguments(x.contiguous(), w.contiguous(), b.contiguous(), silu)
    _nan(out)
    _run_lm("conv1d", conv._ARGTYPES, args, x.dtype)
    return out


def conv1d_bwd(dout, x, w, b, silu: bool = False):
    """``csrc/conv1d_bwd.cu`` on CPU tensors (its bf16 instance for bf16
    ones): (dx, dw, db), as ``conv1d.conv1d_causal_bwd`` launches it on a
    card (db None where b is)."""
    from . import conv1d as conv

    bias = torch.zeros(x.shape[2], dtype=x.dtype) if b is None else b
    (dx, dw, db), args, part = conv.bwd_arguments(dout.contiguous(), x.contiguous(),
                                                  w.contiguous(), bias.contiguous(), silu)
    _nan(dx, dw, db, part)
    _run_lm("conv1d_bwd", conv._BWD_ARGTYPES, args, x.dtype)
    return dx, dw, (db if b is not None else None)


def ssd_bwd(x, dt, A, Bm, Cm, dy, D=None, h0=None, dh_final=None, chunk: int = 64):
    """``csrc/ssd_bwd.cu`` on CPU tensors (its bf16 instance where x, Bm,
    Cm and dy are bf16), from the chunk-start states and final state of the
    plain recurrence (``ref.ssd_states``, f32) at the forward kernel's
    chunk (``ssd.plan``): the gradients as ``ssd.ssd_chunk_scan_bwd``
    returns them."""
    from . import ref, ssd

    cs, _ = ssd.plan(x.shape[1], chunk)
    states, h_final = ref.ssd_states(x, dt, A, Bm, Cm, h0=h0, chunk=cs)
    grads, args, work = ssd.bwd_arguments(x, dt, A, Bm, Cm, dy, D, h0, dh_final, states,
                                          h_final, chunk)
    _nan(work, *grads.values())
    _run_lm("ssd_bwd", ssd._BWD_ARGTYPES, args, x.dtype)
    return grads


def attention_bwd(q, k, v, dout, causal: bool = True, window=None, scale=None, out=None,
                  lse=None):
    """``csrc/attention_bwd.cu`` on CPU tensors (its bf16 instance for bf16
    ones), from the forward's f32 output and log-sum-exp (the plain
    forward's where ``out`` or ``lse`` is None): (dq, dk, dv), as
    ``attention.flash_attention_bwd`` launches it on a card."""
    from . import attention, ref

    if out is None:    # before rounding, as the forward kernel's out32
        out = ref.attention(q.float(), k.float(), v.float(), causal=causal, scale=scale,
                            window=window)
    if lse is None:
        lse = ref.attention_lse(q, k, causal=causal, scale=scale, window=window)
    grads, args, delta = attention.bwd_arguments(q, k, v, out, dout, lse, causal, window,
                                                 scale)
    _nan(delta, *grads)
    _run_lm("attention_bwd", attention._BWD_ARGTYPES, args, q.dtype)
    return grads

"""Build the port's CUDA sources with ``nvcc`` and bind them with ``ctypes``.

Every kernel is a ``.cu`` file with a plain C entry point (no PyTorch
headers), compiled at first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 [--fmad=false]
         -shared -Xcompiler -fPIC -Xptxas -v

into ``build/repro_torch/`` at the repository root, under a name that
carries a hash of the source and the flags, so a changed source rebuilds
and an unchanged one is loaded as it is. :func:`read_source` inlines the
headers a source includes from ``csrc/`` (``#include "name.cuh"``), so the
hash covers them too and the compiled text stands alone. The library is
written to a temporary name and moved into place with ``os.replace``, so
two processes building the same source never see a half-written file; the
threads of one process build and load one at a time (a lock), so serving
workers may meet a kernel's first build together.

An LM source (attention, SSD, conv1d, forward and backward) is built once
for each storage dtype of its inputs (:func:`instance`): as it is for
float32, and with ``REPRO_TORCH_BF16`` defined in front (``csrc/storage.cuh``)
as a library of its own, ``<name>_bf16``, for bfloat16; both instances can
then be built by one :func:`compile_many`.

The flags are per source (:func:`flags`; an instance takes its source's). ``--fmad=false`` keeps every
multiply and add rounded on its own, as PyTorch's elementwise operators
round them, so the stencil kernels and conv1d can be compared bitwise with
their plain versions on the card. The sources in :data:`CONTRACTED`
(attention, SSD) are held to a tolerance, not bitwise, and compile with
FMA contraction.

There is no fallback: a missing ``nvcc`` or a failed build raises
``RuntimeError`` with the compiler's output.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Sequence

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# Sources compiled with FMA contraction; every other one gets --fmad=false.
CONTRACTED = frozenset({"attention", "ssd"})
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
CSRC_DIR = Path(__file__).resolve().parent / "csrc"
_LOCAL_INCLUDE = re.compile(r'^#include "([^"/]+)"[ \t]*$', re.M)


@dataclasses.dataclass(frozen=True)
class Build:
    """One compiled source: where it lives, what the compiler said, and how
    long the build took (0.0 when the library was already on disk)."""

    name: str
    library: Path
    seconds: float
    log: str


# Builds and loaded libraries of this process, by library path.
BUILDS: dict[Path, Build] = {}
_LOADED: dict[Path, ctypes.CDLL] = {}
_LOCK = threading.RLock()     # one build or load at a time in a process


def nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.access("/usr/local/cuda/bin/nvcc", os.X_OK):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError(
            "nvcc was not found on PATH or under /usr/local/cuda/bin; the CUDA "
            "kernels of repro_torch are built from source at first use"
        )
    return path


def read_source(path: Path) -> str:
    """The text of the CUDA source at ``path``, each ``#include "name"`` of
    a header in :data:`CSRC_DIR` replaced by that header's text."""
    return _LOCAL_INCLUDE.sub(lambda m: (CSRC_DIR / m.group(1)).read_text(),
                              Path(path).read_text())


BF16_SUFFIX = "_bf16"
BF16_DEFINE = "#define REPRO_TORCH_BF16 1\n"


def instance(name: str, path: Path, bf16: bool = False) -> tuple[str, str]:
    """(library name, source text) of the LM source ``name`` at ``path``
    for float32 storage, or with ``bf16`` for bfloat16 storage: the same
    text with ``REPRO_TORCH_BF16`` defined in front, named ``name_bf16``."""
    text = read_source(path)
    return (name + BF16_SUFFIX, BF16_DEFINE + text) if bf16 else (name, text)


def flags(name: str) -> tuple[str, ...]:
    """nvcc's flags for the source called ``name`` (a bf16 instance's are
    its source's)."""
    name = name.removesuffix(BF16_SUFFIX)
    return NVCC_FLAGS if name in CONTRACTED else NVCC_FLAGS + ("--fmad=false",)


def library_path(name: str, source: str) -> Path:
    digest = hashlib.sha256("\0".join((source, *flags(name))).encode()).hexdigest()
    return BUILD_DIR / f"{name}_{digest[:16]}.so"


def compile_many(sources: Sequence[tuple[str, str]]) -> list[Build]:
    """Compile ``(name, source text)`` pairs, one ``nvcc`` each, all started
    together; sources already built are not rebuilt."""
    with _LOCK:
        return _compile_many(sources)


def _compile_many(sources: Sequence[tuple[str, str]]) -> list[Build]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    pending, builds = [], {}
    for name, source in sources:
        lib = library_path(name, source)
        if lib in BUILDS:
            builds[lib] = BUILDS[lib]
        elif lib.exists():
            builds[lib] = BUILDS[lib] = Build(name, lib, 0.0, "")
        elif all(lib != p[2] for p in pending):     # one nvcc per library
            pending.append((name, source, lib))
    if pending:
        exe = nvcc()
        procs = []
        for name, source, lib in pending:
            # per-process names: another process may build the same source
            src = lib.with_name(f"{lib.stem}.tmp{os.getpid()}.cu")
            tmp = lib.with_name(f"{lib.name}.tmp{os.getpid()}")
            src.write_text(source)
            cmd = [exe, *flags(name), "-o", str(tmp), str(src)]
            procs.append((name, lib, src, tmp, cmd, time.perf_counter(), subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failures = []
        for name, lib, src, tmp, cmd, t0, proc in procs:
            out, _ = proc.communicate()
            seconds = time.perf_counter() - t0
            if proc.returncode != 0:
                failures.append(f"$ {' '.join(cmd)}\n{out}")
                continue
            os.replace(src, lib.with_suffix(".cu"))
            os.replace(tmp, lib)
            builds[lib] = BUILDS[lib] = Build(name, lib, seconds, out)
        if failures:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return [builds[library_path(name, source)] for name, source in sources]


class Library:
    """A loaded kernel library. Each source exports ``int launch(...)``,
    which returns the ``cudaGetLastError()`` after its launch, and
    ``const char* error_string(int)``."""

    def __init__(self, name: str, source: str, argtypes: Sequence):
        path = library_path(name, source)
        with _LOCK:
            if path not in _LOADED:
                compile_many([(name, source)])
                _LOADED[path] = ctypes.CDLL(str(path))
            lib = _LOADED[path]
        self.name = name
        self._launch = lib.launch
        self._launch.argtypes = list(argtypes)
        self._launch.restype = ctypes.c_int
        self._error_string = lib.error_string
        self._error_string.argtypes = [ctypes.c_int]
        self._error_string.restype = ctypes.c_char_p

    def launch(self, *args) -> None:
        """Call the entry point; raise if the launch was refused or failed.
        Pointers are ``c_void_p`` (and so is the stream), sizes ``c_int64``,
        scalars ``c_float``."""
        err = self._launch(*args)
        if err != 0:
            raise RuntimeError(
                f"CUDA launch of {self.name} failed: cudaError_t {err} "
                f"({self._error_string(err).decode()})"
            )

"""Build the port's native code at first use and load it with ctypes.

Two compilers, one rule: every source under ``csrc/`` compiles into its
own shared library with a plain C interface (no PyTorch headers, so a
build takes seconds), named by a hash of its sources and flags, inside
``build/`` next to this file (listed in ``.gitignore``).  A library that
exists is loaded as it is; a changed source gets a new name.  Builds of
several libraries start together (:func:`build`), one compiler process
each.  A build writes to a temporary name and renames, so concurrent
processes that build the same library never load a half-written file.

* CUDA kernels: ``nvcc -gencode arch=compute_90a,code=sm_90a -O3
  -shared`` (Hopper).  ``--fmad=false`` keeps the float64 arithmetic
  exactly that of the plain PyTorch versions: no contraction of a
  multiply and an add into one rounding.  ``-Xptxas -v`` reports each
  kernel's registers and spills into ``<library>.log``.
* Host C++ (the slot map, the wire codec, and the test-only host builds
  of the ticks' lane code and of the GLOBAL mesh's slot code):
  ``c++ -O2 -shared``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
]
CXX_FLAGS = ["-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC"]

# library name -> (compiler kind, sources); every header under csrc/ is
# hashed into every library's name.
LIBS = {
    "slotmap": ("cxx", ("slotmap.cc",)),
    "wirecodec": ("cxx", ("wirecodec.cc",)),
    "fused_tick": ("nvcc", ("fused_tick.cu",)),
    "fused_merged_tick": ("nvcc", ("fused_merged_tick.cu",)),
    "fused_ragged_tick": ("nvcc", ("fused_ragged_tick.cu",)),
    "fused_sorted_tick": ("nvcc", ("fused_sorted_tick.cu",)),
    "mesh_tile_tick": ("nvcc", ("mesh_tile_tick.cu",)),
    "rows": ("nvcc", ("rows.cu",)),
    "lease_apply": ("nvcc", ("lease_apply.cu",)),
    "global_mesh": ("nvcc", ("global_mesh.cu",)),
    "empty": ("nvcc", ("empty.cu",)),
    "fused_tick_host": ("cxx", ("fused_tick_host.cc",)),
    "global_mesh_host": ("cxx", ("global_mesh_host.cc",)),
}
CUDA_LIBS = tuple(n for n, (kind, _) in LIBS.items() if kind == "nvcc")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def _compiler(kind: str) -> str:
    if kind == "nvcc":
        path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
        if not os.path.exists(path):
            raise RuntimeError(
                "nvcc not found: the CUDA kernels build only where the "
                "CUDA toolkit is installed"
            )
        return path
    path = os.environ.get("CXX") or shutil.which("c++") or shutil.which("g++")
    if not path:
        raise RuntimeError("no C++ compiler found for the native slot map")
    return path


def library_path(name: str) -> str:
    """Where library ``name`` lives once built (hash of sources + flags)."""
    kind, sources = LIBS[name]
    h = hashlib.sha1(kind.encode())
    h.update(" ".join(NVCC_FLAGS if kind == "nvcc" else CXX_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith((".cuh", ".h")))
    for f in list(sources) + headers:
        with open(os.path.join(CSRC, f), "rb") as fh:
            h.update(f.encode() + b"\0" + fh.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def _start(name: str):
    """Start the compiler for ``name``; None when it is already built."""
    out = library_path(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    kind, sources = LIBS[name]
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [_compiler(kind)]
    cmd += NVCC_FLAGS if kind == "nvcc" else CXX_FLAGS
    cmd += ["-I", CSRC, "-o", tmp] + [os.path.join(CSRC, s) for s in sources]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    return proc, tmp, out, cmd


def build(*names: str) -> List[str]:
    """Build the named libraries (all when none are named), one compiler
    process each, all started together.  Returns the library paths."""
    names = names or tuple(LIBS)
    jobs = [(n, _start(n)) for n in names]
    for name, job in jobs:
        if job is None:
            continue
        proc, tmp, out, cmd = job
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(
                f"building {name} failed ({' '.join(cmd)}):\n"
                f"{log.decode(errors='replace')}"
            )
        with open(out + ".log", "wb") as fh:
            fh.write(log)
        os.replace(tmp, out)
    return [library_path(n) for n in names]


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if it is missing."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = build(name)[0]
            lib = _loaded[name] = ctypes.CDLL(path)
        return lib


def check(rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a kernel's C entry."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")

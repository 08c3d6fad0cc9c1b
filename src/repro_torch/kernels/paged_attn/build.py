"""Build and load the paged attention kernel.

``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
-fPIC`` compiles ``csrc/paged_attn.cu`` into ``build/kernels/`` at the
root of the checkout (listed in ``.gitignore``) on first use; the shared
library has a plain C interface and is loaded with ``ctypes``. The file
name carries a hash of the source, so an edited kernel is rebuilt and a
stale library is never loaded. Nothing is built at import time: the CPU
tests import every module of the port on machines without ``nvcc``."""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

SOURCE = Path(__file__).resolve().parent / "csrc" / "paged_attn.cu"
BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIB: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the paged attention kernel is "
                       "built from source on a machine with the CUDA "
                       "toolkit")


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"libpaged_attn_{digest}.so"


def build() -> Path:
    """Compile the kernel if its library is missing; returns its path.
    The compiler's register / shared-memory report (``-Xptxas -v``) is
    written beside the library as ``.log``."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")
    os.replace(tmp, lib)
    return lib


def load() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.paged_attn_fwd.argtypes = [vp, vp, vp, vp, vp, vp,
                                       ci, ci, ci, ci, ci, ci, ci, ci, ci,
                                       vp]
        lib.paged_attn_fwd.restype = ci
        lib.paged_attn_smem_bytes.argtypes = [ci, ci]
        lib.paged_attn_smem_bytes.restype = ci
        lib.paged_attn_error_string.argtypes = [ci]
        lib.paged_attn_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB

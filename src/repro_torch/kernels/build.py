"""Build and load the port's CUDA kernels: one nvcc recipe for all of them.

``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
-fPIC`` compiles each kernel's ``csrc/*.cu`` into its own shared library
under ``build/kernels/`` at the root of the checkout (listed in
``.gitignore``) on first use. A library has a plain C interface and is
loaded with ``ctypes``. Device code shared by the kernels lies in
``csrc/`` beside this file, which is on the include path. A library's
file name carries a hash of its source and of the shared headers, so an
edited kernel is rebuilt and a stale library is never loaded.
:func:`build` starts one nvcc per missing library, all at once, and
waits for them together. Nothing is built at import time: the CPU tests
import every module of the port on machines without ``nvcc``."""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
COMMON_DIR = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              f"-I{COMMON_DIR}"]

_LOADED: Dict[Path, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the port's kernels are built from "
                       "source on a machine with the CUDA toolkit")


def library_path(source: Path) -> Path:
    h = hashlib.sha256(source.read_bytes())
    for header in sorted(COMMON_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    digest = h.hexdigest()[:12]
    return BUILD_DIR / f"lib{source.stem}_{digest}.so"


def build(*sources: Path) -> List[Path]:
    """Compile every source whose library is missing, one nvcc process
    each, all started together; returns the libraries' paths in the
    order given. The compiler's register / shared-memory report
    (``-Xptxas -v``) is written beside each library as ``.log``. Raises
    if any compile fails."""
    libs = [library_path(s) for s in sources]
    todo = [(s, lib) for s, lib in zip(sources, libs) if not lib.exists()]
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = []
        for src, lib in todo:
            tmp = lib.with_suffix(f".{os.getpid()}.tmp")
            procs.append((lib, tmp, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        failed = []
        for lib, tmp, proc in procs:
            out, err = proc.communicate()
            lib.with_suffix(".log").write_text(out + err)
            if proc.returncode != 0:
                failed.append(f"{lib.name}: nvcc failed ({proc.returncode}):"
                              f"\n{err[-4000:]}")
            else:
                os.replace(tmp, lib)
        if failed:
            raise RuntimeError("\n".join(failed))
    return libs


def load(source: Path) -> ctypes.CDLL:
    """The loaded library of ``source`` (built on first call)."""
    lib = build(source)[0]
    if lib not in _LOADED:
        _LOADED[lib] = ctypes.CDLL(str(lib))
    return _LOADED[lib]

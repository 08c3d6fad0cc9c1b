"""Load the paged attention kernel (``csrc/paged_attn.cu``) through the
port's shared nvcc recipe (:mod:`repro_torch.kernels.build`) and declare
its C interface to ``ctypes``."""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

from repro_torch.kernels import build as kernel_build

SOURCE = Path(__file__).resolve().parent / "csrc" / "paged_attn.cu"

_LIB: Optional[ctypes.CDLL] = None


def load() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIB
    if _LIB is None:
        lib = kernel_build.load(SOURCE)
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

"""Wrapper of the contiguous decode kernel.

A CUDA tensor goes to the hand-written kernel (``csrc/decode_attn.cu``)
or the call raises; a CPU tensor goes to the plain version (``ref.py``).
There is no fallback from one to the other. ``LAUNCHES`` counts kernel
launches and ``PLAIN`` calls of the plain version, so a run can show
which one served it.
"""
from __future__ import annotations

import operator
from typing import Dict

import torch

from repro_torch.kernels.decode_attn import build
from repro_torch.kernels.decode_attn.ref import decode_attn_ref

LAUNCHES: Dict[str, int] = {"decode": 0}
PLAIN: Dict[str, int] = {"decode": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)


def reset_counts() -> None:
    for d in (LAUNCHES, PLAIN):
        for key in d:
            d[key] = 0


def tile_s() -> int:
    """Cache slots the kernel walks per shared-memory tile (its S tile)."""
    return build.load().decode_attn_tile_s()


def decode_attn(q, k, v, pos: int, *, window: int = 0, ring: bool = False):
    """One-token GQA flash decode: q (B, H, hd) against the contiguous
    cache k, v (B, S, KV, hd) at the scalar position ``pos``, a host int
    (see ``ref.decode_attn_ref`` for the slot semantics). Returns
    (B, H, hd) fp32."""
    if isinstance(pos, torch.Tensor):
        raise TypeError("decode attention: pos must be a host int")
    pos = operator.index(pos)
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"decode attention: q (B, H, hd) and k, v "
                         f"(B, S, KV, hd) of one shape, got q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}")
    B, H, hd = q.shape
    Bk, S, KV, hd_k = k.shape
    if Bk != B or hd_k != hd or H % KV:
        raise ValueError(f"decode attention: unsupported shapes q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)} (same rows "
                         "and head dim, H a multiple of KV)")
    if pos < 0 or window < 0 or (not ring and pos >= S):
        raise ValueError(f"decode attention: position {pos} (window "
                         f"{window}, ring {ring}) outside a cache of {S} "
                         "slots")
    tensors = (q, k, v)
    if all(t.device.type == "cpu" for t in tensors):
        PLAIN["decode"] += 1
        return decode_attn_ref(q, k, v, pos, window=window, ring=ring)
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError("decode attention: all operands must be on one "
                         "CUDA device (or all on the CPU)")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"decode attention takes bf16 or fp32 q, k, v of "
                         f"one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if hd not in _HEAD_DIMS:
        raise ValueError(f"decode attention: head dim {hd} has no kernel "
                         f"(have {_HEAD_DIMS})")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("decode attention: operands must be contiguous")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("decode attention: q, k and v must be 16-byte "
                         "aligned")
    lib = build.load()
    out = torch.empty((B, H, hd), dtype=torch.float32, device=q.device)
    if B == 0:
        return out
    rc = lib.decode_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, S, H, KV, hd, pos, window, int(ring), _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("decode attention launch failed: "
                           + lib.decode_attn_error_string(rc).decode())
    LAUNCHES["decode"] += 1
    return out

"""Wrapper of the paged attention kernel.

A CUDA tensor goes to the hand-written kernel (``csrc/paged_attn.cu``) or
the call raises; a CPU tensor goes to the plain version (``ref.py``).
There is no fallback from one to the other. ``LAUNCHES`` counts kernel
launches and ``PLAIN`` calls of the plain version, each by mode (decode /
chunk prefill), so a run can show which one served it.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels.paged_attn import build
from repro_torch.kernels.paged_attn.ref import paged_attn_ref

LAUNCHES: Dict[str, int] = {"decode": 0, "prefill": 0}
PLAIN: Dict[str, int] = {"decode": 0, "prefill": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
_SMEM_LIMIT = 232448          # bytes of shared memory a block may use (H100)


def reset_counts() -> None:
    for d in (LAUNCHES, PLAIN):
        for key in d:
            d[key] = 0


def paged_decode_attn(q, k_pages, v_pages, block_tables, pos):
    """One-token paged GQA decode: q (B, H, hd) at per-row positions
    pos (B,) against the page pools (P, ps, KV, hd) through block tables
    (B, MP). Returns (B, H, hd) fp32."""
    return _paged_attn(q[:, None], k_pages, v_pages, block_tables, pos,
                       "decode")[:, 0]


def paged_prefill_attn(q, k_pages, v_pages, block_tables, pos0):
    """Paged GQA chunk prefill: q (B, C, H, hd), chunk token c of row b at
    pos0[b] + c attends causally over the row's pages. Returns
    (B, C, H, hd) fp32."""
    return _paged_attn(q, k_pages, v_pages, block_tables, pos0, "prefill")


def _paged_attn(q, k_pages, v_pages, block_tables, pos0, kind: str):
    tensors = (q, k_pages, v_pages, block_tables, pos0)
    if all(t.device.type == "cpu" for t in tensors):
        PLAIN[kind] += 1
        return paged_attn_ref(q, k_pages, v_pages, block_tables, pos0)
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError("paged attention: all operands must be on one "
                         "CUDA device (or all on the CPU)")
    B, C, H, hd = q.shape
    P, ps, KV, hd_k = k_pages.shape
    MP = block_tables.shape[-1]
    if q.dtype not in _DTYPES or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise ValueError(f"paged attention takes bf16 or fp32 q and pages "
                         f"of one dtype, got {q.dtype}, {k_pages.dtype}, "
                         f"{v_pages.dtype}")
    if hd not in _HEAD_DIMS or hd_k != hd or v_pages.shape != k_pages.shape \
            or H % KV:
        raise ValueError(f"paged attention: unsupported shapes q "
                         f"{tuple(q.shape)}, pages {tuple(k_pages.shape)} "
                         f"(head dim 64 or 128, H a multiple of KV)")
    if block_tables.dtype != torch.int32 or pos0.dtype != torch.int32 \
            or tuple(block_tables.shape) != (B, MP) \
            or tuple(pos0.shape) != (B,):
        raise ValueError("paged attention: block_tables (B, MP) and pos0 "
                         "(B,) must be int32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged attention: operands must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k_pages, v_pages)):
        raise ValueError("paged attention: q and pages must be 16-byte "
                         "aligned")
    lib = build.load()
    if lib.paged_attn_smem_bytes(hd, ps) > _SMEM_LIMIT:
        raise ValueError(f"paged attention: page size {ps} needs more "
                         "shared memory than a block may use")
    out = torch.empty((B, C, H, hd), dtype=torch.float32, device=q.device)
    if B == 0 or C == 0:
        return out
    rc = lib.paged_attn_fwd(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), pos0.data_ptr(), out.data_ptr(),
        B, C, H, KV, hd, P, ps, MP, _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("paged attention launch failed: "
                           + lib.paged_attn_error_string(rc).decode())
    LAUNCHES[kind] += 1
    return out

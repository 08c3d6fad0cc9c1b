"""Plain PyTorch version of the contiguous decode kernel: the same
function as the JAX package's oracle ``decode_attn_ref``
(``repro/kernels/decode_attn/ref.py``)."""
from __future__ import annotations

import torch

NEG_INF = -2.0 ** 30


def slot_valid(S: int, pos: int, window: int, ring: bool, device):
    """(S,) bool: which cache slots the token at ``pos`` attends to. A
    ring cache's slot s holds the largest position p <= pos with
    p = s (mod S); otherwise slot s holds position s."""
    slots = torch.arange(S, device=device)
    kv_pos = pos - torch.remainder(pos - slots, S) if ring else slots
    valid = (kv_pos >= 0) & (kv_pos <= pos)
    if window > 0:
        valid &= (pos - kv_pos) < window
    return valid


def decode_attn_ref(q, k, v, pos: int, *, window: int = 0,
                    ring: bool = False):
    """One-token GQA decode attention. q: (B, H, hd), the current token's
    query (already rope'd); k, v: (B, S, KV, hd), the cache with the
    current token's K/V already written; pos: the current token's
    absolute position (a host int); window: sliding window (0 = global);
    ring: the cache is a ring buffer. Returns (B, H, hd) fp32."""
    B, S, KV, hd = k.shape
    H = q.shape[1]
    G = H // KV
    valid = slot_valid(S, pos, window, ring, k.device)
    qr = q.reshape(B, KV, G, hd).float()
    scores = torch.einsum("bkgh,bskh->bkgs", qr, k.float()) * (hd ** -0.5)
    scores = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskh->bkgh", probs, v.float())
    return out.reshape(B, H, hd)

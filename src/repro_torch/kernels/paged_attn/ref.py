"""Plain PyTorch version of the paged attention kernel: gather the row's
pages into its logical sequence, mask, softmax in fp32. The same
function as the JAX package's oracles ``paged_decode_attn_ref`` and
``paged_prefill_attn_ref`` (``repro/kernels/decode_attn/ref.py``)."""
from __future__ import annotations

import torch

NEG_INF = -2.0 ** 30


def paged_attn_ref(q, k_pages, v_pages, block_tables, pos0):
    """q: (B, C, H, hd) chunk queries (already rope'd; C = 1 is decode);
    k_pages, v_pages: (P, ps, KV, hd) page pools; block_tables: (B, MP)
    physical page of each logical page (entries past a row's position may
    alias a trash page); pos0: (B,) absolute position of each row's first
    query token. Query token c sits at pos0 + c and attends to
    ``kv_pos <= pos0 + c``. Returns (B, C, H, hd) fp32."""
    B, C, H, hd = q.shape
    _, ps, KV, _ = k_pages.shape
    MP = block_tables.shape[1]
    G = H // KV
    bt = block_tables.long()
    k = k_pages[bt].reshape(B, MP * ps, KV, hd).float()
    v = v_pages[bt].reshape(B, MP * ps, KV, hd).float()
    kv_pos = torch.arange(MP * ps, device=q.device)
    qpos = pos0.long()[:, None] + torch.arange(C, device=q.device)[None, :]
    valid = kv_pos[None, None, :] <= qpos[:, :, None]            # (B, C, S)
    qr = q.reshape(B, C, KV, G, hd).float()
    scores = torch.einsum("bckgh,bskh->bckgs", qr, k) * (hd ** -0.5)
    scores = torch.where(valid[:, :, None, None, :], scores,
                         torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bckgs,bskh->bckgh", probs, v)
    return out.reshape(B, C, H, hd)

"""GQA global attention: contiguous prefill and decode, and the paged
chunk-prefill / decode paths.

Layouts (as in the JAX package)
-------------------------------
hidden     x : (B, S, d)
query      q : (B, S, H, hd)
key/value    : (B, S, KV, hd)
contiguous cache : (L, B, S_max, KV, hd), written at absolute position
paged pool       : (L, P + 1, ps, KV, hd); page P is the trash page

Caches are stacked over layers; each function takes one layer's slice
(a view) and writes it in place, which keeps one pool allocation for the
whole run instead of a functional copy per step. Softmax math is fp32;
inputs and outputs stay in the model dtype.

Contiguous decode attention goes through ``kernels/decode_attn`` and
paged attention through ``kernels/paged_attn``: a CUDA tensor is served
by the hand-written kernel, a CPU tensor by its plain version. The
wrappers' counters (``LAUNCHES`` / ``PLAIN`` of each ``ops`` module) say
which one ran.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.decode_attn import ops as decode_ops
from repro_torch.kernels.paged_attn import ops as paged_ops
from repro_torch.models.rope import apply_rope

NEG_INF = -2.0 ** 30  # large-but-finite; avoids NaN from inf-inf in padding rows


def _project_qkv(p, x, num_heads, num_kv_heads, head_dim):
    B, S, _ = x.shape
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, num_heads, head_dim)
    k = k.reshape(B, S, num_kv_heads, head_dim)
    v = v.reshape(B, S, num_kv_heads, head_dim)
    return q, k, v


def _attend(q, k, v, mask):
    """Masked softmax attention. q: (B, Sq, KV, G, hd); k, v:
    (B, Sk, KV, hd); mask broadcastable to (B, KV, G, Sq, Sk). Returns
    (B, Sq, KV, G, hd) in v's dtype."""
    hd = q.shape[-1]
    scores = torch.einsum("bqkgh,bskh->bkgqs", q.float(), k.float())
    scores = scores * (hd ** -0.5)
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bkgqs,bskh->bqkgh", probs.to(v.dtype), v)


# ------------------------------------------------------------------ caches

def init_full_cache(num_layers: int, batch: int, max_seq: int,
                    num_kv_heads: int, head_dim: int, dtype, device):
    shp = (num_layers, batch, max_seq, num_kv_heads, head_dim)
    return {"k": torch.zeros(shp, dtype=dtype, device=device),
            "v": torch.zeros(shp, dtype=dtype, device=device)}


def init_paged_kv(num_layers: int, num_pages: int, page_size: int,
                  num_kv_heads: int, head_dim: int, dtype, device):
    """Layer-stacked page pool: physical page p of every layer holds
    ``page_size`` contiguous token slots of whichever row owns it. The
    caller reserves one extra *trash* page (the last physical index) that
    unowned block-table entries alias; writes to it are garbage, reads
    from it are always masked. Zero-initialized, so a masked slot never
    holds a non-finite value."""
    return init_full_cache(num_layers, num_pages, page_size, num_kv_heads,
                           head_dim, dtype, device)


# ---------------------------------------------------------------- prefill

def attn_prefill(p, x, positions, k_cache, v_cache, *, num_heads: int,
                 num_kv_heads: int, head_dim: int, rope_theta: float,
                 use_rope: bool):
    """Full causal attention over the prompt, writing its K/V into one
    layer's contiguous cache slice (B, S_max, KV, hd) in place.
    positions: (S,) absolute, shared across the batch. Returns y."""
    B, S, _ = x.shape
    G = num_heads // num_kv_heads
    q, k, v = _project_qkv(p, x, num_heads, num_kv_heads, head_dim)
    if use_rope:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    k_cache[:, :S] = k.to(k_cache.dtype)
    v_cache[:, :S] = v.to(v_cache.dtype)
    mask = positions[:, None] >= positions[None, :]            # (Sq, Sk)
    out = _attend(q.reshape(B, S, num_kv_heads, G, head_dim), k, v, mask)
    return out.reshape(B, S, num_heads * head_dim) @ p["wo"]


# ----------------------------------------------------------------- decode

def attn_decode(p, x, pos: int, k_cache, v_cache, *, num_heads: int,
                num_kv_heads: int, head_dim: int, rope_theta: float,
                use_rope: bool):
    """One-token decode against one layer's contiguous cache slice
    (B, S_max, KV, hd) at the scalar absolute position ``pos`` (a host
    int, shared by every row). Writes the token's K/V into slot ``pos``
    in place, attends over slots ``<= pos`` and applies ``wo``.
    x: (B, 1, d). Returns y (B, 1, d)."""
    B = x.shape[0]
    q, k, v = _project_qkv(p, x, num_heads, num_kv_heads, head_dim)
    if use_rope:
        positions = torch.full((1,), pos, dtype=torch.long, device=x.device)
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    k_cache[:, pos] = k[:, 0].to(k_cache.dtype)
    v_cache[:, pos] = v[:, 0].to(v_cache.dtype)
    out = decode_ops.decode_attn(q[:, 0], k_cache, v_cache, pos)
    return out.to(x.dtype).reshape(B, 1, num_heads * head_dim) @ p["wo"]


# ------------------------------------------------------------ paged paths

def attn_prefill_chunk_paged(p, x, pos0, k_pool, v_pool, block_tables,
                             chunk_pages, *, num_heads: int,
                             num_kv_heads: int, head_dim: int,
                             rope_theta: float, use_rope: bool):
    """Chunk prefill writing straight into allocator-owned pages.

    x: (B, C, d); pos0: (B,) int32; k_pool, v_pool: one layer's page pool
    (P + 1, ps, KV, hd), updated in place; block_tables: (B, MP) int32,
    the rows' tables (prompt pages so far, trash elsewhere); chunk_pages:
    (B, C) physical page of each chunk token. Validity is purely
    positional. Returns y (B, C, d)."""
    B, C, _ = x.shape
    q, k, v = _project_qkv(p, x, num_heads, num_kv_heads, head_dim)
    qpos = pos0.long()[:, None] + torch.arange(C, device=x.device)
    if use_rope:
        q = apply_rope(q, qpos, rope_theta)
        k = apply_rope(k, qpos, rope_theta)
    ps = k_pool.shape[1]
    off = qpos % ps
    cp = chunk_pages.long()
    k_pool[cp, off] = k.to(k_pool.dtype)
    v_pool[cp, off] = v.to(v_pool.dtype)
    out = paged_ops.paged_prefill_attn(q, k_pool, v_pool, block_tables,
                                       pos0)
    return out.to(x.dtype).reshape(B, C, num_heads * head_dim) @ p["wo"]


def attn_decode_paged(p, x, pos, k_pool, v_pool, block_tables,
                      write_pages=None, *, num_heads: int, num_kv_heads: int,
                      head_dim: int, rope_theta: float, use_rope: bool):
    """One-token decode against one layer's page pool.

    x: (B, 1, d); pos: (B,) int32 per-row positions; block_tables:
    (B, MP) int32 (unowned entries alias the trash page). The current
    token's K/V is written into ``write_pages`` ((B,) int32, certified
    refcount-1 by the scheduler's allocator) when given, else into the
    page the block table names at ``pos``. Returns y (B, 1, d)."""
    B = x.shape[0]
    q, k, v = _project_qkv(p, x, num_heads, num_kv_heads, head_dim)
    posl = pos.long()
    if use_rope:
        q = apply_rope(q, posl[:, None], rope_theta)
        k = apply_rope(k, posl[:, None], rope_theta)
    ps = k_pool.shape[1]
    if write_pages is None:
        phys = torch.gather(block_tables.long(), 1, (posl // ps)[:, None])[:, 0]
    else:
        phys = write_pages.long()
    off = posl % ps
    k_pool[phys, off] = k[:, 0].to(k_pool.dtype)
    v_pool[phys, off] = v[:, 0].to(v_pool.dtype)
    out = paged_ops.paged_decode_attn(q[:, 0], k_pool, v_pool, block_tables,
                                      pos)
    return out.to(x.dtype).reshape(B, 1, num_heads * head_dim) @ p["wo"]

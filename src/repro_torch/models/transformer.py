"""Model assembly for dense all-global-attention stacks (the
``deepseek-r1-distill-qwen-1.5b`` family).

Params (see :mod:`repro_torch.weights`)::

    {"embed": (V, d), "final_norm": (d,),
     "layers": [{"ln1", "ln2", "attn": {wq, wk, wv, wo[, bq, bk, bv]},
                 "ffn": {wg, wu, wd}}, ...]}

Caches are stacked over layers: ``{"k", "v"}`` of shape (L, B, S, KV, hd)
(contiguous) or (L, P + 1, ps, KV, hd) (paged). The functions update
them in place and return them, mirroring the JAX package's
``(logits, new_cache)`` signatures.

Public API:
    init_cache(cfg, batch, max_seq, device)                  -> cache
    init_paged_cache(cfg, num_pages, page_size, device)      -> pool
    prefill(params, cfg, tokens, cache)                      -> (logits, cache)
    prefill_chunk(params, cfg, tokens, pos0, cache, block_tables,
                  chunk_pages)                               -> (logits, cache)
    decode_step(params, cfg, token, pos, cache, block_tables=None,
                write_pages=None)                            -> (logits, cache)
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlp_lib
from repro_torch.models.layers import embed, rms_norm, unembed

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def check_supported(cfg: ModelConfig) -> None:
    """The port serves dense decoder-only stacks of global-attention
    layers; the other block families arrive with later slices."""
    if (set(cfg.block_types()) != {"global"} or cfg.is_moe
            or cfg.is_encoder_decoder or cfg.frontend
            or cfg.kv_cache_dtype != "model" or not cfg.tie_embeddings):
        raise ValueError(f"{cfg.name}: the port supports dense all-global "
                         "attention stacks with tied embeddings and a "
                         "model-dtype KV cache only")


def _attn_kw(cfg: ModelConfig):
    return dict(num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
                head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
                use_rope=cfg.use_rope)


def _embed_in(params, cfg: ModelConfig, tokens):
    return embed(tokens, params["embed"])


def _logits(params, cfg: ModelConfig, x):
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return unembed(x, params["embed"])


def _ffn(lp, cfg: ModelConfig, x):
    h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + mlp_lib.swiglu(lp["ffn"], h2)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device):
    check_supported(cfg)
    return attn.init_full_cache(cfg.num_layers, batch, max_seq,
                                cfg.num_kv_heads, cfg.resolved_head_dim,
                                DTYPES[cfg.dtype], device)


def init_paged_cache(cfg: ModelConfig, num_pages: int, page_size: int,
                     device):
    """Paged pool of every layer: (L, num_pages + 1, page_size, KV, hd);
    physical page ``num_pages`` is the shared trash page unowned
    block-table entries alias. One block table addresses every layer."""
    check_supported(cfg)
    return attn.init_paged_kv(cfg.num_layers, num_pages + 1, page_size,
                              cfg.num_kv_heads, cfg.resolved_head_dim,
                              DTYPES[cfg.dtype], device)


def prefill(params, cfg: ModelConfig, tokens, cache):
    """Process the prompt and fill the contiguous cache. tokens: (B, S).
    Returns (logits at the last position (B, V), cache)."""
    S = tokens.shape[1]
    x = _embed_in(params, cfg, tokens)
    positions = torch.arange(S, device=tokens.device)
    for i, lp in enumerate(params["layers"]):
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        x = x + attn.attn_prefill(lp["attn"], h, positions, cache["k"][i],
                                  cache["v"][i], **_attn_kw(cfg))
        x = _ffn(lp, cfg, x)
    return _logits(params, cfg, x[:, -1:])[:, 0], cache


def prefill_chunk(params, cfg: ModelConfig, tokens, pos0, cache,
                  block_tables, chunk_pages):
    """Advance the paged pool over one (B, C) prompt chunk whose first
    token sits at per-row position ``pos0`` ((B,) int32). Every layer
    writes the chunk's K/V straight into the allocator-owned pages
    ``chunk_pages`` ((B, C) int32) and attends through ``block_tables``
    ((B, MP) int32). Returns (last-position logits (B, V), cache)."""
    x = _embed_in(params, cfg, tokens)
    for i, lp in enumerate(params["layers"]):
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        x = x + attn.attn_prefill_chunk_paged(
            lp["attn"], h, pos0, cache["k"][i], cache["v"][i], block_tables,
            chunk_pages, **_attn_kw(cfg))
        x = _ffn(lp, cfg, x)
    return _logits(params, cfg, x[:, -1:])[:, 0], cache


def decode_step(params, cfg: ModelConfig, token, pos, cache,
                block_tables=None, write_pages=None):
    """One decode step. token: (B,) int.

    Without ``block_tables`` the step runs over the contiguous cache of
    :func:`init_cache` at the scalar absolute position ``pos`` (a host
    int, shared by every row), through the contiguous decode kernel.
    With ``block_tables`` ((B, MP) int32) it runs over the paged pool of
    :func:`init_paged_cache` at per-row positions ``pos`` ((B,) int32);
    ``write_pages`` ((B,) int32, optional) then pins each row's K/V write
    to an allocator-certified page. Returns (logits (B, V), cache)."""
    x = _embed_in(params, cfg, token[:, None])
    for i, lp in enumerate(params["layers"]):
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        if block_tables is None:
            y = attn.attn_decode(lp["attn"], h, pos, cache["k"][i],
                                 cache["v"][i], **_attn_kw(cfg))
        else:
            y = attn.attn_decode_paged(
                lp["attn"], h, pos, cache["k"][i], cache["v"][i],
                block_tables, write_pages, **_attn_kw(cfg))
        x = _ffn(lp, cfg, x + y)
    return _logits(params, cfg, x)[:, 0], cache

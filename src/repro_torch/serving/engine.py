"""Serving engine: the single-request decode loop for Greedy / BoN /
ST-BoN / KAPPA with bucketed cache compaction, and the fused decode step
of the paged scheduler.

One shared loop (``_decode_loop``) drives any
``repro_torch.serving.strategies.DecodeStrategy`` over a dedicated
contiguous branch cache:

  prefill(prompt, B=1) ─ broadcast cache to N ─▶ step* ─▶ compaction at
  power-of-two buckets as the strategy prunes ─▶ survivor decodes to EOS

Each step is one model step (its attention in the contiguous decode
kernel on the GPU), one sampling call and one host transfer
(``RequestState.sample_and_advance``). The position stays on the host.
The phases are marked as ``engine:*`` ranges for ``torch.profiler``.
The four ``generate_*`` functions bind a strategy to the loop.

``fused_decode_chunks`` advances the paged scheduler's whole decode pool
AND every PREFILLING request's next prompt chunk in one tick (DESIGN.md
§6): the chunks ride the tick's decode step instead of a separate pass.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.configs.base import KappaConfig, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import decode_step, init_cache, prefill, prefill_chunk
from repro_torch.serving import cache as cache_lib
from repro_torch.serving import strategies
from repro_torch.serving.strategies import GenResult


def fused_decode_chunks(params, cfg: ModelConfig, token, pos, pool,
                        block_tables, write_pages, chunks):
    """One decode step over the pool plus one prompt chunk per entry of
    ``chunks`` (a sequence of ``(tokens, pos0, block_table, pages)``
    operands). All parts touch disjoint pool pages: decode writes its
    rows' allocator-certified pages, each chunk its own refcount-1 prompt
    pages. Returns (pool logits, [chunk logits], pool)."""
    logits, pool = decode_step(params, cfg, token, pos, pool, block_tables,
                               write_pages)
    outs = []
    for chunk_tokens, chunk_pos0, chunk_bt, chunk_pages in chunks:
        clogits, pool = prefill_chunk(params, cfg, chunk_tokens, chunk_pos0,
                                      pool, chunk_bt, chunk_pages)
        outs.append(clogits)
    return logits, outs, pool


def _prefill_one(params, cfg: ModelConfig, prompt: np.ndarray, max_seq: int,
                 device):
    """Prefill one prompt into a batch-1 contiguous cache of ``max_seq``
    positions; returns (last-position logits (V,), cache)."""
    cache = init_cache(cfg, 1, max_seq, device)
    tokens = torch.as_tensor(np.array(prompt, np.int64), device=device)
    logits, cache = prefill(params, cfg, tokens[None], cache)
    return logits[0], cache


def _decode_loop(params, cfg: ModelConfig, kcfg: KappaConfig,
                 prompt: np.ndarray, rng, strategy: strategies.DecodeStrategy,
                 *, eos_id: int, bos_id: int = 0,
                 max_seq: Optional[int] = None, device=None) -> GenResult:
    """Drive one request to completion with a dedicated branch cache on
    ``device`` (default ``cuda``; ``params`` live there). ``rng`` is the
    request's key (:func:`repro_torch.serving.rng.prng_key`)."""
    device = resolve_device(device)
    max_seq = max_seq or (len(prompt) + kcfg.max_new_tokens)
    pf_logits, cache = _prefill_one(params, cfg, prompt, max_seq, device)
    rs = strategies.RequestState(
        strategy, params, cfg, kcfg, len(prompt), rng, eos_id=eos_id,
        bos_id=bos_id, max_seq=max_seq)
    if rs.n > 1:
        cache = cache_lib.broadcast_batch(cache, rs.n)
    rs.first_tokens(pf_logits)

    while not rs.finished:
        with record_function("engine:model_step"):
            token = torch.from_numpy(rs.cur.astype(np.int64)).to(device)
            logits, cache = decode_step(params, cfg, token, rs.pos, cache)
        with record_function("engine:sample_and_advance"):
            dec = rs.sample_and_advance(logits)
        if dec.keep is not None:
            with record_function("engine:compact"):
                cache = cache_lib.gather_batch(cache, dec.keep)
    return rs.result()


# --------------------------------------------------------- public methods

def generate_kappa(params, cfg: ModelConfig, kcfg: KappaConfig,
                   prompt: np.ndarray, rng, *, eos_id: int, bos_id: int = 0,
                   max_seq: Optional[int] = None, device=None) -> GenResult:
    return _decode_loop(params, cfg, kcfg, prompt, rng,
                        strategies.KappaStrategy(), eos_id=eos_id,
                        bos_id=bos_id, max_seq=max_seq, device=device)


def generate_greedy(params, cfg: ModelConfig, kcfg: KappaConfig,
                    prompt: np.ndarray, rng, *, eos_id: int, bos_id: int = 0,
                    max_seq: Optional[int] = None, device=None) -> GenResult:
    return _decode_loop(params, cfg, kcfg, prompt, rng,
                        strategies.GreedyStrategy(), eos_id=eos_id,
                        bos_id=bos_id, max_seq=max_seq, device=device)


def generate_bon(params, cfg: ModelConfig, kcfg: KappaConfig,
                 prompt: np.ndarray, rng, *, eos_id: int, bos_id: int = 0,
                 max_seq: Optional[int] = None, device=None) -> GenResult:
    return _decode_loop(params, cfg, kcfg, prompt, rng,
                        strategies.BoNStrategy(), eos_id=eos_id,
                        bos_id=bos_id, max_seq=max_seq, device=device)


def generate_stbon(params, cfg: ModelConfig, kcfg: KappaConfig,
                   prompt: np.ndarray, rng, *, eos_id: int, bos_id: int = 0,
                   buffer_window: int = 16, max_seq: Optional[int] = None,
                   device=None) -> GenResult:
    return _decode_loop(params, cfg, kcfg, prompt, rng,
                        strategies.STBoNStrategy(buffer_window=buffer_window),
                        eos_id=eos_id, bos_id=bos_id, max_seq=max_seq,
                        device=device)

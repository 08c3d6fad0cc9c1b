"""Serving engine pieces of the paged path.

``fused_decode_chunks`` advances the whole decode pool AND every
PREFILLING request's next prompt chunk in one scheduler tick (DESIGN.md
§6): the chunks ride the tick's decode step instead of a separate pass.
A standalone chunk step is ``repro_torch.models.prefill_chunk`` itself.
The single-request engine loop (``_decode_loop`` and the
``generate_*`` methods) is a later slice of the port.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models import decode_step, prefill_chunk


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

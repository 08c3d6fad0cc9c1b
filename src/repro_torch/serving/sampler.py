"""Sampling: temperature + top-k + top-p (paper §4.1: T=0.7, k=20,
p=0.95), with the JAX package's numbers.

Two batching regimes:
  * :func:`sample` — one RNG key for a whole (B, V) batch.
  * :func:`sample_rows` — one key *per row*, so one call samples every
    active request's rows in a scheduler tick and row i's token depends
    only on (keys[i], logits[i]).

Top-k keeps ties in index order (a stable sort), as ``jax.lax.top_k``
does; ``torch.topk`` does not promise that.
"""
from __future__ import annotations

import torch

from repro_torch.serving import rng as rng_lib

NEG_INF = -1e30


def _filtered_topk(logits, temperature: float, top_k: int, top_p: float):
    """(values, indices) of the top-k temperature-scaled logits, sorted
    descending, with the top-p tail set to NEG_INF."""
    l = logits.float() / temperature
    k = min(top_k, l.shape[-1]) if top_k > 0 else l.shape[-1]
    vals, idx = torch.sort(l, dim=-1, descending=True, stable=True)
    vals, idx = vals[..., :k], idx[..., :k]
    if 0.0 < top_p < 1.0:
        probs = torch.softmax(vals, dim=-1)
        csum = torch.cumsum(probs, dim=-1)
        # keep tokens whose *previous* cumulative mass < p (always the 1st)
        keep = (csum - probs) < top_p
        vals = torch.where(keep, vals, torch.full_like(vals, NEG_INF))
    return vals, idx


def sample(key, logits, *, temperature: float = 0.7, top_k: int = 20,
           top_p: float = 0.95):
    """logits: (B, V) → (B,) int64 tokens, one key (2,) for the batch
    (``jax.random.categorical`` over the whole (B, k) block).
    temperature <= 0 → greedy argmax."""
    if temperature <= 0:
        return torch.argmax(logits, dim=-1)
    vals, idx = _filtered_topk(logits, temperature, top_k, top_p)
    noise = rng_lib.gumbel(key.to(vals.device), vals.numel()).reshape(vals.shape)
    choice = torch.argmax(noise + vals, dim=-1)
    return torch.gather(idx, -1, choice[:, None])[:, 0]


def sample_rows(keys, logits, greedy_mask, kcfg):
    """Per-row-keyed sampling — one call for any mix of rows.

    keys: (R, 2) int64 key words (one key per row); logits: (R, V);
    greedy_mask: (R,) bool — True rows take argmax and ignore their key.
    Returns (R,) int64 tokens."""
    greedy = torch.argmax(logits, dim=-1)
    if kcfg.temperature <= 0:
        return greedy
    vals, idx = _filtered_topk(logits, kcfg.temperature, kcfg.top_k,
                               kcfg.top_p)
    choice = rng_lib.categorical(keys, vals)
    sampled = torch.gather(idx, -1, choice[:, None])[:, 0]
    return torch.where(greedy_mask, greedy, sampled)


def picked_logprob(logits, tokens):
    """(B,) log-prob of each row's picked token (fp32 softmax)."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    return torch.gather(lp, -1, tokens[:, None].long())[:, 0]

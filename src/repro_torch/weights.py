"""Parameters of the port: conversion from the JAX package's param tree
and seeded random initialization straight on the device.

The JAX tree (``repro/models/transformer.py:init_params``) stacks layers
by cycle: ``stack`` is a tuple with one entry per layer-pattern position,
each holding leaves with a leading cycle axis K; ``rem`` holds the
L mod len(pattern) remainder layers. Layer ``i < K * len(pattern)`` is
``stack[i % P]`` at cycle ``i // P``; the rest follow from ``rem``.
Matmul weights are (d_in, d_out) (``x @ W``), norm scales start at 0 and
are applied as ``1 + scale``, and the embedding is tied and reused as the
unembedding. The port keeps all of that and stores a plain list of
per-layer dicts.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.transformer import DTYPES, check_supported


def _tensor(a, device, dtype=None) -> torch.Tensor:
    t = torch.from_numpy(np.array(a, dtype=np.float32))
    return t.to(device=device, dtype=dtype or t.dtype)


def from_jax_params(tree: Dict[str, Any], cfg: ModelConfig,
                    device=None) -> Dict[str, Any]:
    """Convert a JAX param tree whose leaves are numpy arrays (e.g. from
    ``jax.device_get(params)``) into the port's params. Matmul weights and
    the embedding take ``cfg.dtype``; norm scales stay fp32."""
    check_supported(cfg)
    device = resolve_device(device)
    dtype = DTYPES[cfg.dtype]
    P = len(cfg.layer_pattern)
    K = cfg.num_layers // P

    def layer(j, c=None):
        src = tree["stack"][j] if c is not None else tree["rem"][j]
        pick = (lambda a: np.asarray(a)[c]) if c is not None \
            else (lambda a: np.asarray(a))
        return {
            "ln1": _tensor(pick(src["ln1"]), device),
            "ln2": _tensor(pick(src["ln2"]), device),
            "attn": {k: _tensor(pick(v), device, dtype)
                     for k, v in src["attn"].items()},
            "ffn": {k: _tensor(pick(v), device, dtype)
                    for k, v in src["ffn"].items()},
        }

    layers = [layer(i % P, i // P) for i in range(K * P)]
    layers += [layer(r) for r in range(len(tree["rem"]))]
    return {"embed": _tensor(tree["embed"], device, dtype),
            "final_norm": _tensor(tree["final_norm"], device),
            "layers": layers}


def init_params(cfg: ModelConfig, seed: int, device=None) -> Dict[str, Any]:
    """Random full-width weights built directly on ``device`` from one
    seed: truncated-normal fan-in matmul weights (embedding at scale
    0.02), zero biases and norm scales — the JAX package's init scheme,
    drawn from a ``torch.Generator`` (so not the JAX package's numbers)."""
    check_supported(cfg)
    device = resolve_device(device)
    dtype = DTYPES[cfg.dtype]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    d, hd = cfg.d_model, cfg.resolved_head_dim
    H, KV = cfg.num_heads, cfg.num_kv_heads

    def dense(shape, scale=None):
        scale = 1.0 / math.sqrt(shape[0]) if scale is None else scale
        w = torch.empty(shape, dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
        return (w * scale).to(dtype)

    def zeros(n, dt=torch.float32):
        return torch.zeros((n,), dtype=dt, device=device)

    layers = []
    for _ in range(cfg.num_layers):
        a = {"wq": dense((d, H * hd)), "wk": dense((d, KV * hd)),
             "wv": dense((d, KV * hd)), "wo": dense((H * hd, d))}
        if cfg.qkv_bias:
            a.update(bq=zeros(H * hd, dtype), bk=zeros(KV * hd, dtype),
                     bv=zeros(KV * hd, dtype))
        layers.append({"ln1": zeros(d), "ln2": zeros(d), "attn": a,
                       "ffn": {"wg": dense((d, cfg.d_ff)),
                               "wu": dense((d, cfg.d_ff)),
                               "wd": dense((cfg.d_ff, d))}})
    return {"embed": dense((cfg.vocab_size, d), scale=0.02),
            "final_norm": zeros(d), "layers": layers}

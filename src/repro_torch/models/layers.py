"""Basic layers: RMSNorm, embedding, tied logits head."""
from __future__ import annotations

import torch


def rms_norm(x, scale, eps: float = 1e-6):
    """RMSNorm in fp32 math, cast back to the input dtype. ``scale``
    starts at 0 and is applied as ``1 + scale``."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def embed(tokens, table):
    return table[tokens]


def unembed(x, table):
    """Project hidden states to vocabulary logits. table: (V, d)."""
    return (x @ table.transpose(0, 1)).float()

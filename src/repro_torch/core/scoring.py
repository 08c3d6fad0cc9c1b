"""Cross-branch normalization and score aggregation (Alg. 2 lines 19–21)."""
from __future__ import annotations

import torch

EPS = 1e-9


def masked_zscore(x, alive, clip: float = 3.0):
    """z-score x across *alive* branches only, clamped to ±clip.
    x, alive: (..., N) — the branch axis is last, leading axes batch
    independently. Dead entries are returned as 0."""
    aw = alive.float()
    n = torch.clamp(torch.sum(aw, dim=-1, keepdim=True), min=1.0)
    mu = torch.sum(x * aw, dim=-1, keepdim=True) / n
    var = torch.sum(torch.square(x - mu) * aw, dim=-1, keepdim=True) / n
    z = (x - mu) / (torch.sqrt(var) + EPS)
    return torch.clamp(z, -clip, clip) * aw


def aggregate(z_ema, z_conf, z_ent, w_kl: float, w_conf: float,
              w_ent: float):
    """Instantaneous score s_t (Alg. 2 line 20)."""
    return w_kl * z_ema + w_conf * z_conf + w_ent * z_ent


def trajectory_update(num, den, s, t_abs):
    """Running recency-weighted trajectory score S_t = Σ t′·s_{t′} / Σ t′
    (Alg. 2 line 21). num, s: (..., N); den, t_abs: (...). Returns
    (num, den, S)."""
    w = torch.clamp(t_abs.float(), min=1.0)
    num = num + w[..., None] * s
    den = den + w
    return num, den, num / torch.clamp(den, min=EPS)[..., None]

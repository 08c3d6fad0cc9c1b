"""Robustification of the ΔI signal (paper Alg. 2 lines 15–17):
median-of-means over a ring-buffered window, then bias-corrected EMA."""
from __future__ import annotations

import torch


def median_of_means(window, count, m: int):
    """MoM over the first ``count`` valid entries of ``window``.

    window: (..., N, w) ring-ordered values; count: (...) valid-entry
    count per leading index (≤ w); m: bucket count. The w slots split
    into m equal buckets; a bucket without valid entries takes the mean
    of all valid entries. The median of an even bucket count is the
    midpoint of the two middle means (as ``jnp.median``)."""
    w = window.shape[-1]
    if w % m:
        raise ValueError("window must divide evenly into MoM buckets")
    per = w // m
    idx = torch.arange(w, device=window.device)
    valid = (idx < count[..., None]).float()                # (..., w)
    vw = window * valid[..., None, :]
    bucket_sum = vw.reshape(*window.shape[:-1], m, per).sum(-1)
    bucket_n = valid.reshape(*valid.shape[:-1], m, per).sum(-1)  # (..., m)
    total_mean = vw.sum(-1) / torch.clamp(valid.sum(-1), min=1.0)[..., None]
    bucket_mean = torch.where(
        bucket_n[..., None, :] > 0,
        bucket_sum / torch.clamp(bucket_n, min=1.0)[..., None, :],
        total_mean[..., None])
    srt = torch.sort(bucket_mean, dim=-1).values
    lo, hi = (m - 1) // 2, m // 2
    return (srt[..., lo] + srt[..., hi]) * 0.5


def ema_update(ema_raw, x, alpha: float):
    """One uncorrected EMA step: m_t = α·x + (1−α)·m_{t−1}."""
    return alpha * x + (1.0 - alpha) * ema_raw


def ema_debias(ema_raw, step, alpha: float):
    """Bias-corrected read m̂_t = m_t / (1 − (1−α)^t), t ≥ 1. step: (...)
    per leading index of ema_raw (..., N)."""
    base = torch.tensor(1.0 - alpha, dtype=torch.float32,
                        device=ema_raw.device)
    corr = 1.0 - base ** torch.clamp(step, min=1).float()
    return ema_raw / corr[..., None]

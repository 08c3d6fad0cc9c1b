"""Pruning schedules: target survivor count R_t over the gating horizon.

Paper (Alg. 2 line 24): linear — R_t = N − ⌊(t−c+1)·N/τ⌋, clipped to ≥1,
reaching exactly 1 at the end of the horizon. Cosine is the paper's own
suggested less-aggressive extension (§4.2 / §5). ``step_in_horizon`` and
``horizon`` are int tensors of one shape (one entry per request slot).
"""
from __future__ import annotations

import math

import torch


def linear_survivors(n: int, step_in_horizon, horizon):
    u = step_in_horizon + 1
    r = n - torch.div(u * n, horizon, rounding_mode="floor")
    return torch.clamp(r, 1, n)


def cosine_survivors(n: int, step_in_horizon, horizon):
    u = (step_in_horizon + 1).float() / horizon
    r = torch.ceil(1.0 + (n - 1) * torch.cos(
        math.pi / 2.0 * torch.clamp(u, 0.0, 1.0)))
    return torch.clamp(r.int(), 1, n)


def step_survivors(n: int, step_in_horizon, horizon, n_stages: int = 4):
    """Piecewise-constant halving schedule (beyond-paper ablation)."""
    u = (step_in_horizon + 1).float() / horizon
    stage = torch.floor(u * n_stages)
    r = torch.floor(n * (0.5 ** stage))
    last = (step_in_horizon + 1) >= horizon
    return torch.where(last, torch.ones_like(step_in_horizon),
                       torch.clamp(r.int(), 1, n))


def survivors(kind: str, n: int, step_in_horizon, horizon):
    if kind == "linear":
        return linear_survivors(n, step_in_horizon, horizon)
    if kind == "cosine":
        return cosine_survivors(n, step_in_horizon, horizon)
    if kind == "step":
        return step_survivors(n, step_in_horizon, horizon)
    raise ValueError(f"unknown schedule {kind!r}")

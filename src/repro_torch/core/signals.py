"""Latent informativeness signals (paper §3, Alg. 2 lines 13–18), the
pure path the controller runs:

  D_t  = D_KL(p_t ‖ q)      — divergence from the unconditional reference
  C_t  = max_v p_t(v)       — confidence
  H_t  = −Σ p log(p + ε)    — entropy (ε inside the log, as the JAX
                              package's controller oracle has it)
"""
from __future__ import annotations

import torch

EPS = 1e-9


def log_softmax(logits):
    return torch.log_softmax(logits.float(), dim=-1)


def reference_log_q(ref_logits):
    """Unconditional reference distribution q from the BOS-only forward
    pass (Alg. 2 line 9). ref_logits: (V,) or (1, V)."""
    return log_softmax(ref_logits).reshape(-1)


def kl_to_reference(log_p, log_q):
    """D_KL(p ‖ q) = Σ p (log p − log q). log_p: (..., V); log_q: (V,)."""
    p = torch.exp(log_p)
    return torch.sum(p * (log_p - log_q), dim=-1)


def confidence(log_p):
    return torch.exp(torch.max(log_p, dim=-1).values)


def entropy(log_p):
    p = torch.exp(log_p)
    return -torch.sum(p * torch.log(p + EPS), dim=-1)


def compute_signals(logits, log_q):
    """logits: (..., V); log_q: (V,) fp32. All reductions are over the
    last axis, so leading axes (branches, pooled request slots) batch
    independently. Returns (kl, conf, ent), each logits.shape[:-1] fp32."""
    log_p = log_softmax(logits)
    return (kl_to_reference(log_p, log_q), confidence(log_p),
            entropy(log_p))

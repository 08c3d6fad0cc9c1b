"""Bit-exact PyTorch implementation of the slice of ``jax.random`` the
serving stack uses: ``PRNGKey``, ``split`` and the Gumbel-argmax
``categorical``, as jax 0.9.0 computes them with
``jax_threefry_partitionable=True`` (its default).

Without it sampled KAPPA could not be held against the JAX package token
for token. A key is a uint32 pair stored in an int64 tensor of shape
(..., 2), every word masked to 32 bits (torch has no uint32 arithmetic).
All functions work on any device.
"""
from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 with 20 rounds (jax's ``threefry2x32_p``): keys and
    counters are int64 tensors holding uint32 values, broadcast together.
    Returns the two uint32 output words."""
    ks = (k1, k2, (k1 ^ k2 ^ _PARITY) & MASK)
    x = [(x1 + ks[0]) & MASK, (x2 + ks[1]) & MASK]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & MASK
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & MASK
        x[1] = (x[1] + ks[(i + 2) % 3] + i + 1) & MASK
    return x[0], x[1]


def prng_key(seed: int, device="cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: (0, seed mod 2^32)."""
    if not -2 ** 31 <= seed < 2 ** 31:
        raise ValueError("seed must fit in 32 bits")
    return torch.tensor([0, seed & MASK], dtype=torch.int64, device=device)


def split(key, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: (num, 2) keys — threefry of the
    key over the 64-bit counters 0..num-1 (hi word 0, lo word i)."""
    counts = torch.arange(num, dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32(key[0], key[1], torch.zeros_like(counts), counts)
    return torch.stack([b1, b2], dim=-1)


def random_bits(keys, n: int):
    """32-bit random words of shape (..., n): row i of ``keys`` (..., 2)
    draws ``jax.random.bits(keys[i], (n,))`` (partitionable threefry:
    counter j → word1 ^ word2)."""
    counts = torch.arange(n, dtype=torch.int64, device=keys.device)
    b1, b2 = threefry2x32(keys[..., 0:1], keys[..., 1:2],
                          torch.zeros_like(counts), counts)
    return b1 ^ b2


def uniform_tiny(keys, n: int):
    """``jax.random.uniform(key, (n,), minval=finfo(f32).tiny, maxval=1)``
    per row of ``keys``: the top 23 bits become the mantissa of a float
    in [1, 2), minus 1, floored at ``tiny``."""
    bits = (random_bits(keys, n) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    tiny = torch.finfo(torch.float32).tiny
    return torch.clamp(floats * (1.0 - tiny) + tiny, min=tiny)


def gumbel(keys, n: int):
    """``jax.random.gumbel(key, (n,))`` (mode "low") per row of ``keys``."""
    return -torch.log(-torch.log(uniform_tiny(keys, n)))


def categorical(keys, logits):
    """``jax.random.categorical(key, logits)`` per row: logits (..., k)
    with keys (..., 2); argmax of Gumbel noise plus logits."""
    return torch.argmax(gumbel(keys, logits.shape[-1]) + logits, dim=-1)

"""Synthetic multi-step arithmetic chain-of-thought task.

A problem is a left-associative chain  v0 op1 v1 op2 v2 … opK vK (mod 97).
The reference chain-of-thought emits every intermediate partial result:

  prompt:  BOS P v0 op1 v1 … opK vK = ?
  target:  ARROW r1 ARROW r2 … ARROW rK ANS rK EOS

Answer correctness = the value token after ANS matches the ground truth.
This gives a GSM8K-like shape: multi-step reasoning where sampled
branches genuinely diverge in quality, so BoN/ST-BoN/KAPPA comparisons
are meaningful at toy scale (DESIGN.md §11).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from repro_torch.data import tokenizer as tok


@dataclass(frozen=True)
class Problem:
    prompt: List[int]
    target: List[int]     # CoT + answer + EOS
    answer: int


_OPS = [tok.PLUS, tok.MINUS, tok.TIMES]


def _apply(op: int, a: int, b: int) -> int:
    if op == tok.PLUS:
        return (a + b) % tok.MOD
    if op == tok.MINUS:
        return (a - b) % tok.MOD
    return (a * b) % tok.MOD


def make_problem(rng: np.random.Generator, min_steps: int = 2,
                 max_steps: int = 6, num_ops: int = 3,
                 max_val: int = tok.MOD, max_operand: int = 0) -> Problem:
    """num_ops: 2 → {+,−} only (easier); 3 adds × (mod-97 mult is the
    hard regime). max_val bounds the initial value; max_operand > 0
    bounds the chained operands (small per-step fact table → learnable
    by the toy models while errors still compound over steps)."""
    k = int(rng.integers(min_steps, max_steps + 1))
    v0 = int(rng.integers(0, max_val))
    op_hi = max_operand if max_operand > 0 else max_val
    vals = [v0] + rng.integers(0, op_hi, size=k).tolist()
    ops = [int(_OPS[i]) for i in rng.integers(0, num_ops, size=k)]

    prompt = [tok.BOS, tok.PROB, vals[0]]
    for op, v in zip(ops, vals[1:]):
        prompt += [op, v]
    prompt += [tok.EQ, tok.QM]

    target: List[int] = []
    acc = vals[0]
    for op, v in zip(ops, vals[1:]):
        acc = _apply(op, acc, v)
        target += [tok.ARROW, acc]
    target += [tok.ANS, acc, tok.EOS]
    return Problem(prompt=prompt, target=target, answer=acc)


def make_dataset(seed: int, n: int, **kw) -> List[Problem]:
    rng = np.random.default_rng(seed)
    return [make_problem(rng, **kw) for _ in range(n)]


def pack_batch(problems: List[Problem], max_len: int
               ) -> Tuple[np.ndarray, np.ndarray]:
    """(tokens, loss_mask): next-token LM batch; loss only on target span."""
    B = len(problems)
    toks = np.full((B, max_len), tok.PAD, np.int32)
    mask = np.zeros((B, max_len), np.float32)
    for i, p in enumerate(problems):
        seq = (p.prompt + p.target)[:max_len]
        toks[i, :len(seq)] = seq
        lo = min(len(p.prompt), max_len)
        hi = min(len(seq), max_len)
        # loss predicts positions lo..hi-1 (from inputs lo-1..hi-2)
        mask[i, lo - 1:hi - 1] = 1.0
    return toks, mask


def check_answer(generated: List[int], problem: Problem) -> bool:
    return tok.extract_answer(generated) == problem.answer

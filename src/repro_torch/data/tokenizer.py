"""Toy deterministic tokenizer for the synthetic arithmetic CoT task.

Vocabulary (size 128):
  0..96   : value tokens (integers mod 97)
  97..99  : operators + - *
  100..107: structural tokens  = ? → ANS BOS EOS PAD P
"""
from __future__ import annotations

from typing import List

MOD = 97

PLUS, MINUS, TIMES = 97, 98, 99
EQ, QM, ARROW, ANS = 100, 101, 102, 103
BOS, EOS, PAD, PROB = 104, 105, 106, 107
VOCAB_SIZE = 128

_OP_CHARS = {PLUS: "+", MINUS: "-", TIMES: "*"}
_SPECIAL = {EQ: "=", QM: "?", ARROW: "→", ANS: "ANS", BOS: "<s>",
            EOS: "</s>", PAD: "<pad>", PROB: "P"}


def decode(ids: List[int]) -> str:
    out = []
    for t in ids:
        if 0 <= t < MOD:
            out.append(str(t))
        elif t in _OP_CHARS:
            out.append(_OP_CHARS[t])
        elif t in _SPECIAL:
            out.append(_SPECIAL[t])
        else:
            out.append(f"<{t}>")
    return " ".join(out)


def extract_answer(ids: List[int]) -> int | None:
    """Final answer = value token right after the last ANS marker."""
    ans_pos = [i for i, t in enumerate(ids) if t == ANS]
    if not ans_pos:
        return None
    i = ans_pos[-1]
    if i + 1 < len(ids) and 0 <= ids[i + 1] < MOD:
        return int(ids[i + 1])
    return None

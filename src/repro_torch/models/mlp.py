"""Feed-forward block: SwiGLU (LLaMA / Qwen family)."""
from __future__ import annotations

import torch.nn.functional as F


def swiglu(p, x):
    return (F.silu(x @ p["wg"]) * (x @ p["wu"])) @ p["wd"]

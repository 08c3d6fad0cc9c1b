"""Contiguous GQA flash decode for Hopper: one CUDA kernel
(``csrc/decode_attn.cu``) for one new token per row against a (B, S, KV,
hd) cache at a scalar position, its plain PyTorch version (``ref.py``)
and the wrapper that picks between them by device (``ops.py``)."""

"""Paged GQA attention for Hopper: one CUDA kernel (``csrc/paged_attn.cu``)
serving decode (C = 1) and chunk prefill (C tokens), its plain PyTorch
version (``ref.py``) and the wrapper that picks between them by device
(``ops.py``)."""

"""PyTorch/CUDA port of the KAPPA serving stack.

A second package beside the JAX reference (``repro``): it imports torch
and numpy only, never jax and nothing of ``repro``. Entry points run on
the GPU (``device="cuda"``) unless the caller passes another device; the
CPU is used only when asked for, as the parity tests do.
"""

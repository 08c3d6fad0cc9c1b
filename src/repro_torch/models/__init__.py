"""Model of the port: layers, RoPE, SwiGLU, GQA attention, assembly."""
from repro_torch.models.transformer import (  # noqa: F401
    decode_step,
    init_cache,
    init_paged_cache,
    prefill,
    prefill_chunk,
)

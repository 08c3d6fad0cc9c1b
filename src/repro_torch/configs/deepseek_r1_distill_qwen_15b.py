"""deepseek-r1-distill-qwen-1.5b — the paper's small evaluation model
(Qwen2.5-1.5B backbone). 28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936.  [hf:deepseek-ai/DeepSeek-R1-Distill-Qwen-1.5B]
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-r1-distill-qwen-1.5b",
        family="dense",
        num_layers=28,
        d_model=1536,
        num_heads=12,
        num_kv_heads=2,
        d_ff=8960,
        vocab_size=151_936,
        qkv_bias=True,
        layer_pattern=("global",),
        rope_theta=10_000.0,
        tie_embeddings=True,
        source="hf:deepseek-ai/DeepSeek-R1-Distill-Qwen-1.5B",
    )

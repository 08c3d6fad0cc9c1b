"""Configuration dataclasses of the PyTorch port: the port's own copies of
``ModelConfig`` (with ``reduced()``) and ``KappaConfig`` (defaults = the
paper's tuned values, §4.1). The fields and their meaning match the JAX
package's ``repro.configs.base`` field for field, so a config built on
either side describes the same model."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    """Static architecture description.

    ``layer_pattern`` is cycled over the layer stack and selects the
    block type per layer:
      "global"    — full-causal GQA attention
      "local"     — sliding-window GQA attention (window ``window_size``)
      "recurrent" — RG-LRU recurrent block (recurrentgemma)
      "rwkv6"     — RWKV-6 time-mix block (attention-free)
    """

    name: str
    family: str  # dense | moe | hybrid | ssm | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    layer_pattern: Tuple[str, ...] = ("global",)
    window_size: int = 4096
    # MoE
    num_experts: int = 0
    experts_per_tok: int = 0
    moe_capacity_factor: float = 1.25  # <=0 → dropless (exact) routing
    # "einsum": sort-based dispatch under plain pjit (XLA inserts the
    # collectives — measured pathological: full-activation all-reduce).
    # "expert_parallel": hand-written shard_map all-to-all dispatch
    # (§Perf hillclimb A); requires repro.models.moe.set_mesh(...).
    moe_impl: str = "einsum"
    # RoPE
    rope_theta: float = 10_000.0
    use_rope: bool = True
    # encoder-decoder (whisper)
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    encoder_seq_len: int = 1500  # whisper: 30 s of audio @ 50 Hz after conv
    # modality frontend stub: None | "audio" | "vision"
    frontend: Optional[str] = None
    frontend_tokens: int = 0  # patch/frame embeddings prepended by the stub
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    # unroll the layer stack instead of lax.scan — used by the dry-run so
    # cost_analysis sees every layer (XLA counts while bodies once)
    unroll: bool = False
    # int8-quantized KV cache (per token-head absmax scales): halves the
    # decode HBM traffic of the cache read (§Perf hillclimb B)
    kv_cache_dtype: str = "model"  # "model" (= cfg.dtype) | "int8"
    # Megatron-style sequence parallelism: activations shard seq-on-model
    # between blocks, turning the TP all-reduces into RS+AG (§Perf C)
    seq_parallel: bool = False
    # citation for the assigned config
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.num_heads

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def attention_free(self) -> bool:
        return all(p in ("rwkv6", "recurrent") for p in self.layer_pattern)

    @property
    def sub_quadratic(self) -> bool:
        """True if no layer keeps an unbounded full-attention KV cache."""
        return all(p in ("rwkv6", "recurrent", "local") for p in self.layer_pattern)

    def block_types(self) -> Tuple[str, ...]:
        """Per-layer block type, pattern cycled over num_layers."""
        p = self.layer_pattern
        return tuple(p[i % len(p)] for i in range(self.num_layers))

    def reduced(self, num_layers: int = 2, d_model: int = 256,
                num_experts: int = 4, vocab_size: int = 512) -> "ModelConfig":
        """Smoke-test variant of the same family (<=2 layers, d_model<=512,
        <=4 experts) — runs a real forward/train step on CPU."""
        heads = max(2, min(4, self.num_heads))
        kv = max(1, min(heads, self.num_kv_heads if self.num_kv_heads else heads))
        # keep the GQA-ness: if original had kv < heads, keep ratio >= 2
        if self.num_kv_heads and self.num_kv_heads < self.num_heads:
            kv = max(1, heads // 2)
        enc_layers = min(self.encoder_layers, num_layers) if self.is_encoder_decoder else 0
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            num_layers=num_layers,
            d_model=d_model,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=None,
            d_ff=d_model * 2,
            vocab_size=vocab_size,
            num_experts=min(self.num_experts, num_experts) if self.is_moe else 0,
            experts_per_tok=min(self.experts_per_tok, 2) if self.is_moe else 0,
            moe_capacity_factor=0.0,  # dropless → prefill+decode ≡ train exactly
            window_size=64,
            encoder_layers=enc_layers,
            encoder_seq_len=16,
            frontend_tokens=16 if self.frontend else 0,
            dtype="float32",
        )

    def param_count(self) -> int:
        """Analytic parameter count (for roofline MODEL_FLOPS = 6·N·D)."""
        d, hd = self.d_model, self.resolved_head_dim
        q = self.num_heads * hd
        kvd = self.num_kv_heads * hd
        attn = d * q + 2 * d * kvd + q * d  # Q,K,V,O
        if self.is_moe:
            ffn = self.num_experts * 3 * d * self.d_ff + d * self.num_experts  # experts + router
        else:
            ffn = 3 * d * self.d_ff  # SwiGLU
        per_layer = 0
        for bt in self.block_types():
            if bt in ("global", "local"):
                per_layer += attn + ffn + 2 * d
            elif bt == "recurrent":
                # RG-LRU block: in/out proj + gates (~4 d*d_rnn, d_rnn≈d) + ffn
                per_layer += 4 * d * d + ffn + 2 * d
            elif bt == "rwkv6":
                # time-mix (5 d*d + lora decays) + channel-mix (2 d*d_ff)
                per_layer += 5 * d * d + 2 * d * self.d_ff + 2 * d
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        enc = 0
        if self.is_encoder_decoder:
            # encoder layers (full attn, no GQA reduction assumed) + cross-attn in decoder
            enc = self.encoder_layers * (4 * d * d + 3 * d * self.d_ff + 2 * d)
            per_layer += self.num_layers * (2 * d * d + 2 * d * kvd)  # cross-attn
        return per_layer + emb + enc

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top-k experts count)."""
        if not self.is_moe:
            return self.param_count()
        d = self.d_model
        full = self.param_count()
        ffn_all = self.num_layers * self.num_experts * 3 * d * self.d_ff
        ffn_act = self.num_layers * self.experts_per_tok * 3 * d * self.d_ff
        return full - ffn_all + ffn_act


@dataclass(frozen=True)
class KappaConfig:
    """KAPPA hyperparameters — defaults are the paper's tuned values."""

    num_branches: int = 5          # N
    draft_cutoff: int = 8          # c (paper: earliest pairwise difference; we
                                   # support both fixed and adaptive — see core.kappa)
    adaptive_cutoff: bool = True   # ST-BoN-style earliest-pairwise-difference c
    max_cutoff: int = 64           # upper bound on adaptive c
    horizon: int = 32              # τ — pruning horizon
    window: int = 16               # w — MoM window
    mom_buckets: int = 4           # m
    ema_rate: float = 0.5          # α
    w_kl: float = 0.7
    w_conf: float = 0.2
    w_ent: float = 0.1
    schedule: str = "linear"       # linear | cosine | step  (paper: linear; cosine
                                   # is the paper's own suggested extension, §4.2)
    # adaptive pruning horizon (paper §5 future work): scale τ by the mean
    # normalized branch entropy at the draft cutoff — harder problems
    # (flatter next-token distributions) get a longer gating phase
    adaptive_horizon: bool = False
    horizon_beta: float = 1.0      # sensitivity; τ_eff ∈ [τ/2, 2τ]
    zscore_clip: float = 3.0
    eps: float = 1e-9
    # sampling (paper §4.1)
    temperature: float = 0.7
    top_k: int = 20
    top_p: float = 0.95
    max_new_tokens: int = 1024
    compaction: bool = True        # bucketed branch compaction (TPU adaptation)

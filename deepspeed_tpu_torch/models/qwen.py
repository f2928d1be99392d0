"""Qwen2 model family configs (copy of ``deepspeed_tpu/models/qwen.py``):
Llama-shaped (RMSNorm + rotary + SwiGLU + GQA) with biased q/k/v
projections only (``qkv_bias``) and rope theta 1e6."""

from .transformer import TransformerConfig, TransformerLM


def qwen2_config(size: str = "7b", **overrides) -> TransformerConfig:
    presets = {
        "tiny": dict(vocab_size=32000, hidden_size=256, num_layers=4, num_heads=8, num_kv_heads=2,
                     intermediate_size=704, max_seq_len=2048),
        "0.5b": dict(vocab_size=151936, hidden_size=896, num_layers=24, num_heads=14, num_kv_heads=2,
                     intermediate_size=4864, max_seq_len=32768, tie_embeddings=True),
        "7b": dict(vocab_size=152064, hidden_size=3584, num_layers=28, num_heads=28, num_kv_heads=4,
                   intermediate_size=18944, max_seq_len=32768),
    }
    base = dict(presets[size], norm="rmsnorm", positions="rotary", mlp="swiglu",
                use_bias=False, qkv_bias=True, rope_theta=1e6, norm_eps=1e-6)
    base.update(overrides)
    return TransformerConfig(**base)


def qwen2(size: str = "7b", *, device=None, seed: int = 0, params=None,
          **overrides) -> TransformerLM:
    return TransformerLM(qwen2_config(size, **overrides), params, device=device, seed=seed)

"""Mistral model family configs (copy of ``deepspeed_tpu/models/mistral.py``):
Llama-shaped (RMSNorm + rotary + SwiGLU) with GQA over 8 kv heads and
sliding-window attention (window 4096 for 7B)."""

from .transformer import TransformerConfig, TransformerLM


def mistral_config(size: str = "7b", **overrides) -> TransformerConfig:
    presets = {
        "tiny": dict(vocab_size=32000, hidden_size=256, num_layers=4, num_heads=8, num_kv_heads=2,
                     intermediate_size=896, max_seq_len=2048, sliding_window=256),
        "7b": dict(vocab_size=32000, hidden_size=4096, num_layers=32, num_heads=32, num_kv_heads=8,
                   intermediate_size=14336, max_seq_len=32768, sliding_window=4096),
    }
    base = dict(presets[size], norm="rmsnorm", positions="rotary", mlp="swiglu", use_bias=False,
                tie_embeddings=False, rope_theta=10000.0, norm_eps=1e-5)
    base.update(overrides)
    return TransformerConfig(**base)


def mistral(size: str = "7b", *, device=None, seed: int = 0, params=None,
            **overrides) -> TransformerLM:
    return TransformerLM(mistral_config(size, **overrides), params, device=device, seed=seed)

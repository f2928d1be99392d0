"""Llama-2 model family configs (copy of ``deepspeed_tpu/models/llama.py``):
RMSNorm + rotary + SwiGLU, GQA at 70B, untied head."""

from .transformer import TransformerConfig, TransformerLM


def llama2_config(size: str = "7b", **overrides) -> TransformerConfig:
    presets = {
        "tiny": dict(vocab_size=32000, hidden_size=256, num_layers=4, num_heads=8, num_kv_heads=8,
                     intermediate_size=688, max_seq_len=2048),
        "7b": dict(vocab_size=32000, hidden_size=4096, num_layers=32, num_heads=32, num_kv_heads=32,
                   intermediate_size=11008, max_seq_len=4096),
        "13b": dict(vocab_size=32000, hidden_size=5120, num_layers=40, num_heads=40, num_kv_heads=40,
                    intermediate_size=13824, max_seq_len=4096),
        "70b": dict(vocab_size=32000, hidden_size=8192, num_layers=80, num_heads=64, num_kv_heads=8,
                    intermediate_size=28672, max_seq_len=4096),
    }
    base = dict(presets[size], norm="rmsnorm", positions="rotary", mlp="swiglu", use_bias=False,
                tie_embeddings=False, rope_theta=10000.0, norm_eps=1e-5)
    base.update(overrides)
    return TransformerConfig(**base)


def llama2(size: str = "7b", *, device=None, seed: int = 0, params=None,
           **overrides) -> TransformerLM:
    return TransformerLM(llama2_config(size, **overrides), params, device=device, seed=seed)

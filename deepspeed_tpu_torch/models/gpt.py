"""GPT-2 model family configs (copy of ``deepspeed_tpu/models/gpt.py``):
LayerNorm + learned positions + GELU, biases everywhere, tied embeddings."""

from .transformer import TransformerConfig, TransformerLM


def gpt2_config(size: str = "small", **overrides) -> TransformerConfig:
    presets = {
        "tiny": dict(vocab_size=50257, hidden_size=128, num_layers=2, num_heads=4, max_seq_len=512),
        "small": dict(vocab_size=50257, hidden_size=768, num_layers=12, num_heads=12, max_seq_len=1024),
        "medium": dict(vocab_size=50257, hidden_size=1024, num_layers=24, num_heads=16, max_seq_len=1024),
        "large": dict(vocab_size=50257, hidden_size=1280, num_layers=36, num_heads=20, max_seq_len=1024),
        "xl": dict(vocab_size=50257, hidden_size=1600, num_layers=48, num_heads=25, max_seq_len=1024),
    }
    base = dict(presets[size], norm="layernorm", positions="learned", mlp="gelu", use_bias=True,
                tie_embeddings=True)
    base.update(overrides)
    return TransformerConfig(**base)


def gpt2(size: str = "small", *, device=None, seed: int = 0, params=None,
         **overrides) -> TransformerLM:
    return TransformerLM(gpt2_config(size, **overrides), params, device=device, seed=seed)

"""Bloom model family configs (copy of ``deepspeed_tpu/models/bloom.py``):
LayerNorm plus a word-embedding LayerNorm, ALiBi positions, GELU, biases
everywhere, tied embeddings."""

from .transformer import TransformerConfig, TransformerLM


def bloom_config(size: str = "560m", **overrides) -> TransformerConfig:
    presets = {
        "tiny": dict(vocab_size=1024, hidden_size=128, num_layers=2, num_heads=4, max_seq_len=512),
        "560m": dict(vocab_size=250880, hidden_size=1024, num_layers=24, num_heads=16, max_seq_len=2048),
        "7b1": dict(vocab_size=250880, hidden_size=4096, num_layers=30, num_heads=32, max_seq_len=2048),
        "176b": dict(vocab_size=250880, hidden_size=14336, num_layers=70, num_heads=112, max_seq_len=2048),
    }
    base = dict(presets[size], norm="layernorm", positions="alibi", mlp="gelu", use_bias=True,
                intermediate_size=4 * presets[size]["hidden_size"], tie_embeddings=True,
                embed_layernorm=True, norm_eps=1e-5)
    base.update(overrides)
    return TransformerConfig(**base)


def bloom(size: str = "560m", *, device=None, seed: int = 0, params=None,
          **overrides) -> TransformerLM:
    return TransformerLM(bloom_config(size, **overrides), params, device=device, seed=seed)

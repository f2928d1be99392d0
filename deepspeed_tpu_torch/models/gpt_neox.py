"""GPT-NeoX / Pythia model family configs (copy of
``deepspeed_tpu/models/gpt_neox.py``): parallel residual with two
pre-norms, partial rotary, GELU, biases, untied head."""

from .transformer import TransformerConfig, TransformerLM


def gpt_neox_config(size: str = "20b", **overrides) -> TransformerConfig:
    presets = {
        "tiny": dict(vocab_size=1024, hidden_size=128, num_layers=2, num_heads=4, max_seq_len=512,
                     rotary_dim=8),
        "pythia-1b": dict(vocab_size=50304, hidden_size=2048, num_layers=16, num_heads=8,
                          max_seq_len=2048, rotary_dim=64),
        "20b": dict(vocab_size=50432, hidden_size=6144, num_layers=44, num_heads=64, max_seq_len=2048,
                    rotary_dim=24),
    }
    base = dict(presets[size], norm="layernorm", positions="rotary", mlp="gelu", use_bias=True,
                intermediate_size=4 * presets[size]["hidden_size"], tie_embeddings=False,
                parallel_residual=True, shared_ln=False, norm_eps=1e-5)
    base.update(overrides)
    return TransformerConfig(**base)


def gpt_neox(size: str = "20b", *, device=None, seed: int = 0, params=None,
             **overrides) -> TransformerLM:
    return TransformerLM(gpt_neox_config(size, **overrides), params, device=device, seed=seed)

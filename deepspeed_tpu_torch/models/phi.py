"""Phi model family configs (copy of ``deepspeed_tpu/models/phi.py``):
parallel residual with one shared pre-norm, partial rotary, LayerNorm,
GELU, biases everywhere, untied head."""

from .transformer import TransformerConfig, TransformerLM


def phi_config(size: str = "2", **overrides) -> TransformerConfig:
    presets = {
        "tiny": dict(vocab_size=32000, hidden_size=256, num_layers=4, num_heads=8,
                     intermediate_size=1024, max_seq_len=2048, rotary_dim=16),
        "1.5": dict(vocab_size=51200, hidden_size=2048, num_layers=24, num_heads=32,
                    intermediate_size=8192, max_seq_len=2048, rotary_dim=32),
        "2": dict(vocab_size=51200, hidden_size=2560, num_layers=32, num_heads=32,
                  intermediate_size=10240, max_seq_len=2048, rotary_dim=32),
    }
    base = dict(presets[size], norm="layernorm", positions="rotary", mlp="gelu",
                use_bias=True, parallel_residual=True, shared_ln=True,
                tie_embeddings=False, norm_eps=1e-5)
    base.update(overrides)
    return TransformerConfig(**base)


def phi(size: str = "2", *, device=None, seed: int = 0, params=None,
        **overrides) -> TransformerLM:
    return TransformerLM(phi_config(size, **overrides), params, device=device, seed=seed)

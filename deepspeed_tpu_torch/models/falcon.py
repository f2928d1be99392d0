"""Falcon model family configs (copy of ``deepspeed_tpu/models/falcon.py``):
parallel residual with one shared pre-norm, full rotary, GELU, no biases,
multi-query (7B: one kv head) or grouped-query (40B) attention, tied
embeddings."""

from .transformer import TransformerConfig, TransformerLM


def falcon_config(size: str = "7b", **overrides) -> TransformerConfig:
    presets = {
        "tiny": dict(vocab_size=1024, hidden_size=128, num_layers=2, num_heads=4, num_kv_heads=1,
                     max_seq_len=512),
        "7b": dict(vocab_size=65024, hidden_size=4544, num_layers=32, num_heads=71, num_kv_heads=1,
                   max_seq_len=2048),
        "40b": dict(vocab_size=65024, hidden_size=8192, num_layers=60, num_heads=128, num_kv_heads=8,
                    max_seq_len=2048),
    }
    base = dict(presets[size], norm="layernorm", positions="rotary", mlp="gelu", use_bias=False,
                intermediate_size=4 * presets[size]["hidden_size"], tie_embeddings=True,
                parallel_residual=True, shared_ln=True, norm_eps=1e-5)
    base.update(overrides)
    return TransformerConfig(**base)


def falcon(size: str = "7b", *, device=None, seed: int = 0, params=None,
           **overrides) -> TransformerLM:
    return TransformerLM(falcon_config(size, **overrides), params, device=device, seed=seed)

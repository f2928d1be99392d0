"""GPT-J model family configs (copy of ``deepspeed_tpu/models/gptj.py``):
parallel residual with one shared pre-norm, partial rotary (64 dims at
6B), GELU, untied head with a bias."""

from .transformer import TransformerConfig, TransformerLM


def gptj_config(size: str = "6b", **overrides) -> TransformerConfig:
    presets = {
        "tiny": dict(vocab_size=1024, hidden_size=128, num_layers=2, num_heads=4, max_seq_len=512,
                     rotary_dim=16),
        "6b": dict(vocab_size=50400, hidden_size=4096, num_layers=28, num_heads=16, max_seq_len=2048,
                   rotary_dim=64),
    }
    base = dict(presets[size], norm="layernorm", positions="rotary", mlp="gelu", use_bias=True,
                intermediate_size=4 * presets[size]["hidden_size"], tie_embeddings=False,
                parallel_residual=True, shared_ln=True, norm_eps=1e-5)
    base.update(overrides)
    return TransformerConfig(**base)


def gptj(size: str = "6b", *, device=None, seed: int = 0, params=None,
         **overrides) -> TransformerLM:
    return TransformerLM(gptj_config(size, **overrides), params, device=device, seed=seed)

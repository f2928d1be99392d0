"""OPT model family configs (copy of ``deepspeed_tpu/models/opt.py``):
LayerNorm + learned positions + ReLU MLP, biases everywhere, tied
embeddings."""

from .transformer import TransformerConfig, TransformerLM


def opt_config(size: str = "125m", **overrides) -> TransformerConfig:
    presets = {
        "tiny": dict(vocab_size=50272, hidden_size=128, num_layers=2, num_heads=4, max_seq_len=512),
        "125m": dict(vocab_size=50272, hidden_size=768, num_layers=12, num_heads=12, max_seq_len=2048),
        "1.3b": dict(vocab_size=50272, hidden_size=2048, num_layers=24, num_heads=32, max_seq_len=2048),
        "6.7b": dict(vocab_size=50272, hidden_size=4096, num_layers=32, num_heads=32, max_seq_len=2048),
        "13b": dict(vocab_size=50272, hidden_size=5120, num_layers=40, num_heads=40, max_seq_len=2048),
        "30b": dict(vocab_size=50272, hidden_size=7168, num_layers=48, num_heads=56, max_seq_len=2048),
        "66b": dict(vocab_size=50272, hidden_size=9216, num_layers=64, num_heads=72, max_seq_len=2048),
    }
    base = dict(presets[size], norm="layernorm", positions="learned", mlp="relu", use_bias=True,
                intermediate_size=4 * presets[size]["hidden_size"], tie_embeddings=True)
    base.update(overrides)
    return TransformerConfig(**base)


def opt(size: str = "125m", *, device=None, seed: int = 0, params=None,
        **overrides) -> TransformerLM:
    return TransformerLM(opt_config(size, **overrides), params, device=device, seed=seed)

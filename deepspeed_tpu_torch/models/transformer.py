"""Decoder-only transformer for the PyTorch port: config, parameters and the
shared numerics (norm, rotary, ALiBi slopes, MLP activation).

Counterpart of ``deepspeed_tpu/models/transformer.py:39-335``. Parameters
keep the TPU package's names and stacked ``[L, ...]`` block layout, with
weights stored ``[in, out]``, so a parameter tree moves between the two
packages name for name (``models/convert.py``). This slice serves the model
(``inference/v2``); training, the v1 KV-cache path, MoE and block-sparse
attention are not ported yet and a config that asks for them is refused.
"""

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# the weights matrix products read: stored in the serving dtype. Norm scales
# and biases stay fp32 (the norm runs in fp32 with its fp32 scale).
MATMUL_WEIGHTS = ("wq", "wk", "wv", "wo", "w_up", "w_down", "w_gate")


@dataclass
class TransformerConfig:
    vocab_size: int = 32000
    hidden_size: int = 512
    intermediate_size: Optional[int] = None  # default 4x (gelu) or 8/3x (swiglu)
    num_layers: int = 4
    num_heads: int = 8
    num_kv_heads: Optional[int] = None  # GQA; None = MHA
    max_seq_len: int = 2048
    norm: str = "rmsnorm"  # 'rmsnorm' | 'layernorm'
    positions: str = "rotary"  # 'rotary' | 'learned' | 'alibi'
    mlp: str = "swiglu"  # 'swiglu' | 'gelu' | 'relu'
    use_bias: bool = False
    qkv_bias: Optional[bool] = None  # per-site override for q/k/v; None = use_bias
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    parallel_residual: bool = False
    shared_ln: bool = False
    rotary_dim: Optional[int] = None  # partial rotary; None = full head_dim
    embed_layernorm: bool = False
    dtype: Any = torch.bfloat16  # compute dtype
    # sliding-window attention (Mistral): query at i sees keys in (i-window, i]
    sliding_window: Optional[int] = None
    sparse_attention: Optional[dict] = None
    moe_num_experts: int = 0

    def __post_init__(self):
        if self.intermediate_size is None:
            if self.mlp == "swiglu":
                self.intermediate_size = int(8 * self.hidden_size / 3 / 128 + 1) * 128
            else:
                self.intermediate_size = 4 * self.hidden_size
        if self.num_kv_heads is None:
            self.num_kv_heads = self.num_heads
        if self.hidden_size % self.num_heads:
            raise ValueError(f"hidden_size {self.hidden_size} is not a multiple of num_heads "
                             f"{self.num_heads}")
        if self.num_heads % self.num_kv_heads:
            raise ValueError(f"num_heads {self.num_heads} is not a multiple of num_kv_heads "
                             f"{self.num_kv_heads}")

    @property
    def qkv_bias_enabled(self) -> bool:
        return self.use_bias if self.qkv_bias is None else self.qkv_bias

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


def _refuse_unported(cfg: TransformerConfig) -> None:
    if cfg.moe_num_experts > 0:
        raise NotImplementedError("MoE is not ported to the PyTorch package yet")
    if cfg.sparse_attention is not None:
        raise NotImplementedError("block-sparse attention is not ported to the PyTorch "
                                  "package yet")


def resolve_device(device=None) -> torch.device:
    """The port's entry points run on CUDA unless the caller asks for the
    CPU; asking for CUDA without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA was asked for (the default) but torch.cuda.is_available() "
                           "is False; pass device='cpu' to run on the CPU")
    return dev


# ---------------------------------------------------------------------------
# Param init
# ---------------------------------------------------------------------------

def init_params(cfg: TransformerConfig, generator: torch.Generator, device=None,
                dtype=None) -> Dict[str, Any]:
    """Random parameters from ``generator`` (on ``device``), in the TPU
    package's names and stacked ``[L, ...]`` layout with the same scales.
    Matrix weights are stored in ``dtype`` (default ``cfg.dtype``), norm
    scales and biases in fp32. Drawn one layer at a time, so a full-size
    model never holds an fp32 copy of a stacked weight."""
    _refuse_unported(cfg)
    device = resolve_device(device)
    dtype = cfg.dtype if dtype is None else dtype
    L, H, Fi = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size
    nq, nkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    f32 = dict(dtype=torch.float32, device=device)

    def dense(shape, fan_in, extra=1.0):
        out = torch.empty((L, *shape), dtype=dtype, device=device)
        for l in range(L):
            w = torch.randn(shape, generator=generator, **f32)
            out[l] = w.mul_(1.0 / (math.sqrt(fan_in) * extra))
        return out

    blocks = {
        "ln1_scale": torch.ones((L, H), **f32),
        "wq": dense((H, nq * d), H),
        "wk": dense((H, nkv * d), H),
        "wv": dense((H, nkv * d), H),
        "wo": dense((nq * d, H), nq * d, math.sqrt(2 * L)),
        "ln2_scale": torch.ones((L, H), **f32),
        "w_up": dense((H, Fi), H),
        "w_down": dense((Fi, H), Fi, math.sqrt(2 * L)),
    }
    if cfg.mlp == "swiglu":
        blocks["w_gate"] = dense((H, Fi), H)
    if cfg.parallel_residual and cfg.shared_ln:
        del blocks["ln2_scale"]
    if cfg.norm == "layernorm":
        blocks["ln1_bias"] = torch.zeros((L, H), **f32)
        if not (cfg.parallel_residual and cfg.shared_ln):
            blocks["ln2_bias"] = torch.zeros((L, H), **f32)
    if cfg.qkv_bias_enabled:
        blocks["bq"] = torch.zeros((L, nq * d), **f32)
        blocks["bk"] = torch.zeros((L, nkv * d), **f32)
        blocks["bv"] = torch.zeros((L, nkv * d), **f32)
    if cfg.use_bias:
        blocks["bo"] = torch.zeros((L, H), **f32)
        blocks["b_up"] = torch.zeros((L, Fi), **f32)
        blocks["b_down"] = torch.zeros((L, H), **f32)

    emb = torch.randn((cfg.vocab_size, H), generator=generator, **f32).mul_(0.02)
    params = {
        "embed": {"embedding": emb.to(dtype)},
        "blocks": blocks,
        "final_norm": {"scale": torch.ones((H, ), **f32)},
    }
    if cfg.norm == "layernorm":
        params["final_norm"]["bias"] = torch.zeros((H, ), **f32)
    if cfg.embed_layernorm:
        params["embed_norm"] = {"scale": torch.ones((H, ), **f32)}
        if cfg.norm == "layernorm":
            params["embed_norm"]["bias"] = torch.zeros((H, ), **f32)
    if cfg.positions == "learned":
        pe = torch.randn((cfg.max_seq_len, H), generator=generator, **f32).mul_(0.02)
        params["pos_embed"] = {"embedding": pe.to(dtype)}
    if not cfg.tie_embeddings:
        head = torch.randn((H, cfg.vocab_size), generator=generator, **f32)
        params["lm_head"] = {"kernel": head.mul_(1.0 / math.sqrt(H)).to(dtype)}
    return params


# ---------------------------------------------------------------------------
# Shared numerics
# ---------------------------------------------------------------------------

def _norm(x, scale, bias, kind, eps):
    """RMSNorm / LayerNorm in fp32 with the fp32 scale, cast back to x's
    dtype (``transformer.py:246-255``)."""
    x32 = x.float()
    if kind == "rmsnorm":
        x32 = x32 * torch.rsqrt(x32.pow(2).mean(dim=-1, keepdim=True) + eps)
        out = x32 * scale.float()
    else:
        mu = x32.mean(dim=-1, keepdim=True)
        var = (x32 - mu).pow(2).mean(dim=-1, keepdim=True)
        out = (x32 - mu) * torch.rsqrt(var + eps) * scale.float()
        if bias is not None:
            out = out + bias.float()
    return out.to(x.dtype)


def rope_table(cfg: TransformerConfig, positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 (sin, cos) of shape [S, r/2] for integer ``positions`` [S]."""
    d = cfg.rotary_dim or cfg.head_dim
    dev = positions.device
    inv_freq = 1.0 / (cfg.rope_theta**(torch.arange(0, d, 2, dtype=torch.float32, device=dev) / d))
    freqs = positions.float()[:, None] * inv_freq[None, :]
    return torch.sin(freqs), torch.cos(freqs)


def apply_rope(x, sin, cos):
    """Half-split (not interleaved) rotary in fp32. x: [B, S, n, d]; sin/cos:
    [S, r/2] with r <= d: the first r dims rotate, the rest pass through."""
    r = 2 * sin.shape[-1]
    d = x.shape[-1]
    xr = x[..., :r] if r < d else x
    x1, x2 = xr.float().chunk(2, dim=-1)
    sinb = sin[None, :, None, :]
    cosb = cos[None, :, None, :]
    rot = torch.cat([x1 * cosb - x2 * sinb, x2 * cosb + x1 * sinb], dim=-1).to(x.dtype)
    if r < d:
        return torch.cat([rot, x[..., r:]], dim=-1)
    return rot


def alibi_slopes(n_heads: int) -> np.ndarray:
    """Per-head ALiBi slopes: powers of two for power-of-two head counts,
    the standard interleave otherwise."""

    def pow2_slopes(n):
        start = 2.0**(-(2.0**-(math.log2(n) - 3)))
        return [start * (start**i) for i in range(n)]

    if math.log2(n_heads).is_integer():
        return np.asarray(pow2_slopes(n_heads), np.float32)
    closest = 2**int(math.floor(math.log2(n_heads)))
    out = pow2_slopes(closest)
    extra = pow2_slopes(2 * closest)[0::2][:n_heads - closest]
    return np.asarray(out + extra, np.float32)


def mlp_activation(cfg: TransformerConfig, up, gate=None):
    """swiglu: silu(gate) * up; relu; gelu with the tanh approximation (the
    TPU package's ``jax.nn.gelu`` default)."""
    if cfg.mlp == "swiglu":
        return F.silu(gate) * up
    if cfg.mlp == "relu":
        return F.relu(up)
    return F.gelu(up, approximate="tanh")


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------

class TransformerLM(nn.Module):
    """Holds a config and its parameter tree (nested ``nn.ParameterDict``s,
    no gradients: this slice serves). ``params`` defaults to
    :func:`init_params` from ``torch.Generator(device).manual_seed(seed)``."""

    def __init__(self, config: TransformerConfig, params: Optional[Dict[str, Any]] = None, *,
                 device=None, seed: int = 0, dtype=None):
        super().__init__()
        _refuse_unported(config)
        self.config = config
        if params is None:
            dev = resolve_device(device)
            gen = torch.Generator(device=dev).manual_seed(seed)
            params = init_params(config, gen, dev, dtype)
        self.tree = nn.ModuleDict({
            group: nn.ParameterDict({name: nn.Parameter(t, requires_grad=False)
                                     for name, t in leaves.items()})
            for group, leaves in params.items()
        })

    def params(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """The parameter tree as plain nested dicts of tensors (no copies)."""
        return {group: {name: p.data for name, p in leaves.items()}
                for group, leaves in self.tree.items()}

    def num_params(self) -> int:
        return sum(p.numel() for p in self.tree.parameters())

"""Declarative parameter mapping from HuggingFace checkpoints to the port's
parameter tree (counterpart of
``deepspeed_tpu/inference/v2/model_implementations/parameter_spec.py``, the
reference's ``parameter_base.py`` / ``layer_container_base.py``).

A model family is a list of :class:`ParamSpec` rows: HF source name(s),
target path(s) in the parameter tree, a named transform and an optional
predicate. One generic :func:`convert_with_spec` walks the table and stacks
the per-layer tensors into the ``[L, ...]`` tensors the ragged forward reads.

The transforms are torch views, slices and permutations of the source
tensor, so a target equals the source's values exactly in any dtype that
holds them. Layout conventions:
  - torch ``nn.Linear`` stores ``[out, in]``; the port's weights are
    ``[in, out]`` (transform ``"t"``); GPT-2's ``Conv1D`` is already
    ``[in, out]`` (``"copy"``);
  - fused query_key_value weights split per family: Bloom / NeoX interleave
    ``(nh, 3, hd)`` per head, Falcon groups ``[q heads..., k, v]`` per kv
    head;
  - GPT-J's interleaved (rotate-every-two) rotary becomes the port's
    half-split rotary through one column permutation of q and k.

Host memory: each source tensor is read when its row needs it, moved to the
target device in its own dtype, transformed there and copied (cast to the
serving dtype for matrix weights and embeddings, fp32 for norms and biases)
into a target tensor allocated once, so the host holds one source tensor
at a time.
"""

from dataclasses import dataclass
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ....models.transformer import resolve_device, takes_compute_dtype


# ---------------------------------------------------------------------------
# transforms: (cfg, *source tensors) -> tuple of target tensors
# ---------------------------------------------------------------------------
def _t(cfg, w):
    return (w.t(), )


def _copy(cfg, a):
    return (a, )


def _rows_from_2(cfg, a):
    # OPT's learned positions carry a +2 offset (rows 0-1 unused)
    return (a[2:], )


def _split3_last(cfg, a):
    # GPT-2's fused c_attn: q, k, v concatenated on the last axis ([in, 3H]
    # weight, [3H] bias)
    return tuple(torch.chunk(a, 3, dim=-1))


def _qkv_interleaved(cfg, w):
    """Bloom / NeoX fused qkv weight ``[nh * 3 * hd, H]`` (torch ``[out,
    in]``) interleaved per head -> three ``[H, nh * hd]``."""
    nh, hd = cfg.num_heads, cfg.head_dim
    H = w.shape[1]
    w3 = w.reshape(nh, 3, hd, H)
    return tuple(w3[:, j].reshape(nh * hd, H).t() for j in range(3))


def _qkv_bias_interleaved(cfg, b):
    nh, hd = cfg.num_heads, cfg.head_dim
    b3 = b.reshape(nh, 3, hd)
    return tuple(b3[:, j].reshape(-1) for j in range(3))


def _qkv_gqa_rows(cfg, w):
    """Falcon's fused MQA / GQA layout: per kv group ``[q heads..., k, v]``
    on the out dim -> q ``[H, nh * hd]``, k / v ``[H, nkv * hd]``."""
    nh, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    H = w.shape[1]
    w3 = w.reshape(nkv, nh // nkv + 2, hd, H)
    q = w3[:, :-2].reshape(nh * hd, H).t()
    k = w3[:, -2].reshape(nkv * hd, H).t()
    v = w3[:, -1].reshape(nkv * hd, H).t()
    return q, k, v


def _interleaved_to_half_perm(w_cols, nh, hd, rotary_dim):
    """Permute q / k output columns so that HF's interleaved rotary becomes
    the half-split one. Score-preserving: the same permutation hits q and k."""
    perm_r = list(range(0, rotary_dim, 2)) + list(range(1, rotary_dim, 2))
    idx = []
    for h in range(nh):
        off = h * hd
        idx.extend(off + p for p in perm_r)
        idx.extend(range(off + rotary_dim, off + hd))
    return w_cols[..., torch.as_tensor(idx, device=w_cols.device)]


def _t_rotary_half(cfg, w):
    return (_interleaved_to_half_perm(w.t(), cfg.num_heads, cfg.head_dim, cfg.rotary_dim), )


def _zeros_qkv(cfg):
    return (torch.zeros(cfg.num_heads * cfg.head_dim, dtype=torch.float32), )


def _zeros_hidden(cfg):
    return (torch.zeros(cfg.hidden_size, dtype=torch.float32), )


TRANSFORMS: Dict[str, Callable] = {
    "copy": _copy,
    "t": _t,
    "rows_from_2": _rows_from_2,
    "split3_last": _split3_last,
    "qkv_interleaved": _qkv_interleaved,
    "qkv_bias_interleaved": _qkv_bias_interleaved,
    "qkv_gqa_rows": _qkv_gqa_rows,
    "t_rotary_half": _t_rotary_half,
    "zeros_qkv": _zeros_qkv,
    "zeros_hidden": _zeros_hidden,
}

# predicates: (cfg, sd) -> bool, gating conditional rows
PREDICATES: Dict[str, Callable] = {
    "untied": lambda cfg, sd: not cfg.tie_embeddings,
    # what the forward consults (qkv_bias, else use_bias): the converter
    # must agree with it or the forward misses layer["bq"]
    "qkv_bias": lambda cfg, sd: bool(cfg.qkv_bias_enabled),
    # Falcon's 40b / 180b decoder names its two parallel norms ln_attn /
    # ln_mlp; detected from the checkpoint itself, as the HF loaders do
    "falcon_new_arch": lambda cfg, sd: "transformer.h.0.ln_attn.weight" in sd,
    "falcon_old_arch": lambda cfg, sd: "transformer.h.0.ln_attn.weight" not in sd,
}


@dataclass(frozen=True)
class ParamSpec:
    """One row of a family's table: ``srcs`` (HF names, ``{i}`` the layer
    index when ``per_layer``) feed ``transform``, whose outputs land at
    ``targets`` (dotted paths into the parameter tree)."""

    targets: Tuple[str, ...]
    srcs: Tuple[str, ...] = ()
    transform: str = "copy"
    per_layer: bool = False
    when: Optional[str] = None

    def __post_init__(self):
        if isinstance(self.targets, str):
            object.__setattr__(self, "targets", (self.targets, ))
        if isinstance(self.srcs, str):
            object.__setattr__(self, "srcs", (self.srcs, ))
        if self.transform not in TRANSFORMS:
            raise ValueError(f"unknown transform {self.transform!r} for {self.targets}")
        if self.when is not None and self.when not in PREDICATES:
            raise ValueError(f"unknown predicate {self.when!r} for {self.targets}")


S = ParamSpec  # table-writing shorthand


def _set_path(tree: dict, dotted: str, val) -> None:
    parts = dotted.split(".")
    d = tree
    for p in parts[:-1]:
        d = d.setdefault(p, {})
    d[parts[-1]] = val


def _target_dtype(dotted: str, dtype: torch.dtype) -> torch.dtype:
    """The dtype a target is stored in: ``dtype`` for matrix weights and
    embeddings, fp32 for norm scales and biases (``convert.params_from_jax``'s
    rule)."""
    group, name = dotted.split(".")
    return dtype if takes_compute_dtype(group, name) else torch.float32


def convert_with_spec(sd: Mapping, cfg, entries, dtype=None, device=None) -> dict:
    """Run a family's table over an HF state dict (name -> torch tensor or
    numpy array; a lazy mapping reads each tensor when asked) -> the port's
    parameter tree on ``device`` (default CUDA), blocks stacked ``[L, ...]``.
    Matrix weights and embeddings take ``dtype`` (default ``cfg.dtype``). A
    missing source tensor raises, naming the row."""
    dtype = cfg.dtype if dtype is None else dtype
    device = resolve_device(device)
    out: dict = {}
    for e in entries:
        if e.when is not None and not PREDICATES[e.when](cfg, sd):
            continue
        tf = TRANSFORMS[e.transform]

        def fetch(name):
            if name not in sd:
                raise KeyError(f"HF checkpoint is missing {name!r} (needed for {e.targets} via "
                               f"transform {e.transform!r})")
            src = sd[name]
            if isinstance(src, np.ndarray):
                src = torch.from_numpy(np.array(src))  # a writable copy
            return src.to(device)

        def place(dst, o, t):
            if o.shape != dst.shape:
                raise ValueError(f"{t}: the transform {e.transform!r} gave {tuple(o.shape)}, "
                                 f"expected {tuple(dst.shape)}")
            dst.copy_(o)

        vals = [None] * len(e.targets)
        for i in (range(cfg.num_layers) if e.per_layer else [None]):
            srcs = [fetch(s.format(i=i)) for s in e.srcs]
            outs = tf(cfg, *srcs)
            if len(outs) != len(e.targets):
                raise ValueError(f"transform {e.transform!r} produced {len(outs)} outputs "
                                 f"for {len(e.targets)} targets {e.targets}")
            for j, (t, o) in enumerate(zip(e.targets, outs)):
                if vals[j] is None:
                    lead = (cfg.num_layers, ) if e.per_layer else ()
                    vals[j] = torch.empty(lead + tuple(o.shape), dtype=_target_dtype(t, dtype),
                                          device=device)
                place(vals[j] if i is None else vals[j][i], o, t)
            del srcs, outs  # before the next layer's read: one layer's sources at a time
        for t, v in zip(e.targets, vals):
            _set_path(out, t, v)
    return out


# ---------------------------------------------------------------------------
# family tables (the reference's model_implementations/<family>/: one
# container spec per family; here one table per family)
# ---------------------------------------------------------------------------
def _llama_family() -> tuple:
    """llama / mistral / qwen2 (qwen2 adds biased qkv through the predicate)."""
    b = "model.layers.{i}."
    return (
        S("embed.embedding", "model.embed_tokens.weight"),
        S("blocks.ln1_scale", b + "input_layernorm.weight", per_layer=True),
        S("blocks.wq", b + "self_attn.q_proj.weight", "t", per_layer=True),
        S("blocks.wk", b + "self_attn.k_proj.weight", "t", per_layer=True),
        S("blocks.wv", b + "self_attn.v_proj.weight", "t", per_layer=True),
        S("blocks.wo", b + "self_attn.o_proj.weight", "t", per_layer=True),
        S("blocks.bq", b + "self_attn.q_proj.bias", per_layer=True, when="qkv_bias"),
        S("blocks.bk", b + "self_attn.k_proj.bias", per_layer=True, when="qkv_bias"),
        S("blocks.bv", b + "self_attn.v_proj.bias", per_layer=True, when="qkv_bias"),
        S("blocks.ln2_scale", b + "post_attention_layernorm.weight", per_layer=True),
        S("blocks.w_gate", b + "mlp.gate_proj.weight", "t", per_layer=True),
        S("blocks.w_up", b + "mlp.up_proj.weight", "t", per_layer=True),
        S("blocks.w_down", b + "mlp.down_proj.weight", "t", per_layer=True),
        S("final_norm.scale", "model.norm.weight"),
        S("lm_head.kernel", "lm_head.weight", "t", when="untied"),
    )


def _phi() -> tuple:
    b = "model.layers.{i}."
    return (
        S("embed.embedding", "model.embed_tokens.weight"),
        S("blocks.ln1_scale", b + "input_layernorm.weight", per_layer=True),
        S("blocks.ln1_bias", b + "input_layernorm.bias", per_layer=True),
        S("blocks.wq", b + "self_attn.q_proj.weight", "t", per_layer=True),
        S("blocks.bq", b + "self_attn.q_proj.bias", per_layer=True),
        S("blocks.wk", b + "self_attn.k_proj.weight", "t", per_layer=True),
        S("blocks.bk", b + "self_attn.k_proj.bias", per_layer=True),
        S("blocks.wv", b + "self_attn.v_proj.weight", "t", per_layer=True),
        S("blocks.bv", b + "self_attn.v_proj.bias", per_layer=True),
        S("blocks.wo", b + "self_attn.dense.weight", "t", per_layer=True),
        S("blocks.bo", b + "self_attn.dense.bias", per_layer=True),
        S("blocks.w_up", b + "mlp.fc1.weight", "t", per_layer=True),
        S("blocks.b_up", b + "mlp.fc1.bias", per_layer=True),
        S("blocks.w_down", b + "mlp.fc2.weight", "t", per_layer=True),
        S("blocks.b_down", b + "mlp.fc2.bias", per_layer=True),
        S("final_norm.scale", "model.final_layernorm.weight"),
        S("final_norm.bias", "model.final_layernorm.bias"),
        S("lm_head.kernel", "lm_head.weight", "t"),
        S("lm_head.bias", "lm_head.bias"),
    )


def _gpt2() -> tuple:
    b = "transformer.h.{i}."
    return (
        S("embed.embedding", "transformer.wte.weight"),
        S("pos_embed.embedding", "transformer.wpe.weight"),
        S("blocks.ln1_scale", b + "ln_1.weight", per_layer=True),
        S("blocks.ln1_bias", b + "ln_1.bias", per_layer=True),
        # Conv1D stores [in, out]: no transpose; c_attn fuses qkv on the out dim
        S(("blocks.wq", "blocks.wk", "blocks.wv"), b + "attn.c_attn.weight",
          "split3_last", per_layer=True),
        S(("blocks.bq", "blocks.bk", "blocks.bv"), b + "attn.c_attn.bias",
          "split3_last", per_layer=True),
        S("blocks.wo", b + "attn.c_proj.weight", per_layer=True),
        S("blocks.bo", b + "attn.c_proj.bias", per_layer=True),
        S("blocks.ln2_scale", b + "ln_2.weight", per_layer=True),
        S("blocks.ln2_bias", b + "ln_2.bias", per_layer=True),
        S("blocks.w_up", b + "mlp.c_fc.weight", per_layer=True),
        S("blocks.b_up", b + "mlp.c_fc.bias", per_layer=True),
        S("blocks.w_down", b + "mlp.c_proj.weight", per_layer=True),
        S("blocks.b_down", b + "mlp.c_proj.bias", per_layer=True),
        S("final_norm.scale", "transformer.ln_f.weight"),
        S("final_norm.bias", "transformer.ln_f.bias"),
    )


def _opt() -> tuple:
    b = "model.decoder.layers.{i}."
    return (
        S("embed.embedding", "model.decoder.embed_tokens.weight"),
        S("pos_embed.embedding", "model.decoder.embed_positions.weight", "rows_from_2"),
        S("blocks.ln1_scale", b + "self_attn_layer_norm.weight", per_layer=True),
        S("blocks.ln1_bias", b + "self_attn_layer_norm.bias", per_layer=True),
        S("blocks.wq", b + "self_attn.q_proj.weight", "t", per_layer=True),
        S("blocks.wk", b + "self_attn.k_proj.weight", "t", per_layer=True),
        S("blocks.wv", b + "self_attn.v_proj.weight", "t", per_layer=True),
        S("blocks.bq", b + "self_attn.q_proj.bias", per_layer=True),
        S("blocks.bk", b + "self_attn.k_proj.bias", per_layer=True),
        S("blocks.bv", b + "self_attn.v_proj.bias", per_layer=True),
        S("blocks.wo", b + "self_attn.out_proj.weight", "t", per_layer=True),
        S("blocks.bo", b + "self_attn.out_proj.bias", per_layer=True),
        S("blocks.ln2_scale", b + "final_layer_norm.weight", per_layer=True),
        S("blocks.ln2_bias", b + "final_layer_norm.bias", per_layer=True),
        S("blocks.w_up", b + "fc1.weight", "t", per_layer=True),
        S("blocks.b_up", b + "fc1.bias", per_layer=True),
        S("blocks.w_down", b + "fc2.weight", "t", per_layer=True),
        S("blocks.b_down", b + "fc2.bias", per_layer=True),
        S("final_norm.scale", "model.decoder.final_layer_norm.weight"),
        S("final_norm.bias", "model.decoder.final_layer_norm.bias"),
    )


def _bloom() -> tuple:
    b = "transformer.h.{i}."
    return (
        S("embed.embedding", "transformer.word_embeddings.weight"),
        S("embed_norm.scale", "transformer.word_embeddings_layernorm.weight"),
        S("embed_norm.bias", "transformer.word_embeddings_layernorm.bias"),
        S("blocks.ln1_scale", b + "input_layernorm.weight", per_layer=True),
        S("blocks.ln1_bias", b + "input_layernorm.bias", per_layer=True),
        S(("blocks.wq", "blocks.wk", "blocks.wv"),
          b + "self_attention.query_key_value.weight", "qkv_interleaved", per_layer=True),
        S(("blocks.bq", "blocks.bk", "blocks.bv"),
          b + "self_attention.query_key_value.bias", "qkv_bias_interleaved", per_layer=True),
        S("blocks.wo", b + "self_attention.dense.weight", "t", per_layer=True),
        S("blocks.bo", b + "self_attention.dense.bias", per_layer=True),
        S("blocks.ln2_scale", b + "post_attention_layernorm.weight", per_layer=True),
        S("blocks.ln2_bias", b + "post_attention_layernorm.bias", per_layer=True),
        S("blocks.w_up", b + "mlp.dense_h_to_4h.weight", "t", per_layer=True),
        S("blocks.b_up", b + "mlp.dense_h_to_4h.bias", per_layer=True),
        S("blocks.w_down", b + "mlp.dense_4h_to_h.weight", "t", per_layer=True),
        S("blocks.b_down", b + "mlp.dense_4h_to_h.bias", per_layer=True),
        S("final_norm.scale", "transformer.ln_f.weight"),
        S("final_norm.bias", "transformer.ln_f.bias"),
    )


def _gptj() -> tuple:
    b = "transformer.h.{i}."
    return (
        S("embed.embedding", "transformer.wte.weight"),
        S("blocks.ln1_scale", b + "ln_1.weight", per_layer=True),
        S("blocks.ln1_bias", b + "ln_1.bias", per_layer=True),
        # interleaved -> half rotary through a column permutation of q / k
        S("blocks.wq", b + "attn.q_proj.weight", "t_rotary_half", per_layer=True),
        S("blocks.wk", b + "attn.k_proj.weight", "t_rotary_half", per_layer=True),
        S("blocks.wv", b + "attn.v_proj.weight", "t", per_layer=True),
        # GPT-J's attention has no biases; the block layout expects them
        S("blocks.bq", transform="zeros_qkv", per_layer=True),
        S("blocks.bk", transform="zeros_qkv", per_layer=True),
        S("blocks.bv", transform="zeros_qkv", per_layer=True),
        S("blocks.wo", b + "attn.out_proj.weight", "t", per_layer=True),
        S("blocks.bo", transform="zeros_hidden", per_layer=True),
        S("blocks.w_up", b + "mlp.fc_in.weight", "t", per_layer=True),
        S("blocks.b_up", b + "mlp.fc_in.bias", per_layer=True),
        S("blocks.w_down", b + "mlp.fc_out.weight", "t", per_layer=True),
        S("blocks.b_down", b + "mlp.fc_out.bias", per_layer=True),
        S("final_norm.scale", "transformer.ln_f.weight"),
        S("final_norm.bias", "transformer.ln_f.bias"),
        S("lm_head.kernel", "lm_head.weight", "t"),
        S("lm_head.bias", "lm_head.bias"),
    )


def _gpt_neox() -> tuple:
    b = "gpt_neox.layers.{i}."
    return (
        S("embed.embedding", "gpt_neox.embed_in.weight"),
        S("blocks.ln1_scale", b + "input_layernorm.weight", per_layer=True),
        S("blocks.ln1_bias", b + "input_layernorm.bias", per_layer=True),
        S(("blocks.wq", "blocks.wk", "blocks.wv"),
          b + "attention.query_key_value.weight", "qkv_interleaved", per_layer=True),
        S(("blocks.bq", "blocks.bk", "blocks.bv"),
          b + "attention.query_key_value.bias", "qkv_bias_interleaved", per_layer=True),
        S("blocks.wo", b + "attention.dense.weight", "t", per_layer=True),
        S("blocks.bo", b + "attention.dense.bias", per_layer=True),
        S("blocks.ln2_scale", b + "post_attention_layernorm.weight", per_layer=True),
        S("blocks.ln2_bias", b + "post_attention_layernorm.bias", per_layer=True),
        S("blocks.w_up", b + "mlp.dense_h_to_4h.weight", "t", per_layer=True),
        S("blocks.b_up", b + "mlp.dense_h_to_4h.bias", per_layer=True),
        S("blocks.w_down", b + "mlp.dense_4h_to_h.weight", "t", per_layer=True),
        S("blocks.b_down", b + "mlp.dense_4h_to_h.bias", per_layer=True),
        S("final_norm.scale", "gpt_neox.final_layer_norm.weight"),
        S("final_norm.bias", "gpt_neox.final_layer_norm.bias"),
        S("lm_head.kernel", "embed_out.weight", "t", when="untied"),
    )


def _falcon() -> tuple:
    b = "transformer.h.{i}."
    return (
        S("embed.embedding", "transformer.word_embeddings.weight"),
        # the 7b family: one shared input_layernorm; 40b / 180b: ln_attn + ln_mlp
        S("blocks.ln1_scale", b + "input_layernorm.weight", per_layer=True,
          when="falcon_old_arch"),
        S("blocks.ln1_bias", b + "input_layernorm.bias", per_layer=True,
          when="falcon_old_arch"),
        S("blocks.ln1_scale", b + "ln_attn.weight", per_layer=True, when="falcon_new_arch"),
        S("blocks.ln1_bias", b + "ln_attn.bias", per_layer=True, when="falcon_new_arch"),
        S("blocks.ln2_scale", b + "ln_mlp.weight", per_layer=True, when="falcon_new_arch"),
        S("blocks.ln2_bias", b + "ln_mlp.bias", per_layer=True, when="falcon_new_arch"),
        S(("blocks.wq", "blocks.wk", "blocks.wv"),
          b + "self_attention.query_key_value.weight", "qkv_gqa_rows", per_layer=True),
        S("blocks.wo", b + "self_attention.dense.weight", "t", per_layer=True),
        S("blocks.w_up", b + "mlp.dense_h_to_4h.weight", "t", per_layer=True),
        S("blocks.w_down", b + "mlp.dense_4h_to_h.weight", "t", per_layer=True),
        S("final_norm.scale", "transformer.ln_f.weight"),
        S("final_norm.bias", "transformer.ln_f.bias"),
        S("lm_head.kernel", "lm_head.weight", "t", when="untied"),
    )


_LLAMA_FAMILY = _llama_family()

FAMILY_SPECS: Dict[str, tuple] = {
    "llama": _LLAMA_FAMILY,
    "mistral": _LLAMA_FAMILY,
    "qwen2": _LLAMA_FAMILY,
    "phi": _phi(),
    "gpt2": _gpt2(),
    "opt": _opt(),
    "bloom": _bloom(),
    "gptj": _gptj(),
    "gpt_neox": _gpt_neox(),
    "falcon": _falcon(),
}

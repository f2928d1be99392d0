"""Ragged (flat-token) transformer forward over a paged KV pool.

Counterpart of ``deepspeed_tpu/inference/v2/model_implementations/
flat_model.py:35-188``: tokens are a flat [T] buffer mixing prefill chunks
and decode steps of many sequences; per layer norm -> qkv -> RoPE -> KV
append -> paged attention -> o-proj -> MLP; only each sequence's last token
is projected to the vocabulary. It runs eagerly, one Python iteration per
layer over ``[l]`` views of the stacked weights, and updates the KV pools in
place.
"""

from typing import Any, Dict

import torch

from ....models.transformer import (TransformerConfig, apply_rope, mlp_activation,
                                   refuse_sparse_serving, rope_table)


def ragged_forward(cfg: TransformerConfig, block_size: int, params: Dict[str, Any], token_ids,
                   seq_idx, pos, valid, block_tables, last_idx, k_flat, v_flat,
                   modules: Dict[str, Any] = None, k_scale=None, v_scale=None):
    """Returns last-token logits [S_pad, V] (fp32).

    token_ids/seq_idx/pos: [T_pad] int32; valid: [T_pad] bool; block_tables:
    [S_pad, max_blocks] int32; last_idx: [S_pad]. k_flat/v_flat: the
    layer-flattened pools [L * pool_len + 1, nkv, d] whose last slot is
    scratch: invalid (padding) tokens append there. They are updated in
    place, as are ``k_scale``/``v_scale`` ([nkv, L * pool_len + 1] fp32),
    which select the int8 cache: each layer quantizes its fresh K/V per
    (token, kv head) with scale max(absmax / 127, 1e-8) and round-half-even
    before the append.
    """
    refuse_sparse_serving(cfg)
    if modules is None:
        from ..config_v2 import RaggedInferenceEngineConfig
        from ..modules.heuristics import build_modules

        ec = RaggedInferenceEngineConfig(kv_block_size=block_size)
        modules = build_modules(cfg, ec, use_kernels=token_ids.is_cuda)
    attention, linear = modules["attention"], modules["linear"]
    embedding, unembed, pre_norm = modules["embedding"], modules["unembed"], modules["norm"]
    T = token_ids.shape[0]
    nq, nkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    L = cfg.num_layers
    flat_len = k_flat.shape[0] - 1
    pool_len = flat_len // L
    NB = pool_len // block_size
    max_blocks = block_tables.shape[1]

    x = embedding(params, token_ids, pos)  # [T, H]
    sin, cos = rope_table(cfg, pos) if cfg.positions == "rotary" else (None, None)

    # flat KV slot of each token in layer 0; padding tokens go to the scratch
    # slot (their block index is clamped first: a decode step advances a pad
    # token's position past its table)
    pos64 = pos.long()
    blk = (pos64 // block_size).clamp_max(max_blocks - 1)
    slot = block_tables.long()[seq_idx.long(), blk] * block_size + pos64 % block_size
    quant = k_scale is not None
    blocks = params["blocks"]

    for l in range(L):
        blk_l = {name: w[l] for name, w in blocks.items()}
        h1 = pre_norm(x, blk_l["ln1_scale"], blk_l.get("ln1_bias"))
        bias = (lambda n: blk_l[n]) if cfg.use_bias else (lambda n: None)
        qkvb = (lambda n: blk_l[n]) if cfg.qkv_bias_enabled else (lambda n: None)
        q = linear(h1, blk_l["wq"], qkvb("bq")).reshape(T, nq, d)
        k = linear(h1, blk_l["wk"], qkvb("bk")).reshape(T, nkv, d)
        v = linear(h1, blk_l["wv"], qkvb("bv")).reshape(T, nkv, d)
        if cfg.positions == "rotary":
            q = apply_rope(q[None], sin, cos)[0]
            k = apply_rope(k[None], sin, cos)[0]

        slot_l = torch.where(valid, l * pool_len + slot, torch.full_like(slot, flat_len))
        if quant:
            k32, v32 = k.float(), v.float()
            ks = (k32.abs().amax(dim=-1) / 127.0).clamp_min(1e-8)  # [T, nkv]
            vs = (v32.abs().amax(dim=-1) / 127.0).clamp_min(1e-8)
            k = torch.round(k32 / ks[..., None])
            v = torch.round(v32 / vs[..., None])
            k_scale.index_copy_(1, slot_l, ks.t().contiguous())
            v_scale.index_copy_(1, slot_l, vs.t().contiguous())
        k_flat.index_copy_(0, slot_l, k.to(k_flat.dtype))
        v_flat.index_copy_(0, slot_l, v.to(v_flat.dtype))

        tables_l = block_tables + l * NB  # layer l's blocks in the flat pool
        scales = {"k_scale": k_scale, "v_scale": v_scale} if quant else {}
        ctx = attention(q, k_flat, v_flat, tables_l, seq_idx, pos, **scales)
        attn_out = linear(ctx.reshape(T, nq * d), blk_l["wo"], bias("bo"))

        def mlp(h):
            up = linear(h, blk_l["w_up"], bias("b_up"))
            if cfg.mlp == "swiglu":
                act = mlp_activation(cfg, up, linear(h, blk_l["w_gate"], None))
            else:
                act = mlp_activation(cfg, up)
            return linear(act, blk_l["w_down"], bias("b_down"))

        if cfg.parallel_residual:
            h2 = h1 if cfg.shared_ln else pre_norm(x, blk_l["ln2_scale"], blk_l.get("ln2_bias"))
            x = x + attn_out + mlp(h2)
        else:
            x = x + attn_out
            h2 = pre_norm(x, blk_l["ln2_scale"], blk_l.get("ln2_bias"))
            x = x + mlp(h2)

    return unembed(params, x, last_idx)

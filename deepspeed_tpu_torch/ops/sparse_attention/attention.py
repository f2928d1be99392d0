"""Sparse self-attention modules and integration utilities.

Counterpart of ``deepspeed_tpu/ops/sparse_attention/attention.py`` (the
reference's ``sparse_self_attention.py:12``, ``bert_sparse_self_attention.py
:10`` and ``sparse_attention_utils.py:14``), as ``nn.Module``s over
:func:`~deepspeed_tpu_torch.ops.block_sparse_attention.block_sparse_attention`.
``BertSparseSelfAttention`` keeps the JAX package's parameter names
(``query``/``key``/``value``, each ``{"kernel" [in, out], "bias" [out]}``),
so ``models.convert.load_sparse_attention_params`` moves a JAX ``init`` tree
across name for name.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..block_sparse_attention import block_sparse_attention, make_layout_lut
from .sparsity_config import SparsityConfig


class SparseSelfAttention(nn.Module):
    """Sparse self-attention over a blocked sparsity layout (reference
    ``sparse_self_attention.py:12``).

    q/k/v: [B, num_heads, L, head_dim]. The master layout is built once for
    ``max_seq_length`` and sliced per call-time L; each L's LUT is copied to
    the device once. ``causal='auto'`` (default) applies the token-level
    causal mask iff the sparsity config is unidirectional; set
    ``causal=False`` and pass ``attn_mask`` for the reference's behaviour.
    """

    def __init__(self, sparsity_config=None, key_padding_mask_mode="add", attn_mask_mode="mul",
                 max_seq_length=2048, causal="auto"):
        super().__init__()
        self.sparsity_config = sparsity_config or SparsityConfig(num_heads=4)
        self.master_layout = np.asarray(self.sparsity_config.make_layout(max_seq_length))
        self.key_padding_mask_mode = key_padding_mask_mode
        self.attn_mask_mode = attn_mask_mode
        if causal == "auto":
            causal = getattr(self.sparsity_config, "attention", "bidirectional") == "unidirectional"
        self.causal = bool(causal)
        self._lut_cache = {}  # (L, device) -> (layout, lut, nvalid)

    def get_layout(self, L):
        if L % self.sparsity_config.block != 0:
            raise ValueError(
                f"Sequence Length, {L}, needs to be dividable by Block size "
                f"{self.sparsity_config.block}!")
        num_blocks = L // self.sparsity_config.block
        if num_blocks > self.master_layout.shape[1]:
            raise ValueError(f"Sequence length {L} exceeds max_seq_length "
                             f"{self.master_layout.shape[1] * self.sparsity_config.block}")
        return self.master_layout[:, :num_blocks, :num_blocks]

    def forward(self, query, key, value, rpe=None, key_padding_mask=None, attn_mask=None):
        if query.shape != key.shape or key.shape != value.shape:
            raise NotImplementedError("only self-attention is supported for now")
        B, H, L, d = query.shape
        ck = (L, str(query.device))
        if ck not in self._lut_cache:
            layout = self.get_layout(L)
            lut, nvalid = make_layout_lut(layout)
            self._lut_cache[ck] = (layout, torch.as_tensor(lut, device=query.device),
                                   torch.as_tensor(nvalid, device=query.device))
        layout, lut, nvalid = self._lut_cache[ck]
        return block_sparse_attention(
            query, key, value, layout, self.sparsity_config.block, causal=self.causal,
            scale=1.0 / math.sqrt(d), rpe=rpe, key_padding_mask=key_padding_mask,
            attn_mask=attn_mask, key_padding_mask_mode=self.key_padding_mask_mode,
            attn_mask_mode=self.attn_mask_mode, lut=lut, nvalid=nvalid)


class BertSparseSelfAttention(nn.Module):
    """BERT self-attention block with sparse scores (reference
    ``bert_sparse_self_attention.py:10``): q/k/v projections followed by
    :class:`SparseSelfAttention`. ``forward(hidden_states, attention_mask)``
    returns the context layer [B, L, hidden].

    Parameters ``query``/``key``/``value`` hold fp32 ``kernel`` [hidden,
    hidden] (``[in, out]``, drawn from ``seed`` with std 1/sqrt(hidden)) and
    ``bias`` (zeros), on ``device`` (default CUDA).
    ``key_padding_mask_mode``: the default ``'mul'`` expects 0/1 indicator
    masks (0 = padded, as :meth:`SparseAttentionUtils.pad_to_block_size`
    makes them); pass ``'add'`` for pre-scaled additive masks."""

    def __init__(self, num_attention_heads, hidden_size, sparsity_config=None,
                 max_seq_length=2048, key_padding_mask_mode="mul", *, device=None, seed=0):
        super().__init__()
        if hidden_size % num_attention_heads != 0:
            raise ValueError(
                f"The hidden size ({hidden_size}) is not a multiple of the number of attention "
                f"heads ({num_attention_heads})")
        from ...models.transformer import resolve_device

        self.num_attention_heads = num_attention_heads
        self.hidden_size = hidden_size
        self.attention_head_size = hidden_size // num_attention_heads
        cfg = sparsity_config or SparsityConfig(num_heads=num_attention_heads)
        self.sparse_self_attention = SparseSelfAttention(
            cfg, max_seq_length=max_seq_length, key_padding_mask_mode=key_padding_mask_mode)
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        std = 1.0 / math.sqrt(hidden_size)
        for name in ("query", "key", "value"):
            kernel = torch.randn((hidden_size, hidden_size), generator=gen, device=dev) * std
            setattr(self, name, nn.ParameterDict({
                "kernel": nn.Parameter(kernel),
                "bias": nn.Parameter(torch.zeros((hidden_size, ), device=dev))}))

    def _split_heads(self, x):
        B, L, _ = x.shape
        return x.reshape(B, L, self.num_attention_heads, self.attention_head_size).transpose(1, 2)

    def forward(self, hidden_states, attention_mask=None):
        q, k, v = (self._split_heads(hidden_states @ p["kernel"] + p["bias"])
                   for p in (self.query, self.key, self.value))
        ctx = self.sparse_self_attention(q, k, v, key_padding_mask=attention_mask)
        B, H, L, d = ctx.shape
        return ctx.transpose(1, 2).reshape(B, L, H * d)


class SparseAttentionUtils:
    """Helpers for integrating sparse attention into transformer models
    (reference ``sparse_attention_utils.py:14``), over tensors."""

    @staticmethod
    def extend_position_embedding(pos_embedding, max_position):
        """Tile an existing [P, hidden] position-embedding table to cover
        ``max_position`` (reference :21)."""
        P = pos_embedding.shape[0]
        if max_position <= P:
            return pos_embedding[:max_position]
        reps = -(-max_position // P)
        return pos_embedding.repeat(reps, 1)[:max_position]

    @staticmethod
    def update_tokenizer_model_max_length(tokenizer, max_position):
        """Reference :64 — bump the tokenizer's model_max_length."""
        tokenizer.model_max_length = max_position
        if hasattr(tokenizer, "init_kwargs"):
            tokenizer.init_kwargs["model_max_length"] = max_position
        return tokenizer

    @staticmethod
    def pad_to_block_size(block_size, input_ids=None, attention_mask=None, token_type_ids=None,
                          position_ids=None, inputs_embeds=None, pad_token_id=0,
                          model_embeddings=None):
        """Pad sequence-dim inputs up to a multiple of ``block_size``
        (reference :143). Returns ``(pad_len, input_ids, attention_mask,
        token_type_ids, position_ids, inputs_embeds)`` with None passed
        through. Padded attention_mask positions are 0 so the key-padding
        mask masks them out. ``model_embeddings``: an embedding table
        [V, hidden] or a module called on the pad ids."""
        seq_len = None
        for t in (input_ids, attention_mask, token_type_ids, position_ids):
            if t is not None:
                seq_len = t.shape[1]
                break
        if seq_len is None and inputs_embeds is not None:
            seq_len = inputs_embeds.shape[1]
        if seq_len is None:
            raise ValueError("at least one sequence input must be provided")
        pad_len = (block_size - seq_len % block_size) % block_size
        if pad_len == 0:
            return 0, input_ids, attention_mask, token_type_ids, position_ids, inputs_embeds

        def pad_ids(t, value):
            return None if t is None else F.pad(t, (0, pad_len), value=value)

        input_ids = pad_ids(input_ids, pad_token_id)
        attention_mask = pad_ids(attention_mask, 0)
        token_type_ids = pad_ids(token_type_ids, 0)
        position_ids = pad_ids(position_ids, 0)
        if inputs_embeds is not None:
            B, _, hidden = inputs_embeds.shape
            if model_embeddings is not None:
                ids = torch.full((B, pad_len), pad_token_id, dtype=torch.long,
                                 device=inputs_embeds.device)
                pad_embed = (model_embeddings[ids] if torch.is_tensor(model_embeddings)
                             else model_embeddings(ids))
            else:
                pad_embed = inputs_embeds.new_zeros((B, pad_len, hidden))
            inputs_embeds = torch.cat([inputs_embeds, pad_embed.to(inputs_embeds.dtype)], dim=1)
        return pad_len, input_ids, attention_mask, token_type_ids, position_ids, inputs_embeds

    @staticmethod
    def unpad_sequence_output(pad_len, sequence_output):
        """Reference :193 — strip the padding added by pad_to_block_size."""
        if pad_len > 0:
            sequence_output = sequence_output[:, :-pad_len]
        return sequence_output

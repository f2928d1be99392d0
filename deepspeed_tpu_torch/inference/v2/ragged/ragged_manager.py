"""Sequence state manager.

Counterpart of ``deepspeed_tpu/inference/v2/ragged/ragged_manager.py``:
tracked sequences -> KV block tables, owning the :class:`BlockedKVCache`.
This slice has no prefix cache, cache telemetry or host tier: enabling the
prefix cache raises, ``note_tokens``/``publish_sequence`` do nothing, and
every block a sequence holds is its own (refcount 1).
"""

from typing import Dict, Optional, Tuple

import torch

from .kv_cache import BlockedKVCache
from .sequence_descriptor import DSSequenceDescriptor


class DSStateManager:

    def __init__(self, num_layers: int, num_kv_heads: int, head_dim: int, *,
                 max_tracked_sequences: int = 128, num_blocks: int = 256, block_size: int = 64,
                 dtype=torch.bfloat16, device=None, prefix_cache_config=None):
        if prefix_cache_config is not None and getattr(prefix_cache_config, "enabled", False):
            raise NotImplementedError("the prefix cache is not ported to the PyTorch package "
                                      "yet; set ragged prefix_cache.enabled=False")
        self.max_tracked_sequences = max_tracked_sequences
        self.block_size = block_size
        self.kv_cache = BlockedKVCache(num_layers, num_kv_heads, head_dim, num_blocks, block_size,
                                       dtype=dtype, device=device)
        self.prefix_cache = None
        self._seqs: Dict[int, DSSequenceDescriptor] = {}

    # -- queries -----------------------------------------------------------
    @property
    def n_tracked_sequences(self) -> int:
        return len(self._seqs)

    @property
    def free_blocks(self) -> int:
        return self.kv_cache.free_blocks

    @property
    def available_blocks(self) -> int:
        """Blocks a new allocation could obtain (the free list: no cache to
        evict from in this slice)."""
        return self.kv_cache.free_blocks

    def query(self, uid: Optional[int] = None):
        """Per-sequence state, or the (tracked, free-block) summary."""
        if uid is None:
            return {"tracked": self.n_tracked_sequences, "free_blocks": self.free_blocks}
        return self._seqs.get(uid)

    # -- lifecycle ---------------------------------------------------------
    def get_sequence(self, uid: int) -> Optional[DSSequenceDescriptor]:
        return self._seqs.get(uid)

    def create_sequence_with_prefix(self, uid: int, prompt_tokens,
                                    match=None) -> Tuple[DSSequenceDescriptor, int]:
        """Create a fresh sequence. Without a prefix cache nothing is ever
        cached: returns ``(seq, 0)``."""
        if uid in self._seqs:
            raise ValueError(f"uid {uid} already tracked: sequence creation is create-only")
        if len(self._seqs) >= self.max_tracked_sequences:
            raise RuntimeError(f"already tracking {self.max_tracked_sequences} sequences")
        seq = DSSequenceDescriptor(uid=uid, block_size=self.block_size)
        self._seqs[uid] = seq
        return seq, 0

    def allocate_blocks(self, seq: DSSequenceDescriptor, new_tokens: int) -> None:
        need = seq.blocks_needed(new_tokens)
        if need > 0:
            seq.extend_blocks(self.kv_cache.reserve(need))

    def note_tokens(self, seq: DSSequenceDescriptor, tokens) -> None:
        """Token history feeds the prefix cache, which this slice lacks."""

    def publish_sequence(self, seq: DSSequenceDescriptor) -> None:
        """Publishing feeds the prefix cache, which this slice lacks."""

    def rollback_to(self, seq: DSSequenceDescriptor, n_tokens: int, final: bool = False) -> int:
        """Rewind ``seen_tokens`` to ``n_tokens`` and release the tail blocks
        that no longer hold kept KV (decode-horizon overshoot past an eos).
        Returns the number of blocks released. ``final`` is accepted for the
        TPU package's call surface: with no shared blocks there is no
        copy-on-write guard to skip."""
        n_tokens = int(n_tokens)
        if not 0 <= n_tokens <= seq.seen_tokens:
            raise ValueError(f"rollback_to({n_tokens}): sequence {seq.uid} has "
                             f"{seq.seen_tokens} materialized tokens")
        if seq.in_flight_tokens:
            raise RuntimeError(f"rollback_to on sequence {seq.uid} with "
                               f"{seq.in_flight_tokens} tokens in flight: rewinds happen "
                               "BETWEEN forwards only")
        keep = -(-n_tokens // self.block_size)
        tail = seq.kv_blocks[keep:]
        del seq.kv_blocks[keep:]
        if tail:
            self.kv_cache.release(tail)
        seq.seen_tokens = n_tokens
        return len(tail)

    def flush_sequence(self, uid: int) -> None:
        """Release a finished sequence's blocks."""
        seq = self._seqs.pop(uid, None)
        if seq is not None and seq.kv_blocks:
            self.kv_cache.release(seq.kv_blocks)

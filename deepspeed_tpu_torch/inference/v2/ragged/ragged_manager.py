"""Sequence state manager.

Counterpart of ``deepspeed_tpu/inference/v2/ragged/ragged_manager.py:26-329``
without the tenant meter and speculative commits: tracked sequences -> KV
block tables, owning the :class:`BlockedKVCache`. With ``prefix_cache``
enabled it also owns the :class:`PrefixKVCache` radix tree (and, when
configured, its cache telemetry and host tier): sequence creation
pre-populates the block table and ``seen_tokens`` from the longest cached
prefix, completed full blocks are published back, and every release goes
through the refcounts.
"""

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .cache_telemetry import CacheTelemetry
from .kv_cache import BlockedKVCache
from .prefix_cache import PrefixKVCache
from .sequence_descriptor import DSSequenceDescriptor
from .tiered_store import TieredBlockStore


class DSStateManager:

    def __init__(self, num_layers: int, num_kv_heads: int, head_dim: int, *,
                 max_tracked_sequences: int = 128, num_blocks: int = 256, block_size: int = 64,
                 dtype=torch.bfloat16, device=None, prefix_cache_config=None):
        self.max_tracked_sequences = max_tracked_sequences
        self.block_size = block_size
        self.kv_cache = BlockedKVCache(num_layers, num_kv_heads, head_dim, num_blocks, block_size,
                                       dtype=dtype, device=device)
        # each of these exists only when its config block enables it
        self.prefix_cache: Optional[PrefixKVCache] = None
        self.tiered_store = None
        self.cache_telemetry: Optional[CacheTelemetry] = None
        if prefix_cache_config is not None and getattr(prefix_cache_config, "enabled", False):
            tel_cfg = getattr(prefix_cache_config, "telemetry", None)
            if tel_cfg is not None and getattr(tel_cfg, "enabled", False):
                self.cache_telemetry = CacheTelemetry(self.kv_cache, config=tel_cfg)
                self.cache_telemetry.occupancy_provider = self._occupancy
                self.kv_cache.set_telemetry(self.cache_telemetry)
            self.prefix_cache = PrefixKVCache(self.kv_cache,
                                              min_hit_blocks=prefix_cache_config.min_hit_blocks,
                                              eviction=prefix_cache_config.eviction,
                                              telemetry=self.cache_telemetry)
            ht_cfg = getattr(prefix_cache_config, "host_tier", None)
            if ht_cfg is not None and getattr(ht_cfg, "enabled", False):
                self.tiered_store = TieredBlockStore(self.kv_cache, ht_cfg,
                                                     telemetry=self.cache_telemetry)
                self.prefix_cache.attach_tier(self.tiered_store)
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
        """Blocks a new allocation could obtain: the free list plus what LRU
        eviction could reclaim from tree-only holders. Admission budgets
        against this: a warm cache keeps the free list near empty."""
        free = self.kv_cache.free_blocks
        if self.prefix_cache is not None:
            free += self.prefix_cache.evictable_blocks
        return free

    def _occupancy(self):
        """(used token slots, allocated blocks) over live sequences: the
        telemetry's fragmentation."""
        used = allocated = 0
        bs = self.block_size
        for seq in list(self._seqs.values()):
            allocated += len(seq.kv_blocks)
            used += min(seq.seen_tokens + seq.in_flight_tokens, len(seq.kv_blocks) * bs)
        return used, allocated

    def query(self, uid: Optional[int] = None):
        """Per-sequence state, or the engine summary (tracked, free blocks,
        the prefix cache's stats and the host tier's, when present)."""
        if uid is None:
            out = {"tracked": self.n_tracked_sequences, "free_blocks": self.free_blocks}
            if self.prefix_cache is not None:
                out["prefix_cache"] = dict(self.prefix_cache.stats,
                                           cached_blocks=self.prefix_cache.n_cached_blocks,
                                           hit_rate=self.prefix_cache.hit_rate)
            if self.tiered_store is not None:
                out["host_tier"] = self.tiered_store.snapshot()
            return out
        return self._seqs.get(uid)

    # -- lifecycle ---------------------------------------------------------
    def get_sequence(self, uid: int) -> Optional[DSSequenceDescriptor]:
        return self._seqs.get(uid)

    def create_sequence_with_prefix(self, uid: int, prompt_tokens,
                                    match=None) -> Tuple[DSSequenceDescriptor, int]:
        """Create a fresh sequence, pre-populated from the prefix cache when
        ``prompt_tokens`` (the tokens about to be fed) hit the radix tree:
        the block table starts with the shared run (plus a copy-on-write
        tail) and ``seen_tokens`` at the hit length. ``match`` (from a prior
        probe) skips the re-match. Returns ``(seq, n_cached_tokens)``: the
        caller skips the first ``n_cached_tokens`` of ``prompt_tokens``."""
        if uid in self._seqs:
            raise ValueError(f"uid {uid} already tracked: sequence creation is create-only")
        if len(self._seqs) >= self.max_tracked_sequences:
            raise RuntimeError(f"already tracking {self.max_tracked_sequences} sequences")
        seq = DSSequenceDescriptor(uid=uid, block_size=self.block_size)
        n_cached = 0
        if self.prefix_cache is not None and prompt_tokens is not None:
            prompt_tokens = np.asarray(prompt_tokens).reshape(-1)
            blocks, n_cached, shared = self.prefix_cache.acquire(prompt_tokens, match=match)
            if n_cached:
                seq.kv_blocks = [int(b) for b in blocks]
                seq.seen_tokens = n_cached
                seq.shared_blocks = shared
                seq.prefix_cached_tokens = n_cached
                seq.token_history = [int(t) for t in prompt_tokens[:n_cached]]
        self._seqs[uid] = seq
        return seq, n_cached

    def allocate_blocks(self, seq: DSSequenceDescriptor, new_tokens: int) -> None:
        """Reserve the blocks ``new_tokens`` more tokens need. A dry free
        list evicts LRU tree-only blocks first; with a host tier, a pool
        below its low watermark demotes cold leaves."""
        need = seq.blocks_needed(new_tokens)
        if need > 0:
            if self.prefix_cache is not None and need > self.kv_cache.free_blocks:
                self.prefix_cache.evict(need - self.kv_cache.free_blocks)
            seq.extend_blocks(self.kv_cache.reserve(need))
        if self.tiered_store is not None:
            target = self.tiered_store.demotion_target()
            if target > 0:
                self.prefix_cache.demote_cold(target)

    def note_tokens(self, seq: DSSequenceDescriptor, tokens) -> None:
        """Record the token ids being materialized this forward so completed
        full blocks can be published. A gap the host never saw stops
        publishing for this sequence for good."""
        if self.prefix_cache is None or not seq.history_valid:
            return
        if len(seq.token_history) != seq.seen_tokens:
            seq.history_valid = False
            return
        seq.token_history.extend(int(t) for t in np.asarray(tokens).reshape(-1))

    def publish_sequence(self, seq: DSSequenceDescriptor) -> None:
        """Insert ``seq``'s completed full blocks into the radix tree."""
        if self.prefix_cache is not None and seq.history_valid:
            self.prefix_cache.publish(seq)

    def rollback_to(self, seq: DSSequenceDescriptor, n_tokens: int, final: bool = False) -> int:
        """Rewind ``seen_tokens`` (and the token history) to ``n_tokens`` and
        release the tail blocks that no longer hold kept KV; a block shared
        with the tree or another sequence only loses this sequence's
        reference. Returns the references released.

        A rewind that lands mid-block in a still-shared block copies it
        first: the sequence's next tokens will be written into its tail
        slots. The copy is reserved before any state changes, so a dry pool
        fails the call with the sequence untouched. ``final=True`` skips the
        copy: the caller flushes the sequence next and never writes again."""
        n_tokens = int(n_tokens)
        if not 0 <= n_tokens <= seq.seen_tokens:
            raise ValueError(f"rollback_to({n_tokens}): sequence {seq.uid} has "
                             f"{seq.seen_tokens} materialized tokens")
        if seq.in_flight_tokens:
            raise RuntimeError(f"rollback_to on sequence {seq.uid} with "
                               f"{seq.in_flight_tokens} tokens in flight: rewinds happen "
                               "BETWEEN forwards only")
        bs = self.block_size
        keep = -(-n_tokens // bs)  # blocks still (partially) holding kept KV
        cow_src = cow_dst = None
        if (not final and n_tokens % bs and keep
                and self.kv_cache.refcount(seq.kv_blocks[keep - 1]) > 1):
            cow_src = seq.kv_blocks[keep - 1]
            if self.prefix_cache is not None and self.kv_cache.free_blocks < 1:
                self.prefix_cache.evict(1)
            cow_dst = int(self.kv_cache.reserve(1)[0])
            self.kv_cache.copy_block(cow_src, cow_dst)
        tail = seq.kv_blocks[keep:]
        del seq.kv_blocks[keep:]
        if tail:
            self.kv_cache.release(tail)
        seq.seen_tokens = n_tokens
        if len(seq.token_history) > n_tokens:
            del seq.token_history[n_tokens:]
        seq.published_blocks = min(seq.published_blocks, n_tokens // bs)
        seq.shared_blocks = min(seq.shared_blocks, keep)
        if cow_dst is not None:
            seq.kv_blocks[keep - 1] = cow_dst
            self.kv_cache.release(cow_src)
            seq.shared_blocks = min(seq.shared_blocks, keep - 1)
        return len(tail)

    def shutdown(self) -> None:
        """Stop the host tier's migration worker (a no-op without a tier)."""
        if self.tiered_store is not None:
            self.tiered_store.shutdown()

    def flush_sequence(self, uid: int) -> None:
        """Release a finished sequence's references, publishing its completed
        full blocks first (the tree takes its own reference)."""
        seq = self._seqs.pop(uid, None)
        if seq is None:
            return
        self.publish_sequence(seq)
        if seq.kv_blocks:
            self.kv_cache.release(seq.kv_blocks)

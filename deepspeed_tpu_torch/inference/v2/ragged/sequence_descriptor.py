"""Per-sequence tracking state (copy of
``deepspeed_tpu/inference/v2/ragged/sequence_descriptor.py``)."""

from dataclasses import dataclass, field
from typing import List

import numpy as np


@dataclass
class DSSequenceDescriptor:
    uid: int
    block_size: int
    seen_tokens: int = 0  # tokens whose KV is already materialized
    in_flight_tokens: int = 0  # tokens scheduled in the current forward
    kv_blocks: List[int] = field(default_factory=list)
    # prefix-cache bookkeeping: the token ids behind the materialized KV (so
    # completed full blocks can be published into the radix tree), how many
    # leading blocks arrived shared from the tree, and how many prompt tokens
    # the cache let prefill skip. ``history_valid`` drops to False when
    # generated tokens never reached the host (decode(block=False)):
    # publishing then stops at the last known-token boundary.
    token_history: List[int] = field(default_factory=list)
    history_valid: bool = True
    shared_blocks: int = 0
    prefix_cached_tokens: int = 0
    published_blocks: int = 0  # publish() cursor: full blocks already walked
    tenant: str = None  # owner identity stamped on published tree nodes

    @property
    def cur_allocated_blocks(self) -> int:
        return len(self.kv_blocks)

    @property
    def max_context(self) -> int:
        return len(self.kv_blocks) * self.block_size

    def blocks_needed(self, new_tokens: int) -> int:
        """Additional blocks required to hold ``new_tokens`` more KV entries."""
        total = self.seen_tokens + new_tokens
        need = -(-total // self.block_size)
        return max(0, need - len(self.kv_blocks))

    def extend_blocks(self, blocks) -> None:
        self.kv_blocks.extend(int(b) for b in np.atleast_1d(blocks))

    def pre_forward(self, num_tokens: int) -> None:
        self.in_flight_tokens = num_tokens

    def post_forward(self) -> None:
        self.seen_tokens += self.in_flight_tokens
        self.in_flight_tokens = 0

    def block_table(self, max_blocks: int) -> np.ndarray:
        out = np.zeros(max_blocks, dtype=np.int32)
        n = min(len(self.kv_blocks), max_blocks)
        out[:n] = self.kv_blocks[:n]
        return out

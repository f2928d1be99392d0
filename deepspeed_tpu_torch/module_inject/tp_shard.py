"""TP shard-size math (reference ``module_inject/tp_shard.py``):
kv-head-aware uneven sharding — when the kv-head count doesn't divide the
TP degree, earlier ranks take one extra head's worth of columns."""

from typing import List, Optional

num_kv_heads: Optional[int] = None


def set_num_kv_heads(num: Optional[int]):
    global num_kv_heads
    num_kv_heads = num


def get_num_kv_heads() -> Optional[int]:
    return num_kv_heads


def get_shard_size(total_size: int, mp_size: int, rank: int = 0) -> int:
    if num_kv_heads is not None:
        sizes = get_shard_size_list(total_size, mp_size)
        return sizes[rank]
    assert total_size % mp_size == 0, \
        f"size {total_size} must be divisible by mp_size {mp_size} (no kv-head count set)"
    return total_size // mp_size


def get_shard_size_list(total_size: int, mp_size: int) -> List[int]:
    """Per-rank sizes that ALWAYS sum to ``total_size``: a remainder from
    total_size % num_kv_heads goes to the last rank (the reference's
    assignment) so no columns are silently orphaned."""
    if num_kv_heads is None:
        return [get_shard_size(total_size, mp_size, r) for r in range(mp_size)]
    sizes = [total_size * (num_kv_heads // mp_size + (1 if r < num_kv_heads % mp_size else 0))
             // num_kv_heads for r in range(mp_size)]
    sizes[-1] += total_size - sum(sizes)
    return sizes

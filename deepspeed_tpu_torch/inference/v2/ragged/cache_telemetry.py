"""KV-cache observability: block lifecycle accounting and an online
miss-ratio-curve estimator.

Counterpart of ``deepspeed_tpu/inference/v2/ragged/cache_telemetry.py:57-503``
without its emission to a metrics registry, flight recorder or tracer (the
port has no monitor yet): every value stays readable from the objects.

* :class:`CacheTelemetry`: per-block lifecycle tracking fed by hooks in the
  allocator (allocate / physical free), the prefix cache (publish / hit /
  evict) and the host tier (demote / promote); refcount classes (active /
  tree-only / free), occupancy and its time integral, fragmentation, and
  histograms of block age, reuse interval and eviction-victim age.
* :class:`MRCEstimator`: SHARDS-style sampled reuse distances (Waldspurger
  et al., FAST'15) over the radix lookups' block-chunk keys, predicting
  the hit rate at multiples of the pool's capacity.

With ``ragged.prefix_cache.telemetry`` absent or off no object of this
module exists and every hook site is one ``is not None`` check.
"""

import bisect
import math
import threading
import time
import zlib
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np

# seconds-scale buckets for block-lifecycle histograms
AGE_BUCKETS_S = (0.001, 0.005, 0.02, 0.1, 0.5, 2.0, 10.0, 60.0, 300.0,
                 1800.0, 7200.0, 43200.0)


def chunk_key(prev: int, tokens) -> int:
    """Rolling 32-bit key of one block-aligned token chunk, chained on the
    previous chunk's key: the radix-tree path identity, the same in every
    process (crc32, not ``hash``)."""
    return zlib.crc32(np.ascontiguousarray(tokens, dtype=np.int64).tobytes(),
                      prev) & 0xFFFFFFFF


class Histogram:
    """Fixed-bucket histogram with exact nearest-rank percentiles over the
    last ``window`` observations (copy of the JAX package's
    ``monitor.metrics.Histogram``)."""

    __slots__ = ("name", "buckets", "bucket_counts", "count", "total", "_raw", "_lock")

    def __init__(self, name, buckets=AGE_BUCKETS_S, window=4096):
        self.name = name
        self.buckets = tuple(sorted(buckets))
        self.bucket_counts = [0] * (len(self.buckets) + 1)  # last = +inf
        self.count = 0
        self.total = 0.0
        self._raw = deque(maxlen=window)
        self._lock = threading.Lock()  # the migration worker observes too

    def observe(self, v):
        v = float(v)
        with self._lock:
            self.bucket_counts[bisect.bisect_left(self.buckets, v)] += 1
            self.count += 1
            self.total += v
            self._raw.append(v)

    def percentile(self, p, _sorted=None):
        if _sorted is not None:
            data = _sorted
        else:
            with self._lock:
                data = sorted(self._raw)
        if not data:
            return 0.0
        rank = min(len(data), max(1, math.ceil(p / 100.0 * len(data))))
        return data[rank - 1]

    def summary(self):
        with self._lock:
            data = sorted(self._raw)
            count, total = self.count, self.total
        return {"count": count, "mean": total / count if count else 0.0,
                "p50": self.percentile(50, data), "p90": self.percentile(90, data),
                "p99": self.percentile(99, data)}


class MRCEstimator:
    """Online miss-ratio curve from sampled reuse distances.

    A reference at LRU stack distance ``d`` (distinct keys touched since the
    key's previous access) hits in an LRU cache of ``C`` blocks iff
    ``d < C``. Keys are sampled at rate ``R`` by key value and each sampled
    rank is scaled by ``1/R``; at most ``max_tracked`` keys are kept (the
    coldest is dropped, and its next access counts as a cold miss).

    ``record(keys, observed_hits)`` feeds demand references (admission-side
    lookups: counted, and they update recency); ``note_insert(keys)`` feeds
    publish-side insertions, which consume capacity without being counted.
    """

    def __init__(self, capacity_blocks: int, sample_rate: float = 0.25,
                 max_tracked: int = 4096,
                 capacity_mults: Tuple[float, ...] = (0.5, 1.0, 2.0, 4.0, 8.0)):
        if not 0.0 < sample_rate <= 1.0:
            raise ValueError(f"sample_rate must be in (0, 1], got {sample_rate}")
        if capacity_blocks < 1:
            raise ValueError(f"capacity_blocks must be >= 1, got {capacity_blocks}")
        self.capacity_blocks = int(capacity_blocks)
        self.sample_rate = float(sample_rate)
        self.max_tracked = max(16, int(max_tracked))
        self.capacity_mults = tuple(float(m) for m in capacity_mults)
        self._threshold = int(self.sample_rate * (1 << 32))
        self._stamp = 0
        self._last: Dict[int, int] = {}     # sampled key -> last-access stamp
        self._stamps: List[int] = []        # the same stamps, ascending
        self._keys: List[int] = []          # parallel to _stamps
        self._hits = [0] * len(self.capacity_mults)
        self._refs_sampled = 0
        self.refs_total = 0
        self.observed_hits = 0

    def record(self, keys, observed_hits: int = 0) -> None:
        """One lookup's ordered full-block chunk keys and how many of them
        the real cache served."""
        for k in keys:
            self._access(int(k), counted=True)
        self.refs_total += len(keys)
        self.observed_hits += int(observed_hits)

    def note_insert(self, keys) -> None:
        for k in keys:
            self._access(int(k), counted=False)

    def _access(self, key: int, counted: bool) -> None:
        if key >= self._threshold:  # unsampled
            return
        self._stamp += 1
        prev = self._last.get(key)
        if prev is not None:
            idx = bisect.bisect_left(self._stamps, prev)
            rank = len(self._stamps) - idx - 1  # distinct sampled keys since
            self._stamps.pop(idx)
            self._keys.pop(idx)
            if counted:
                self._refs_sampled += 1
                dist = rank / self.sample_rate
                for i, m in enumerate(self.capacity_mults):
                    if dist < m * self.capacity_blocks:
                        self._hits[i] += 1
        else:
            if counted:
                self._refs_sampled += 1  # cold miss
            if len(self._last) >= self.max_tracked:
                self._last.pop(self._keys.pop(0), None)
                self._stamps.pop(0)
        self._last[key] = self._stamp
        self._stamps.append(self._stamp)
        self._keys.append(key)

    def predict(self) -> Dict[float, Optional[float]]:
        """Predicted hit rate per capacity multiplier (None before any
        sampled reference)."""
        if self._refs_sampled == 0:
            return {m: None for m in self.capacity_mults}
        return {m: self._hits[i] / self._refs_sampled
                for i, m in enumerate(self.capacity_mults)}

    @property
    def observed_hit_rate(self) -> Optional[float]:
        if not self.refs_total:
            return None
        return self.observed_hits / self.refs_total

    @property
    def tracked_keys(self) -> int:
        return len(self._last)

    def reset(self) -> None:
        self._stamp = 0
        self._last.clear()
        self._stamps.clear()
        self._keys.clear()
        self._hits = [0] * len(self.capacity_mults)
        self._refs_sampled = 0
        self.refs_total = 0
        self.observed_hits = 0


class CacheTelemetry:
    """Per-block lifecycle accounting and the MRC estimator, owned by the
    state manager when ``ragged.prefix_cache.telemetry`` is enabled. Hooks
    are O(blocks touched); gauges are computed on demand (``snapshot``)."""

    def __init__(self, kv_cache, config=None, clock=time.perf_counter):
        self.kv = kv_cache
        self._clock = clock
        nb = kv_cache.num_blocks
        self.block_size = kv_cache.block_size
        self._alloc_t = np.zeros(nb, np.float64)   # last allocate
        self._access_t = np.zeros(nb, np.float64)  # last tree touch
        self._tree_held = np.zeros(nb, bool)
        self.counters = {"allocated": 0, "freed": 0, "published": 0,
                         "hit_blocks": 0, "evicted": 0,
                         "demote_queued": 0, "demoted": 0, "promoted": 0}
        self._new_histograms()
        # host-tier occupancy-time integral (absolute used counts reported
        # by the tier on every transition)
        self._host_occ_blocks = 0
        self._host_occ_last_t = self._clock()
        self._host_occ_integral_s = 0.0
        # HBM occupancy-time integral, advanced at every allocate / free
        self._occ_blocks = 0
        self._occ_last_t = self._clock()
        self._occ_integral_s = 0.0
        sample_rate = getattr(config, "mrc_sample_rate", 0.25) if config else 0.25
        max_tracked = getattr(config, "mrc_max_tracked", 4096) if config else 4096
        mults = getattr(config, "mrc_capacity_mults", None) if config else None
        self.mrc = MRCEstimator(nb, sample_rate=sample_rate, max_tracked=max_tracked,
                                capacity_mults=mults or (0.5, 1.0, 2.0, 4.0, 8.0))
        # (used_token_slots, seq_allocated_blocks) over live sequences, set
        # by the owning state manager; None keeps fragmentation at 0
        self.occupancy_provider = None

    def _new_histograms(self) -> None:
        self.block_age_s = Histogram("cache/block_age_s")
        self.reuse_interval_s = Histogram("cache/reuse_interval_s")
        self.evicted_block_age_s = Histogram("cache/evicted_block_age_s")
        self.promote_latency_s = Histogram("cache/promote_latency_s")
        self.demote_latency_s = Histogram("cache/demote_latency_s")

    def _advance_occupancy(self, now, delta_blocks) -> None:
        self._occ_integral_s += self._occ_blocks * max(0.0, now - self._occ_last_t)
        self._occ_last_t = now
        self._occ_blocks = max(0, self._occ_blocks + delta_blocks)

    def occupancy_integral_s(self) -> float:
        """Block-seconds of pool occupancy since construction."""
        now = self._clock()
        return self._occ_integral_s + self._occ_blocks * max(0.0, now - self._occ_last_t)

    # -- allocator hooks ---------------------------------------------------
    def on_allocate(self, blocks) -> None:
        now = self._clock()
        self._advance_occupancy(now, len(blocks))
        self._alloc_t[np.asarray(blocks, np.int64)] = now
        self.counters["allocated"] += len(blocks)

    def on_free(self, blocks) -> None:
        """Physical frees (refcount zero): block age = allocate -> free."""
        now = self._clock()
        self._advance_occupancy(now, -len(blocks))
        for b in blocks:
            self.block_age_s.observe(now - self._alloc_t[b])
            self._tree_held[b] = False
        self.counters["freed"] += len(blocks)

    # -- prefix-cache hooks (under the tree lock) --------------------------
    def on_publish(self, block: int) -> None:
        b = int(block)
        self._access_t[b] = self._clock()
        self._tree_held[b] = True
        self.counters["published"] += 1

    def on_hit(self, blocks) -> None:
        """A lookup took references on shared tree blocks: the time since
        each block's previous tree touch is its reuse interval."""
        now = self._clock()
        for b in blocks:
            prev = self._access_t[b]
            if prev > 0.0:
                self.reuse_interval_s.observe(now - prev)
            self._access_t[b] = now
        self.counters["hit_blocks"] += len(blocks)

    def on_evict(self, block: int) -> None:
        """Eviction victim: its age since the last touch."""
        b = int(block)
        now = self._clock()
        age = now - (self._access_t[b] if self._access_t[b] > 0.0 else self._alloc_t[b])
        self.evicted_block_age_s.observe(age)
        self._tree_held[b] = False
        self.counters["evicted"] += 1

    def on_tree_clear(self, blocks) -> None:
        """``PrefixKVCache.clear``: the tree reference is gone, not by LRU
        pressure (no victim ages)."""
        self._tree_held[np.asarray(list(blocks), np.int64)] = False

    # -- tier hooks ----------------------------------------------------------
    def on_demote_queued(self, block: int) -> None:
        self.counters["demote_queued"] += 1
        self._tree_held[int(block)] = False

    def on_demote(self, host_used_blocks: int, wait_s: float = 0.0) -> None:
        """The migration worker finalized one demotion (``wait_s``: enqueue
        -> resident)."""
        self.counters["demoted"] += 1
        self.demote_latency_s.observe(max(0.0, wait_s))
        self.note_host_used(host_used_blocks)

    def on_promote(self, block: int, wait_s: float = 0.0, from_disk: bool = False) -> None:
        """A demoted block came back to the device on the admission path."""
        self.counters["promoted"] += 1
        self._tree_held[int(block)] = True
        self._access_t[int(block)] = self._clock()
        self.promote_latency_s.observe(max(0.0, wait_s))

    def note_host_used(self, used_blocks: int) -> None:
        now = self._clock()
        self._host_occ_integral_s += self._host_occ_blocks * max(0.0, now - self._host_occ_last_t)
        self._host_occ_last_t = now
        self._host_occ_blocks = max(0, int(used_blocks))

    def host_occupancy_integral_s(self) -> float:
        now = self._clock()
        return self._host_occ_integral_s + self._host_occ_blocks * max(0.0, now - self._host_occ_last_t)

    # -- MRC feed (under the tree lock) ---------------------------------------
    def record_lookup(self, keys, observed_hits: int) -> None:
        self.mrc.record(keys, observed_hits)

    def record_inserts(self, keys) -> None:
        self.mrc.note_insert(keys)

    # -- read side -----------------------------------------------------------
    def refcount_classes(self) -> Dict[str, int]:
        """The pool by holder class: ``free`` (refcount 0), ``tree_only``
        (the radix tree is the sole holder: evictable), ``active``."""
        rc = self.kv.refcount_snapshot()
        free = int((rc == 0).sum())
        tree_only = int(((rc == 1) & self._tree_held).sum())
        return {"free": free, "tree_only": tree_only,
                "active": int(rc.size) - free - tree_only}

    def occupancy(self) -> float:
        total = self.kv.total_blocks
        return (total - self.kv.free_blocks) / total

    def fragmentation(self) -> float:
        """The fraction of live sequences' allocated token slots not holding
        KV (partial tails and decode-horizon headroom)."""
        if self.occupancy_provider is None:
            return 0.0
        used, allocated = self.occupancy_provider()
        if allocated == 0:
            return 0.0
        return max(0.0, 1.0 - used / (allocated * self.block_size))

    def snapshot(self) -> dict:
        """Everything as one JSON-able dict."""
        return {
            "counters": dict(self.counters),
            "classes": self.refcount_classes(),
            "occupancy": round(self.occupancy(), 4),
            "occupancy_integral_s": round(self.occupancy_integral_s(), 6),
            "fragmentation": round(self.fragmentation(), 4),
            "block_age_s": self.block_age_s.summary(),
            "reuse_interval_s": self.reuse_interval_s.summary(),
            "evicted_block_age_s": self.evicted_block_age_s.summary(),
            "mrc": {f"{m:g}x": (round(v, 4) if v is not None else None)
                    for m, v in self.mrc.predict().items()},
            "mrc_observed_hit_rate": (round(self.mrc.observed_hit_rate, 4)
                                      if self.mrc.observed_hit_rate is not None else None),
            "mrc_refs": self.mrc.refs_total,
            "mrc_tracked_keys": self.mrc.tracked_keys,
            "tiers": {
                "demote_queued": self.counters["demote_queued"],
                "demoted": self.counters["demoted"],
                "promoted": self.counters["promoted"],
                "host_blocks_used": self._host_occ_blocks,
                "host_occupancy_integral_s": round(self.host_occupancy_integral_s(), 6),
                "promote_latency_s": self.promote_latency_s.summary(),
                "demote_latency_s": self.demote_latency_s.summary(),
            },
        }

    def reset(self) -> None:
        """Zero every accumulator; the stamp arrays and tree-held flags are
        live state and survive."""
        self.mrc.reset()
        for k in self.counters:
            self.counters[k] = 0
        self._new_histograms()
        self._host_occ_integral_s = 0.0
        self._host_occ_last_t = self._clock()

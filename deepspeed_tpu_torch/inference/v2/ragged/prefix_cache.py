"""Prefix cache: radix-tree reuse of refcounted KV blocks.

Counterpart of ``deepspeed_tpu/inference/v2/ragged/prefix_cache.py:39-754``
without the tenant meter and the metrics / flight-recorder emission (their
values stay in ``stats``). A radix tree keyed on block-aligned token-id
chunks maps a new prompt to its longest run of materialized KV blocks
(PagedAttention block sharing, Kwon et al. SOSP'23; RadixAttention's LRU
tree, Zheng et al. 2023); the serving engine then starts prefill after the
hit, with ``seen_tokens`` pre-seeded and the block table pre-populated.

Invariants:

* a block's contents are immutable while shared (refcount > 1, or held by
  the tree): sequences never write into full blocks, and a partial-tail hit
  copies the block first (copy-on-write, ``kv_cache.copy_block``);
* every holder is counted: each sequence sharing a block and the tree itself
  own one reference; a block is freed only at zero;
* only full blocks enter the tree, and eviction removes LRU leaves whose
  sole holder is the tree, so it never takes a block from a sequence.
"""

import heapq
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from .cache_telemetry import chunk_key
from .tiered_store import RES_DISK, RES_HBM, RES_HOST, RES_IN_FLIGHT


class _Node:
    """One radix-tree edge = one full KV block: ``chunk`` (block_size token
    ids) -> ``block`` (physical block id). Children keyed by their chunk.
    ``owner`` is the publishing sequence's tenant.

    ``res`` / ``host_block`` / ``disk_id`` are the host tier's residency
    fields: which tier holds this chunk's KV and its slot there (defaults
    forever without a tier). Along any root-to-leaf path residency is
    monotone ``hbm* (in_flight|host)* disk*``, so the match walk's device
    run is always a tree prefix."""

    __slots__ = ("chunk", "block", "parent", "children", "last_access", "owner",
                 "res", "host_block", "disk_id")

    def __init__(self, chunk, block, parent, owner=None):
        self.chunk = chunk
        self.block = int(block)
        self.parent = parent
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.last_access = 0
        self.owner = owner
        self.res = RES_HBM
        self.host_block = -1
        self.disk_id = -1


@dataclass
class PrefixMatch:
    """Result of a (pure) longest-prefix walk."""

    n_cached_tokens: int = 0      # tokens of prompt covered (full + COW tail)
    shared_blocks: List[int] = field(default_factory=list)  # HBM full-block hits
    cow_src: Optional[int] = None  # block to duplicate for a partial tail
    cow_tokens: int = 0            # tokens of the COW block that are reusable
    # demoted chain matched past the HBM run (host/disk residency): COUNT
    # only — the blocks have no HBM id yet; ``acquire`` promotes them.
    # Admission treats these as uncached supply-wise (promotion charges the
    # budget like uncached tokens), so they are deliberately NOT part of
    # ``shared_blocks``.
    host_blocks: int = 0

    @property
    def hit_blocks(self) -> int:
        return (len(self.shared_blocks) + self.host_blocks
                + (1 if self.cow_src is not None else 0))


class PrefixKVCache:
    """Radix tree over a :class:`BlockedKVCache`'s refcounted blocks.

    ``acquire`` is the admission-side entry (match + take references + COW),
    ``publish`` the exit side (insert a sequence's completed full blocks),
    ``evict`` the allocator's pressure valve (LRU leaves, tree-only holders).
    LRU ordering uses a monotonic access counter, not wall time, so eviction
    is deterministic under test/bench replay.
    """

    def __init__(self, kv_cache, min_hit_blocks: int = 1, eviction: str = "lru",
                 telemetry=None):
        if eviction != "lru":
            raise ValueError(f"unknown eviction policy {eviction!r}: 'lru'")
        if min_hit_blocks < 1:
            raise ValueError(f"min_hit_blocks must be >= 1, got {min_hit_blocks}")
        self.kv_cache = kv_cache
        self.block_size = kv_cache.block_size
        self.min_hit_blocks = int(min_hit_blocks)
        self.eviction = eviction
        # block-lifecycle + MRC observability (``cache_telemetry.py``); None
        # keeps every hook below at a single attribute check
        self._telemetry = telemetry
        # host / disk tier (``tiered_store.TieredBlockStore``), wired by
        # attach_tier when ragged.prefix_cache.host_tier is present
        self._tier = None
        self._root = _Node(chunk=(), block=-1, parent=None)
        self._n_nodes = 0
        self._clock = 0  # monotonic LRU clock
        # the migration worker (and any prober thread) walks the tree while
        # the driving thread mutates it: every walk serializes on this lock.
        # RLock: acquire() reaches evict() through _reserve_with_eviction.
        self._tree_lock = threading.RLock()
        self.stats = {"lookups": 0, "hits": 0, "cached_tokens": 0, "cow_copies": 0,
                      "insertions": 0, "evictions": 0, "evicted_tokens": 0,
                      "cow_bytes": 0,
                      # tier lifecycle (all zero and inert without a tier)
                      "demotions_queued": 0, "promotions": 0,
                      "promoted_tokens": 0, "promote_wait_s": 0.0,
                      "evict_starved": 0, "readoptions": 0,
                      "host_installed": 0}

    # -- queries -----------------------------------------------------------
    @property
    def n_cached_blocks(self) -> int:
        return self._n_nodes

    @property
    def hit_rate(self) -> float:
        return self.stats["hits"] / self.stats["lookups"] if self.stats["lookups"] else 0.0

    def cached_block_ids(self) -> List[int]:
        """HBM block ids currently held by the tree (one tree reference
        each). Demoted nodes have no HBM block and are excluded."""
        with self._tree_lock:
            return [n.block for n in self._iter_nodes() if n.res == RES_HBM]

    @property
    def evictable_blocks(self) -> int:
        """HBM blocks eviction could return to the free list RIGHT NOW:
        tree-held blocks whose only reference is the tree's (demoted nodes
        hold no HBM block — ``available_blocks`` stays HBM-only by
        construction). Exact, not an upper bound: a sequence holding a node
        always holds its whole ancestor path (``acquire`` pins the matched
        run, ``publish`` descends only through blocks the publisher holds),
        so a sole-owner node's entire subtree is sole-owner too and repeated
        leaf eviction reaches all of it. O(tree) per call — fine at the
        current pool scale; an incrementally maintained counter needs
        refcount-transition hooks in the allocator and is the first thing
        to add if admission ever shows up hot."""
        with self._tree_lock:
            return sum(1 for n in self._iter_nodes()
                       if n.res == RES_HBM and self.kv_cache.refcount(n.block) == 1)

    @property
    def host_resident_blocks(self) -> int:
        """Nodes whose KV currently lives in the host (or disk) tier."""
        with self._tree_lock:
            return sum(1 for n in self._iter_nodes()
                       if n.res in (RES_HOST, RES_DISK))

    def attach_tier(self, tier) -> None:
        """Wire the host/disk capacity tier (``tiered_store.py``) under the
        tree: eviction demotes instead of dropping, the match walk extends
        into demoted chains, ``acquire`` promotes them back."""
        with self._tree_lock:
            self._tier = tier
            tier.attach(self)

    # -- admission side ----------------------------------------------------
    def match(self, tokens) -> PrefixMatch:
        """PURE longest-prefix walk (no refs taken, no LRU touch): how much
        of ``tokens`` the tree could serve. The usable prefix is capped at
        ``len(tokens) - 1`` — the engine must always compute at least the
        last prompt token to produce the first generated token.
        Thread-safe."""
        tokens = np.asarray(tokens, dtype=np.int64).reshape(-1)
        with self._tree_lock:
            return self._match_locked(tokens)

    def _match_locked(self, tokens) -> PrefixMatch:
        m = PrefixMatch()
        bs = self.block_size
        usable = tokens.size - 1
        if usable < 1:
            return m
        node = self._root
        j = 0
        while (j + 1) * bs <= usable:
            child = node.children.get(tuple(int(t) for t in tokens[j * bs:(j + 1) * bs]))
            if child is None:
                break
            if child.res == RES_HBM:
                if m.host_blocks:
                    break  # unreachable by the residency-ordering invariant
                m.shared_blocks.append(child.block)
            elif child.res in (RES_HOST, RES_DISK):
                # demoted chain: usable after promotion — counted, not id'd
                m.host_blocks += 1
            else:
                # in_flight: the migration worker owns it; neither tier's
                # copy is authoritative yet, so the walk stops here
                break
            node = child
            j += 1
        # partial tail: the longest common prefix between the remaining
        # tokens and any child chunk is reusable via copy-on-write — this is
        # the "shared prefix ends mid-block" case (and the exact-full-prompt
        # hit, where the cap forbids sharing the final block outright)
        rest = tokens[j * bs:]
        # the tail can reuse at most the remaining usable tokens; a full-bs
        # reuse is unreachable here (an exact-chunk child would have matched
        # above unless the cap already stopped the walk)
        cap = min(usable - j * bs, bs)
        # COW needs a device-side source block, so only HBM children apply —
        # and only when the run didn't end inside a demoted chain
        if cap >= 1 and node.children and m.host_blocks == 0:
            best, best_t = None, 0
            for child in node.children.values():
                if child.res != RES_HBM:
                    continue
                key = np.asarray(child.chunk[:cap], dtype=np.int64)
                neq = np.nonzero(rest[:key.size] != key)[0]
                t = int(neq[0]) if neq.size else int(key.size)
                if t > best_t:
                    best, best_t = child, t
            # a COW copy costs a block + a device copy: with no shared run in
            # front (an accidental few-token overlap between unrelated
            # prompts) demand it save at least half a block before paying
            floor = 1 if m.shared_blocks else max(1, bs // 2)
            if best is not None and best_t >= floor:
                m.cow_src, m.cow_tokens = best.block, best_t
        m.n_cached_tokens = j * bs + m.cow_tokens
        if m.hit_blocks < self.min_hit_blocks:
            return PrefixMatch()
        return m

    def acquire(self, tokens, match: Optional[PrefixMatch] = None) -> Tuple[List[int], int, int]:
        """Match ``tokens`` and take ownership of the hit on behalf of a new
        sequence: incref every shared full block, then (for a partial tail)
        allocate + device-copy the COW block. ``match`` reuses the result of
        a prior :meth:`match` on the same tokens (the admission path probes
        first; single-threaded, so nothing moved in between). Returns
        ``(block_ids, n_cached_tokens, n_shared_full_blocks)`` —
        ``block_ids`` become the sequence's leading ``kv_blocks`` and
        ``seen_tokens`` starts at ``n_cached_tokens``. A miss returns
        ``([], 0, 0)``.

        Order matters: shared blocks are pinned (incref) BEFORE the COW
        allocation can trigger eviction, so eviction can never reclaim the
        blocks this very hit depends on."""
        tokens = np.asarray(tokens, dtype=np.int64).reshape(-1)
        bs = self.block_size
        with self._tree_lock:
            self.stats["lookups"] += 1
            if self._tier is not None:
                # residency can change between the admission probe and here
                # (the migration worker finalizes demotions on its own
                # thread), so with a tier armed the match is always redone
                # under the lock: O(prompt), noise against the promotion
                # copies it guards
                m = self._match_locked(tokens)
            else:
                m = match if match is not None else self._match_locked(tokens)
            if self._telemetry is not None:
                # MRC demand feed: EVERY usable full-block chunk of the
                # prompt is one reference (path-chained keys), hit or miss —
                # cold misses belong in the miss-ratio denominator. Fed
                # before the early return so refused hits still count.
                # Demoted-chain hits count as demand too: the MRC models the
                # HIERARCHY (a host hit at 4x capacity is the evidence the
                # curve exists to surface).
                key, keys = 0, []
                for i in range((tokens.size - 1) // bs):
                    key = chunk_key(key, tokens[i * bs:(i + 1) * bs])
                    keys.append(key)
                self._telemetry.record_lookup(keys, len(m.shared_blocks) + m.host_blocks)
            if m.n_cached_tokens == 0:
                return [], 0, 0
            # touch the matched path (LRU), pin the HBM run, collect the
            # demoted chain for promotion
            node = self._root
            n_shared = len(m.shared_blocks)
            chain = []
            for i in range(n_shared + m.host_blocks):
                node = node.children[tuple(int(t) for t in np.asarray(tokens[i * bs:(i + 1) * bs]))]
                self._touch(node)
                if i >= n_shared:
                    chain.append(node)
            if m.shared_blocks:
                self.kv_cache.incref(m.shared_blocks)
                if self._telemetry is not None:
                    self._telemetry.on_hit(m.shared_blocks)
            blocks = list(m.shared_blocks)
            n_cached = n_shared * bs
            if chain:
                n_cached += self._promote_chain(chain, blocks)
            if m.cow_src is not None:
                try:
                    dst = int(self._reserve_with_eviction(1)[0])
                except ValueError:
                    dst = None  # pool truly dry: fall back to the full-block hit
                if dst is not None:
                    self.kv_cache.copy_block(m.cow_src, dst)
                    blocks.append(dst)
                    n_cached += m.cow_tokens
                    self.stats["cow_copies"] += 1
                    self.stats["cow_bytes"] += self.kv_cache.block_bytes()
            if n_cached == 0:
                return [], 0, 0
            self.stats["hits"] += 1
            self.stats["cached_tokens"] += n_cached
            return blocks, n_cached, len(m.shared_blocks)

    def _promote_chain(self, chain, blocks) -> int:
        """Copy a matched demoted run back to the device in order (root-ward
        first) on the driving thread, ahead of prefill: the admission-side
        half of the tier, and its only synchronous migration (decode steps
        never reach here). Each promoted node regains an HBM block holding
        the tree's reference plus the requesting sequence's; the incref
        right after the install pins it against the next iteration's
        ``_reserve_with_eviction``. Returns the tokens restored; a dry pool
        or a lost copy shortens the hit instead of failing it.

        Lookahead: before chain[i] is read, chain[i+1] is handed to the
        migration worker (``tier.prefetch``) so its host copy or disk read
        overlaps this block's copy to the device."""
        bs = self.block_size
        tier = self._tier
        promoted = 0
        for i, hn in enumerate(chain):
            t0 = time.monotonic()
            if i + 1 < len(chain):
                tier.prefetch(chain[i + 1])
            payload = tier.promote_payload(hn)
            if payload is None:
                # backing copy gone (disk corruption / torn spill): the
                # node and its demoted descendants are unusable without it
                # — a shorter hit, never wrong KV
                self._drop_node_subtree(hn)
                break
            try:
                dst = int(self._reserve_with_eviction(1)[0])
            except ValueError:
                break  # HBM dry even after eviction: shorten the hit
            from_disk = hn.res == RES_DISK
            self.kv_cache.write_block(dst, *payload)
            tier.release_resident(hn)
            hn.res = RES_HBM
            hn.block = dst
            # tree reference came with the reserve; this is the sequence's
            self.kv_cache.incref([dst])
            tier.note_promoted(from_disk)
            blocks.append(dst)
            promoted += 1
            dt = time.monotonic() - t0
            self.stats["promote_wait_s"] += dt
            if self._telemetry is not None:
                self._telemetry.on_promote(dst, wait_s=dt, from_disk=from_disk)
        if promoted:
            self.stats["promotions"] += promoted
            self.stats["promoted_tokens"] += promoted * bs
        return promoted * bs

    # -- exit side ---------------------------------------------------------
    def publish(self, seq) -> int:
        """Insert ``seq``'s completed FULL blocks on the way out (after a
        prefill chunk, a decode burst, or at flush). Idempotent root walk:
        an existing node at a chunk keeps its block (first writer wins —
        both copies hold identical KV, keeping one maximizes sharing); a
        missing node takes one tree reference on the sequence's block.

        The walk descends ONLY through nodes whose block this sequence
        itself holds. If another sequence won the race for a chunk (same
        tokens, different physical block), publishing stops there: inserting
        deeper children under a path the publisher does not hold would
        create interior tree-only nodes that leaf eviction can never reach —
        breaking the exactness of :attr:`evictable_blocks` and letting
        admission promise blocks eviction cannot free.

        ``seq.published_blocks`` is the walked-up-to cursor: the common
        steady-state call (a decode burst that completed no new full block)
        returns after one integer compare instead of re-walking the whole
        chain every forward. The cursor also forfeits re-publishing a chain
        the tree evicted while the sequence lives — a coverage loss, not a
        correctness one.

        Returns the number of newly inserted blocks."""
        bs = self.block_size
        known = min(len(seq.token_history), seq.seen_tokens)
        full = min(known // bs, len(seq.kv_blocks))
        if full <= getattr(seq, "published_blocks", 0):
            return 0
        with self._tree_lock:
            tel = self._telemetry
            node = self._root
            inserted = 0
            key, new_keys = 0, []
            for b in range(full):
                chunk = tuple(int(t) for t in seq.token_history[b * bs:(b + 1) * bs])
                if tel is not None:
                    key = chunk_key(key, chunk)
                child = node.children.get(chunk)
                if child is None:
                    child = _Node(chunk=chunk, block=seq.kv_blocks[b], parent=node,
                                  owner=getattr(seq, "tenant", None))
                    self.kv_cache.incref(child.block)
                    node.children[chunk] = child
                    self._n_nodes += 1
                    self.stats["insertions"] += 1
                    self._touch(child)
                    inserted += 1
                    if tel is not None:
                        tel.on_publish(child.block)
                        new_keys.append(key)
                elif child.res != RES_HBM:
                    # re-adopt: the publisher holds a live HBM copy of a
                    # chunk the tree only has demoted (or mid-demotion) —
                    # take the publisher's block as the node's HBM copy for
                    # free (no H2D) and drop the tier copy; an in-flight
                    # demotion finalizes as cancelled when the worker sees
                    # the residency flipped back
                    if self._tier is not None:
                        self._tier.release_resident(child)
                    child.res = RES_HBM
                    child.block = int(seq.kv_blocks[b])
                    self.kv_cache.incref(child.block)
                    self.stats["readoptions"] += 1
                    self._touch(child)
                    if tel is not None:
                        tel.on_publish(child.block)
                elif child.block != seq.kv_blocks[b]:
                    break  # a different writer owns this path from here down
                node = child
            if tel is not None and new_keys:
                # capacity-consuming, non-demand MRC accesses: a request's
                # uncached suffix / generated blocks entering the tree push
                # reusable chains deeper in the modeled LRU stack without
                # inflating the predicted hit rate
                tel.record_inserts(new_keys)
            seq.published_blocks = full
            return inserted

    def install_host_chain(self, token_chunks, payloads) -> int:
        """Adopt an exported chain of full KV blocks as host residents (the
        receiving half of ``export_sequence_kv`` -> ``install_prefix_kv``).
        Walks / extends the tree from the root: a chunk the tree already
        holds (any residency) is skipped, first writer wins as in
        :meth:`publish`, and each new chunk lands in the host tier as a
        demoted node, which a later ``acquire`` promotes. Host memory only:
        callable off the driving thread. Stops at a disk-resident ancestor
        (a host child below a disk parent would break the residency order)
        or when the host pool cannot make room. Returns blocks installed."""
        if self._tier is None:
            return 0
        installed = 0
        with self._tree_lock:
            node = self._root
            for chunk, payload in zip(token_chunks, payloads):
                key = tuple(int(t) for t in chunk)
                child = node.children.get(key)
                if child is not None:
                    if child.res == RES_DISK:
                        break
                    self._touch(child)
                    node = child
                    continue
                hb = self._tier.host_install(payload)
                if hb < 0:
                    break
                child = _Node(chunk=key, block=-1, parent=node)
                self._tier.register_host_node(child, hb)
                node.children[key] = child
                self._n_nodes += 1
                self._touch(child)
                installed += 1
                node = child
            if installed:
                self.stats["host_installed"] += installed
        return installed

    # -- pressure valve ----------------------------------------------------
    def evict(self, n_blocks: int) -> int:
        """Free up to ``n_blocks`` HBM blocks from tree-only holders, LRU
        HBM-leaves first (nodes with no HBM children — demoted descendants
        don't anchor their parent). One pass builds a min-heap of evictable
        leaves; a removed leaf that exposes its parent pushes the parent —
        no per-block rescan of the whole tree.

        With a tier attached each victim is demoted (its copy to pinned host
        memory queued here on the driving thread, the HBM block released at
        once, the rest finished by the migration worker); a full migration
        queue falls back to the plain drop, so eviction never waits on the
        worker. Returns how many HBM blocks went back to the free list; a
        shortfall is counted in ``stats["evict_starved"]``."""
        with self._tree_lock:
            requested = int(n_blocks)
            heap = [(n.last_access, id(n), n) for n in self._iter_hbm_leaves()
                    if self.kv_cache.refcount(n.block) == 1]
            heapq.heapify(heap)
            freed = 0
            while heap and freed < n_blocks:
                _, _, node = heapq.heappop(heap)
                parent = node.parent
                if not self._demote_node(node):
                    if node.children:
                        # demoted/in-flight children can't outlive their
                        # parent's KV: the drop takes the whole subtree
                        self._drop_node_subtree(node)
                    else:
                        self._remove(node)
                        self.stats["evictions"] += 1
                freed += 1
                if (parent is not self._root and parent.res == RES_HBM
                        and self.kv_cache.refcount(parent.block) == 1
                        and not any(c.res == RES_HBM
                                    for c in parent.children.values())):
                    heapq.heappush(heap, (parent.last_access, id(parent), parent))
            if freed < requested:
                self.stats["evict_starved"] += 1
            return freed

    def _demote_node(self, node) -> bool:
        """Hand one HBM victim to the tier's migration queue: queue its copy
        to host memory (driving thread), mark the node ``in_flight`` and
        release the HBM block now, so the caller's reserve succeeds without
        waiting for the copy. False (tier absent / queue at depth) means the
        caller drops instead."""
        if self._tier is None or not self._tier.has_room():
            return False
        snapshot = self.kv_cache.read_block(node.block)
        if not self._tier.try_demote(node, snapshot):
            return False
        block = node.block
        node.res = RES_IN_FLIGHT
        node.block = -1
        self.stats["demotions_queued"] += 1
        if self._telemetry is not None:
            self._telemetry.on_demote_queued(block)
        self.kv_cache.release(block)
        return True

    def demote_cold(self, n_blocks: int) -> int:
        """Proactive watermark demotion (``host_tier.low_watermark``): move
        up to ``n_blocks`` cold tree-only HBM-leaves to the tier WITHOUT
        dropping anything — a full queue stops the pass (unlike demand
        ``evict``, nothing here has to free memory). Keeps demand eviction
        off the inline-demote path in the steady state."""
        if self._tier is None or n_blocks <= 0:
            return 0
        with self._tree_lock:
            heap = [(n.last_access, id(n), n) for n in self._iter_hbm_leaves()
                    if self.kv_cache.refcount(n.block) == 1]
            heapq.heapify(heap)
            moved = 0
            while heap and moved < n_blocks:
                _, _, node = heapq.heappop(heap)
                parent = node.parent
                if not self._demote_node(node):
                    break
                moved += 1
                if (parent is not self._root and parent.res == RES_HBM
                        and self.kv_cache.refcount(parent.block) == 1
                        and not any(c.res == RES_HBM
                                    for c in parent.children.values())):
                    heapq.heappush(heap, (parent.last_access, id(parent), parent))
            return moved

    def clear(self) -> int:
        """Release EVERY tree reference (eviction flush): HBM blocks whose
        only holder was the tree return to the free list; blocks still held
        by live sequences merely lose the tree's reference; host/disk
        copies are dropped and in-flight demotions finalize as cancelled
        (the worker sees the node detached)."""
        with self._tree_lock:
            nodes = list(self._iter_nodes())
            hbm = [n.block for n in nodes if n.res == RES_HBM]
            if self._telemetry is not None and hbm:
                # a flush is not LRU pressure: drop the tree-held flags
                # without recording eviction-victim ages
                self._telemetry.on_tree_clear(hbm)
            for node in nodes:
                if node.res == RES_HBM:
                    self.kv_cache.release(node.block)
                elif self._tier is not None:
                    self._tier.release_resident(node)
                node.parent = None  # detaches any in-flight migration
                node.children = {}
            self._root.children = {}
            self._n_nodes = 0
            return len(nodes)

    def _reserve_with_eviction(self, n: int) -> np.ndarray:
        short = n - self.kv_cache.free_blocks
        if short > 0:
            self.evict(short)
        return self.kv_cache.reserve(n)

    # -- internals ---------------------------------------------------------
    def _touch(self, node) -> None:
        self._clock += 1
        node.last_access = self._clock

    def _iter_nodes(self):
        stack = list(self._root.children.values())
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            yield n

    def _iter_leaves(self):
        return (n for n in self._iter_nodes() if not n.children)

    def _iter_hbm_leaves(self):
        """Eviction/demotion victims: HBM-resident nodes with no HBM
        children. Demoted (host/disk/in-flight) descendants don't anchor
        their parent — demoting the parent keeps the root-ward residency
        ordering (it joins them in the lower tier). Without a tier every
        node is HBM and this degenerates to plain leaves."""
        return (n for n in self._iter_nodes()
                if n.res == RES_HBM
                and not any(c.res == RES_HBM for c in n.children.values()))

    def _remove(self, node) -> None:
        assert not node.children, "only leaves are evictable"
        del node.parent.children[node.chunk]
        # token-granular eviction accounting (tree nodes are FULL blocks by
        # construction, so each eviction discards exactly block_size tokens)
        self.stats["evicted_tokens"] += self.block_size
        if self._telemetry is not None:
            self._telemetry.on_evict(node.block)  # victim age BEFORE the free
        self.kv_cache.release(node.block)
        self._n_nodes -= 1

    def _drop_node_subtree(self, node) -> int:
        """Remove ``node`` and every descendant (demotion failure, disk
        corruption, host-tier overflow drop, queue-full eviction of a node
        with demoted children): by the residency ordering the descendants
        are host/disk/in-flight — unusable without this node's KV, so the
        whole subtree goes. Tier copies are freed, in-flight jobs are left
        to cancel themselves (the worker sees the node detached). Called
        under the tree lock, from the driving thread or the migration
        worker's failure path. Returns the node count dropped."""
        if node.parent is None:
            return 0  # already detached (racing drop)
        del node.parent.children[node.chunk]
        dropped = 0
        stack = [node]
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            n.children = {}
            n.parent = None
            if n.res == RES_HBM and n.block >= 0:
                if self._telemetry is not None:
                    self._telemetry.on_evict(n.block)
                self.kv_cache.release(n.block)
            elif self._tier is not None:
                self._tier.release_resident(n)
            n.block = -1
            self._n_nodes -= 1
            dropped += 1
            self.stats["evictions"] += 1
            self.stats["evicted_tokens"] += self.block_size
        return dropped

"""Tiered KV-block store: a host-memory (and optional disk) capacity tier
under the prefix cache's radix tree.

Counterpart of ``deepspeed_tpu/inference/v2/ragged/tiered_store.py:59-638``
without the tenant meter. ``PrefixKVCache.evict`` demotes cold tree-only
blocks into a host block pool that mirrors the :class:`BlockedKVCache`
layout (bf16 and int8 with its scales), a later radix hit on a demoted chain
promotes the blocks back ahead of prefill, and host-pool pressure can spill
further to checksummed block files on disk.

Threading contract:

* Every operation on a device tensor runs on the thread that drives the
  forwards. Demotion queues the victim block's copy into pinned host memory
  on the current stream there (``BlockedKVCache.read_block``), records a
  CUDA event and releases the device block at once: stream order keeps any
  later forward's write into the block behind the copy. The migration
  worker waits on the event, then copies host memory into the host pool (or
  a file); it never touches a CUDA tensor. Promotion (``write_block``) runs
  on the driving thread, inside admission, never inside a decode step.
* The migration queue is depth-bounded: a slow tier turns into plain drops;
  eviction never waits on the worker.
* Residency transitions (``hbm -> in_flight -> host -> disk``) are finalized
  under the prefix cache's tree lock. A worker failing mid-demotion (the
  module-level :data:`demote_hook` raising, as the tests make it) loses
  exactly the demoting block: its node (and any demoted descendants) is
  dropped and the worker survives.
"""

import io
import json
import os
import threading
import time
import zlib
from collections import OrderedDict, deque

import numpy as np
import torch

# residency states a radix node moves through (``_Node.res``)
RES_HBM = "hbm"
RES_IN_FLIGHT = "in_flight"  # demotion queued / running: unusable, unmatched
RES_HOST = "host"
RES_DISK = "disk"

# Called by the migration worker with ``{"queued": n}`` before each demotion
# copy. None in service; a test sets it to a function that raises (a worker
# dying mid-copy) or blocks (a wedged tier).
demote_hook = None


def _host_copy(payload):
    return tuple(None if a is None else a.clone() for a in payload)


class HostBlockPool:
    """Host pool of one :class:`BlockedKVCache`'s blocks, block-major: k / v
    ``[HB, L, bs, nkv, d]`` in the device dtype and, quantized, fp32 scales
    ``[HB, nkv, L, bs]``, in pinned memory when the cache is on a card. A
    block is one contiguous span per pool in the shapes of ``read_block``,
    so it crosses to the device in one copy with no re-quantizing.
    """

    def __init__(self, kv_cache, num_blocks: int):
        self.block_size = kv_cache.block_size
        self.num_blocks = int(num_blocks)
        self.num_layers = kv_cache.num_layers
        self.num_kv_heads = kv_cache.num_kv_heads
        self.quantized = kv_cache.quantized
        if self.num_blocks < 1:
            raise ValueError(f"host pool needs >= 1 block, got {num_blocks}")
        pin = kv_cache.device.type == "cuda"
        shape = (self.num_blocks, self.num_layers, self.block_size, kv_cache.num_kv_heads,
                 kv_cache.head_dim)
        self.k_pool = torch.zeros(shape, dtype=kv_cache.dtype, pin_memory=pin)
        self.v_pool = torch.zeros(shape, dtype=kv_cache.dtype, pin_memory=pin)
        self.k_scale = self.v_scale = None
        if self.quantized:
            sshape = (self.num_blocks, self.num_kv_heads, self.num_layers, self.block_size)
            self.k_scale = torch.zeros(sshape, dtype=torch.float32, pin_memory=pin)
            self.v_scale = torch.zeros(sshape, dtype=torch.float32, pin_memory=pin)
        # the worker reserves while the driving thread frees promoted blocks
        self._mu = threading.Lock()
        self._free = list(range(self.num_blocks - 1, -1, -1))

    @property
    def free_blocks(self) -> int:
        with self._mu:
            return len(self._free)

    @property
    def used_blocks(self) -> int:
        return self.num_blocks - self.free_blocks

    def host_reserve(self) -> int:
        """One block, or -1 when the pool is full (never blocks)."""
        with self._mu:
            return self._free.pop() if self._free else -1

    def host_free(self, block: int) -> None:
        with self._mu:
            self._free.append(int(block))

    def host_write(self, block: int, k, v, k_scale=None, v_scale=None) -> None:
        """Install one block's KV (the shapes of ``read_block``)."""
        b = int(block)
        self.k_pool[b].copy_(torch.as_tensor(k))
        self.v_pool[b].copy_(torch.as_tensor(v))
        if self.quantized and k_scale is not None:
            self.k_scale[b].copy_(torch.as_tensor(k_scale))
            self.v_scale[b].copy_(torch.as_tensor(v_scale))

    def host_read(self, block: int):
        """Views of one resident block: ``(k, v, k_scale, v_scale)``, each
        contiguous."""
        b = int(block)
        if not self.quantized:
            return self.k_pool[b], self.v_pool[b], None, None
        return self.k_pool[b], self.v_pool[b], self.k_scale[b], self.v_scale[b]

    def memory_bytes(self) -> int:
        n = 2 * self.k_pool.numel() * self.k_pool.element_size()
        if self.quantized:
            n += 2 * self.k_scale.numel() * 4
        return n


class TieredBlockStore:
    """Migration engine between the device pool, a :class:`HostBlockPool`
    and an optional disk tier. Owned by :class:`PrefixKVCache` (``attach``);
    it exists only when ``ragged.prefix_cache.host_tier`` is present."""

    def __init__(self, kv_cache, config, telemetry=None, clock=time.monotonic):
        self.kv_cache = kv_cache
        self.config = config
        n = int(getattr(config, "host_blocks", 0) or 0)
        if n <= 0 and getattr(config, "host_pool_bytes", 0):
            n = int(config.host_pool_bytes) // max(1, kv_cache.block_bytes())
        if n <= 0:
            raise ValueError("host_tier needs host_blocks or host_pool_bytes "
                             "sizing at least one block")
        self.pool = HostBlockPool(kv_cache, n)
        self.queue_depth = max(1, int(getattr(config, "queue_depth", 8)))
        self._telemetry = telemetry
        self._clock = clock
        self._cache = None  # attach() wires the owning PrefixKVCache
        # host LRU: node -> host block in demotion order (guarded by the
        # tree lock: every mutator holds it)
        self._host_nodes = OrderedDict()
        # disk tier: manifest disk_id -> {file, crc, nbytes}; _disk_pending
        # holds a spill's payload until its file is written. _mu guards
        # manifest / pending / counters between the worker and the driver.
        self._mu = threading.Lock()
        self._disk_dir = getattr(config, "disk_path", None)
        self._disk_cap = int(getattr(config, "disk_blocks", 0) or 0)
        self._disk_manifest = {}
        self._disk_pending = {}
        self._next_disk_id = 0
        if self._disk_dir is not None:
            self._disk_dir = str(self._disk_dir)
            os.makedirs(self._disk_dir, exist_ok=True)
        self.counters = {"demotions": 0, "demote_failures": 0,
                         "demote_cancelled": 0, "promotions_host": 0,
                         "promotions_disk": 0, "host_evictions": 0,
                         "disk_spills": 0, "disk_corrupt": 0,
                         "disk_drops": 0, "prefetch_enqueued": 0,
                         "prefetch_hits": 0, "prefetch_unused": 0,
                         "host_installs": 0}
        # chain lookahead: node -> payload the worker staged ahead of the
        # promotion walk, plus in-flight markers (guarded by _mu)
        self._prefetched = {}
        self._prefetch_inflight = set()
        self._q = deque()
        self._cv = threading.Condition()
        self._stop = False
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="kv-tier-migrator")
        self._worker.start()

    def attach(self, prefix_cache) -> None:
        """Bind to the owning tree (residency is finalized under its
        ``_tree_lock``)."""
        self._cache = prefix_cache

    # -- demotion (driving thread: enqueue only) ---------------------------
    def try_demote(self, node, snapshot) -> bool:
        """Queue one demotion of ``snapshot`` (a ``BlockSnapshot``). Called
        under the tree lock. False (the caller drops the block) when the
        queue is full or the store is shut down; never waits."""
        with self._cv:
            if self._stop or len(self._q) >= self.queue_depth:
                return False
            self._q.append(("demote", node, snapshot, self._clock()))
            self._cv.notify()
        return True

    def prefetch(self, node) -> bool:
        """Queue a background read of a demoted node's payload (host copy or
        disk read) so the next ``promote_payload`` finds it staged.
        Depth-bounded like demotion; a busy worker leaves that promotion
        synchronous."""
        if node.res not in (RES_HOST, RES_DISK):
            return False
        with self._cv:
            if self._stop or len(self._q) >= self.queue_depth:
                return False
            with self._mu:
                if node in self._prefetched or node in self._prefetch_inflight:
                    return True
                self._prefetch_inflight.add(node)
                self.counters["prefetch_enqueued"] += 1
            self._q.append(("prefetch", node))
            self._cv.notify()
        return True

    def has_room(self) -> bool:
        """Whether ``try_demote`` would take a job now (only the driving
        thread enqueues, so the answer holds until it does)."""
        with self._cv:
            return not self._stop and len(self._q) < self.queue_depth

    @property
    def queued(self) -> int:
        with self._cv:
            return len(self._q)

    # -- promotion (driving thread, tree lock held) -------------------------
    def promote_payload(self, node):
        """Host or disk payload of a demoted node: ``(k, v, k_scale,
        v_scale)`` host tensors, or None when the copy is gone or fails its
        checksum (the caller drops the node: a miss, never wrong KV). A host
        resident comes back as views of its slot: the tree lock the caller
        holds keeps the slot from being freed or reused until the caller's
        ``write_block`` (synchronous) has read it."""
        with self._mu:
            parked = self._prefetched.pop(node, None)
            if parked is not None:
                self.counters["prefetch_hits"] += 1
        if parked is not None:
            return parked
        if node.res == RES_HOST:
            return self.pool.host_read(node.host_block)
        if node.res == RES_DISK:
            with self._mu:
                pending = self._disk_pending.get(node.disk_id)
            if pending is not None:
                return pending
            return self._disk_read(node.disk_id)
        return None

    def note_promoted(self, from_disk: bool) -> None:
        with self._mu:
            self.counters["promotions_disk" if from_disk else "promotions_host"] += 1

    def release_resident(self, node) -> None:
        """Drop a node's host / disk copy (after promotion, or when the node
        is discarded). Tree lock held."""
        with self._mu:
            if self._prefetched.pop(node, None) is not None:
                self.counters["prefetch_unused"] += 1
            self._prefetch_inflight.discard(node)
        if node.host_block >= 0:
            self._release_host_block(node.host_block)
            self._host_nodes.pop(node, None)
            node.host_block = -1
        if node.disk_id >= 0:
            self._disk_drop(node.disk_id)
            node.disk_id = -1

    # -- adoption of exported KV ----------------------------------------------
    def host_install(self, payload) -> int:
        """Reserve a host block and fill it with an exported payload
        (``read_block`` shapes), evicting cold host residents to make room;
        -1 when no host leaf can go. Host memory and files only."""
        hb = self.pool.host_reserve()
        while hb < 0:
            try:
                self._evict_host_one()
            except RuntimeError:
                return -1
            hb = self.pool.host_reserve()
        k, v, ks, vs = payload
        self.pool.host_write(hb, k, v, ks, vs)
        with self._mu:
            self.counters["host_installs"] += 1
        return hb

    def register_host_node(self, node, host_block: int) -> None:
        """Bind an installed host block to its new tree node (tree lock
        held by the caller)."""
        node.res = RES_HOST
        node.host_block = int(host_block)
        self._host_nodes[node] = int(host_block)
        if self._telemetry is not None:
            self._telemetry.note_host_used(self.pool.used_blocks)

    # -- watermarks -------------------------------------------------------------
    def demotion_target(self) -> int:
        """Blocks proactive demotion should move now: below
        ``low_watermark`` of the pool free, the shortfall up to
        ``high_watermark`` (0 otherwise)."""
        total = self.kv_cache.total_blocks
        free = self.kv_cache.free_blocks
        if total <= 0 or free >= self.config.low_watermark * total:
            return 0
        return max(0, int(self.config.high_watermark * total) - free)

    def snapshot(self) -> dict:
        with self._mu:
            c = dict(self.counters)
            disk_used = len(self._disk_manifest)
            c["prefetched_parked"] = len(self._prefetched)
        c.update(host_blocks=self.pool.num_blocks,
                 host_used=self.pool.used_blocks,
                 host_bytes=self.pool.memory_bytes(),
                 queue_depth=self.queue_depth, queued=self.queued,
                 disk_blocks=self._disk_cap if self._disk_dir else 0,
                 disk_used=disk_used)
        return c

    def shutdown(self, timeout: float = 5.0) -> None:
        """Stop the worker; queued demotions are cancelled (their nodes
        dropped)."""
        with self._cv:
            self._stop = True
            pending = list(self._q)
            self._q.clear()
            self._cv.notify_all()
        self._worker.join(timeout)
        for item in pending:
            if item[0] == "demote":
                self._fail_node(item[1], cancelled=True)
            else:
                with self._mu:
                    self._prefetch_inflight.discard(item[1])

    # -- migration worker ---------------------------------------------------------
    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._q and not self._stop:
                    self._cv.wait()
                if self._stop:
                    return
                item = self._q.popleft()
            if item[0] == "prefetch":
                self._run_prefetch(item[1])
                continue
            _, node, snapshot, t0 = item
            try:
                if demote_hook is not None:
                    demote_hook({"queued": self.queued})
                hb = self._reserve_host_block(exclude=node)
                # the copies queued by read_block land before this returns
                self.pool.host_write(hb, *snapshot.wait())
                self._finalize_demote(node, hb, t0)
            except Exception:
                with self._mu:
                    self.counters["demote_failures"] += 1
                self._fail_node(node)

    def _run_prefetch(self, node) -> None:
        """Materialize one demoted node's payload and park it; residency is
        checked under the tree lock before the read and at park time."""
        cache = self._cache
        payload = disk_id = None
        try:
            with cache._tree_lock:
                if node.res == RES_HOST and node.host_block >= 0:
                    payload = _host_copy(self.pool.host_read(node.host_block))
                elif node.res == RES_DISK and node.disk_id >= 0:
                    disk_id = node.disk_id
            if disk_id is not None:
                with self._mu:
                    payload = self._disk_pending.get(disk_id)
                if payload is None:
                    payload = self._disk_read(disk_id)
            with cache._tree_lock:
                with self._mu:
                    self._prefetch_inflight.discard(node)
                    if (payload is not None and node.res in (RES_HOST, RES_DISK)
                            and len(self._prefetched) < self.queue_depth):
                        self._prefetched[node] = payload
        except Exception:
            with self._mu:
                self._prefetch_inflight.discard(node)

    def _finalize_demote(self, node, host_block: int, t0: float) -> None:
        cache = self._cache
        with cache._tree_lock:
            if node.res != RES_IN_FLIGHT or node.parent is None:
                # dropped or re-adopted while we copied: give the block back
                with self._mu:
                    self.counters["demote_cancelled"] += 1
                self.pool.host_free(host_block)
                return
            node.res = RES_HOST
            node.host_block = int(host_block)
            self._host_nodes[node] = int(host_block)
            with self._mu:
                self.counters["demotions"] += 1
            if self._telemetry is not None:
                self._telemetry.on_demote(self.pool.used_blocks,
                                          wait_s=self._clock() - t0)

    def _fail_node(self, node, cancelled: bool = False) -> None:
        cache = self._cache
        try:
            with cache._tree_lock:
                if node.res == RES_IN_FLIGHT and node.parent is not None:
                    cache._drop_node_subtree(node)
                if cancelled:
                    with self._mu:
                        self.counters["demote_cancelled"] += 1
        except Exception:
            pass  # the worker must survive anything here

    def _reserve_host_block(self, exclude=None) -> int:
        """Worker-side reservation; a full pool spills (or drops) the
        coldest host-resident chain leaf first. Never returns -1."""
        hb = self.pool.host_reserve()
        while hb < 0:
            self._evict_host_one(exclude=exclude)
            hb = self.pool.host_reserve()
        return hb

    def _evict_host_one(self, exclude=None) -> None:
        cache = self._cache
        with cache._tree_lock:
            victim = None
            for node in self._host_nodes:
                if node is exclude:
                    continue
                # only chain leaves leave the host tier: the match walk
                # relies on residency ordered root-ward
                if not any(c.res in (RES_HOST, RES_IN_FLIGHT) for c in node.children.values()):
                    victim = node
                    break
            if victim is None:
                raise RuntimeError("host pool full with no evictable chain leaf")
            with self._mu:
                self.counters["host_evictions"] += 1
                disk_ok = (self._disk_dir is not None
                           and len(self._disk_manifest) + len(self._disk_pending) < self._disk_cap)
            if disk_ok:
                payload = _host_copy(self.pool.host_read(victim.host_block))
                with self._mu:
                    disk_id = self._next_disk_id
                    self._next_disk_id += 1
                    self._disk_pending[disk_id] = payload
                self._release_host_block(victim.host_block)
                self._host_nodes.pop(victim, None)
                victim.host_block = -1
                victim.res = RES_DISK
                victim.disk_id = disk_id
            else:
                if self._disk_dir is not None:
                    with self._mu:
                        self.counters["disk_drops"] += 1
                cache._drop_node_subtree(victim)
                payload = disk_id = None
        if payload is not None:
            self._disk_write(disk_id, payload)

    def _release_host_block(self, hb: int) -> None:
        self.pool.host_free(hb)
        if self._telemetry is not None:
            self._telemetry.note_host_used(self.pool.used_blocks)

    # -- disk tier -------------------------------------------------------------------
    def _disk_file(self, disk_id: int) -> str:
        return os.path.join(self._disk_dir, f"kvblock_{disk_id:08d}.npz")

    def _disk_write(self, disk_id: int, payload) -> None:
        """Serialize outside every lock, commit by tmp + rename, crc32 in
        the manifest so a torn or corrupt file reads as a miss."""
        k, v, ks, vs = payload
        path = self._disk_file(disk_id)
        try:
            buf = io.BytesIO()
            # KV as raw bytes (numpy has no bf16); the dtype and shapes are
            # the pool's, known at read time
            arrs = {"k": k.contiguous().view(torch.uint8).numpy(),
                    "v": v.contiguous().view(torch.uint8).numpy()}
            if ks is not None:
                arrs["ks"], arrs["vs"] = ks.numpy(), vs.numpy()
            np.savez(buf, **arrs)
            raw = buf.getvalue()
            crc = zlib.crc32(raw) & 0xFFFFFFFF
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(raw)
            os.replace(tmp, path)
            with self._mu:
                if disk_id in self._disk_pending:  # still wanted
                    self._disk_manifest[disk_id] = {
                        "file": os.path.basename(path), "crc": crc, "nbytes": len(raw),
                        "dtype": str(self.pool.k_pool.dtype)}
                    del self._disk_pending[disk_id]
                    self.counters["disk_spills"] += 1
                    self._write_manifest_locked()
                    return
            os.remove(path)
        except Exception:
            with self._mu:
                self._disk_pending.pop(disk_id, None)
                self.counters["disk_corrupt"] += 1

    def _disk_read(self, disk_id: int):
        with self._mu:
            ent = self._disk_manifest.get(disk_id)
        if ent is None:
            return None
        try:
            with open(os.path.join(self._disk_dir, ent["file"]), "rb") as f:
                raw = f.read()
            if (zlib.crc32(raw) & 0xFFFFFFFF) != ent["crc"]:
                raise ValueError("crc mismatch")
            shape = tuple(self.pool.k_pool.shape[1:])
            dtype = self.pool.k_pool.dtype
            with np.load(io.BytesIO(raw)) as z:
                k = torch.from_numpy(z["k"].copy()).view(dtype).reshape(shape)
                v = torch.from_numpy(z["v"].copy()).view(dtype).reshape(shape)
                ks = torch.from_numpy(z["ks"].copy()) if "ks" in z.files else None
                vs = torch.from_numpy(z["vs"].copy()) if "vs" in z.files else None
            return k, v, ks, vs
        except Exception:
            with self._mu:
                self.counters["disk_corrupt"] += 1
            return None

    def _disk_drop(self, disk_id: int) -> None:
        with self._mu:
            self._disk_pending.pop(disk_id, None)
            ent = self._disk_manifest.pop(disk_id, None)
            if ent is not None:
                self._write_manifest_locked()
        if ent is not None:
            try:
                os.remove(os.path.join(self._disk_dir, ent["file"]))
            except OSError:
                pass

    def _write_manifest_locked(self) -> None:
        path = os.path.join(self._disk_dir, "MANIFEST.json")
        tmp = path + ".tmp"
        try:
            with open(tmp, "w") as f:
                json.dump({str(i): e for i, e in self._disk_manifest.items()}, f, indent=0)
            os.replace(tmp, path)
        except OSError:
            pass

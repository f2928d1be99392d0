"""PyTorch port: the prefix cache's host / disk tier and its telemetry.

The invariants held here (analogs of the JAX package's
``tests/test_tiered_store.py`` and ``tests/test_cache_telemetry.py``):

* a demoted block comes back with its exact payload, and residency is
  exclusive (a node is never in two tiers) with refcounts exact under
  churn; after drain and clear both pools are whole;
* the admission probe counts a host chain without pinning it;
* a worker that fails mid-demotion loses only that block, and survives;
* a wedged worker stalls nothing on the driving thread;
* the disk tier spills past the host pool, and a corrupt file is a miss;
* greedy streams with the tier on equal those with the cache off and the
  JAX engine's (fp32 and int8 KV), with promotions served;
* ``export_sequence_kv`` -> ``install_prefix_kv`` carries a prefix between
  two port engines;
* the MRC estimator equals an exact LRU simulation at sample rate 1, and
  the refcount classes stay exact under engine churn.

Every wait on the migration thread has its own deadline.
"""

import threading
import time
import zlib
from collections import OrderedDict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2 import DSStateManagerConfig as JaxSMConfig
from deepspeed_tpu.inference.v2 import DynamicSplitFuseScheduler as JaxScheduler
from deepspeed_tpu.inference.v2 import HostTierConfig as JaxHostTierConfig
from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.inference.v2 import PrefixCacheConfig as JaxPrefixCacheConfig
from deepspeed_tpu.inference.v2 import RaggedInferenceEngineConfig as JaxConfig
from deepspeed_tpu.inference.v2.ragged import MRCEstimator as JaxMRCEstimator
from deepspeed_tpu.models import llama2 as jax_llama2
from deepspeed_tpu_torch.inference.v2 import (CacheTelemetryConfig, DSStateManagerConfig,
                                              DynamicSplitFuseScheduler, HostTierConfig,
                                              InferenceEngineV2, PrefixCacheConfig,
                                              RaggedInferenceEngineConfig)
from deepspeed_tpu_torch.inference.v2.ragged import (BlockedKVCache, CacheTelemetry,
                                                     MRCEstimator, PrefixKVCache)
from deepspeed_tpu_torch.inference.v2.ragged import tiered_store
from deepspeed_tpu_torch.inference.v2.ragged.tiered_store import (RES_HBM, RES_HOST,
                                                                  RES_IN_FLIGHT,
                                                                  TieredBlockStore)
from deepspeed_tpu_torch.models import llama2, llama2_config, params_from_jax

TINY = dict(num_layers=2, hidden_size=64, num_heads=4, num_kv_heads=2, intermediate_size=128,
            vocab_size=128, max_seq_len=256)
WAIT_S = 10.0  # deadline of any wait on the migration worker


# ---------------------------------------------------------------------------
# unit harness: a tiny pool, its tree and a tier
# ---------------------------------------------------------------------------

class _Seq:
    def __init__(self, tokens, blocks):
        self.token_history = list(tokens)
        self.kv_blocks = list(blocks)
        self.seen_tokens = len(tokens)
        self.history_valid = True


def _tiered(num_blocks=8, block_size=4, host_blocks=4, telemetry=False, dtype=torch.float32,
            **tier_kw):
    kv = BlockedKVCache(num_layers=2, num_kv_heads=1, head_dim=2, num_blocks=num_blocks,
                        block_size=block_size, dtype=dtype, device="cpu")
    tel = CacheTelemetry(kv, CacheTelemetryConfig(enabled=True, mrc_sample_rate=1.0)) \
        if telemetry else None
    pc = PrefixKVCache(kv, telemetry=tel)
    tier = TieredBlockStore(kv, HostTierConfig(host_blocks=host_blocks, **tier_kw),
                            telemetry=tel)
    pc.attach_tier(tier)
    return kv, pc, tier


def _publish_chain(kv, pc, tokens, fill=None):
    """Reserve, (optionally) fill with recognizable KV, publish and drop the
    owner's references: a chain only the tree holds. Returns its blocks."""
    n = len(tokens) // pc.block_size
    blocks = [int(b) for b in kv.reserve(n)]
    if fill is not None:
        for i, b in enumerate(blocks):
            k, v, ks, vs = kv.read_block(b).wait()
            kv.write_block(b, torch.full_like(k, fill + i), torch.full_like(v, fill + i + 0.25),
                           None if ks is None else torch.full_like(ks, 0.5 + i),
                           None if vs is None else torch.full_like(vs, 0.75 + i))
    pc.publish(_Seq(tokens, blocks))
    kv.release(blocks)
    return blocks


def _walk(pc):
    out, stack = [], list(pc._root.children.values())
    while stack:
        n = stack.pop()
        out.append(n)
        stack.extend(n.children.values())
    return out


def _drain(tier, deadline_s=WAIT_S):
    """Wait until the queue is empty and no node is in flight; fail the test
    past the deadline."""
    end = time.monotonic() + deadline_s
    while time.monotonic() < end:
        with tier._cv:
            idle = not tier._q
        with tier._cache._tree_lock:
            busy = any(n.res == RES_IN_FLIGHT for n in _walk(tier._cache))
        if idle and not busy:
            return
        time.sleep(0.005)
    raise AssertionError(f"migration worker did not drain within {deadline_s}s")


# ---------------------------------------------------------------------------
# demote -> promote, residency, the probe
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.int8])
def test_demote_promote_roundtrip_exact_payload(dtype):
    kv, pc, tier = _tiered(dtype=dtype)
    toks = [1, 2, 3, 4, 5, 6, 7, 8]
    _publish_chain(kv, pc, toks, fill=10)
    assert pc.demote_cold(2) == 2
    _drain(tier)
    assert kv.free_blocks == 8 and pc.host_resident_blocks == 2
    assert tier.snapshot()["demotions"] == 2
    blocks, n_cached, n_shared = pc.acquire(toks + [9, 9, 9])
    assert n_cached == 8 and len(blocks) == 2 and n_shared == 0
    assert pc.stats["promotions"] == 2 and pc.stats["promoted_tokens"] == 8
    for i, b in enumerate(blocks):
        k, v, ks, vs = kv.read_block(b).wait()
        assert k.unique().tolist() == [10 + i] and v.unique().float().tolist() == (
            [10 + i] if dtype == torch.int8 else [10.25 + i])
        if dtype == torch.int8:
            assert ks.unique().tolist() == [0.5 + i] and vs.unique().tolist() == [0.75 + i]
        assert kv.refcount(b) == 2  # the tree and this acquire
    assert tier.pool.used_blocks == 0 and pc.host_resident_blocks == 0
    kv.release(blocks)
    pc.clear()
    assert kv.free_blocks == 8
    tier.shutdown()


def test_match_counts_a_host_chain_without_pinning_it():
    kv, pc, tier = _tiered()
    toks = [1, 2, 3, 4, 5, 6, 7, 8]
    _publish_chain(kv, pc, toks)
    pc.demote_cold(1)  # the leaf goes; the root-side block stays on the device
    _drain(tier)
    m = pc.match(toks + [9, 9, 9])
    assert len(m.shared_blocks) == 1 and m.host_blocks == 1 and m.n_cached_tokens == 8
    assert kv.refcount(m.shared_blocks[0]) == 1  # a probe takes no reference
    tier.shutdown()


def test_residency_exclusive_and_refcounts_under_churn():
    kv, pc, tier = _tiered(num_blocks=16, host_blocks=8)
    rng = np.random.default_rng(17)
    held = []
    for round_ in range(40):
        op = rng.integers(0, 4)
        toks = [int(t) for t in rng.integers(0, 30, size=8)]
        if op == 0 and kv.free_blocks >= 2:
            _publish_chain(kv, pc, toks)
        elif op == 1:
            held.extend(pc.acquire(toks + [99])[0])
            if len(held) > 6:
                kv.release(held.pop(0))
        elif op == 2:
            pc.evict(int(rng.integers(1, 4)))
        else:
            pc.demote_cold(int(rng.integers(1, 4)))
        if round_ % 10 == 9:
            _drain(tier)
        with pc._tree_lock:
            host_seen = set()
            for n in _walk(pc):
                if n.res == RES_HBM:
                    assert n.block >= 0 and n.host_block == -1 and n.disk_id == -1
                    assert kv.refcount(n.block) >= 1
                elif n.res == RES_HOST:
                    assert n.block == -1 and n.host_block >= 0 and n.disk_id == -1
                    assert n.host_block not in host_seen
                    host_seen.add(n.host_block)
                elif n.res == RES_IN_FLIGHT:
                    assert n.block == -1 and n.host_block == -1
    _drain(tier)
    kv.release(held)
    pc.clear()
    _drain(tier)
    assert kv.free_blocks == 16 and tier.pool.used_blocks == 0
    assert tier.snapshot()["demote_failures"] == 0
    tier.shutdown()


# ---------------------------------------------------------------------------
# failures of the worker
# ---------------------------------------------------------------------------

def test_crash_during_demotion_loses_only_that_block(monkeypatch):
    kv, pc, tier = _tiered(num_blocks=16)
    long_toks = list(range(1, 13))
    other_toks = [21, 22, 23, 24]
    _publish_chain(kv, pc, long_toks)
    _publish_chain(kv, pc, other_toks)
    fired = threading.Event()

    def boom(_ctx):
        if not fired.is_set():
            fired.set()
            raise RuntimeError("injected: the worker dies mid-copy")

    monkeypatch.setattr(tiered_store, "demote_hook", boom)
    try:
        assert pc.demote_cold(1) == 1  # the LRU leaf of the long chain
        _drain(tier)
        assert fired.is_set() and tier.snapshot()["demote_failures"] == 1
        m = pc.match(long_toks + [99, 99])
        assert m.n_cached_tokens == 8 and m.host_blocks == 0
        assert pc.match(other_toks + [99, 99]).n_cached_tokens == 4
        assert pc.demote_cold(1) == 1  # the worker survived
        _drain(tier)
        assert tier.snapshot()["demotions"] == 1 and pc.host_resident_blocks == 1
    finally:
        tier.shutdown()


def test_a_wedged_worker_blocks_nothing(monkeypatch):
    kv, pc, tier = _tiered(num_blocks=16, host_blocks=8, queue_depth=2)
    gate, entered = threading.Event(), threading.Event()

    def wedge(_ctx):
        entered.set()
        gate.wait(WAIT_S)

    monkeypatch.setattr(tiered_store, "demote_hook", wedge)
    try:
        for base in range(0, 40, 10):
            _publish_chain(kv, pc, [base + i for i in range(8)])
        t0 = time.perf_counter()
        queued = pc.demote_cold(8)
        assert entered.wait(WAIT_S)
        assert queued <= 3 and time.perf_counter() - t0 < 1.0
        t0 = time.perf_counter()
        assert pc.evict(2) == 2 and time.perf_counter() - t0 < 1.0  # drops, no wait
        with pc._tree_lock:
            assert any(n.res == RES_IN_FLIGHT for n in _walk(pc))
        t0 = time.perf_counter()
        pc.acquire([0, 1, 2, 3, 4, 5, 6, 7, 99])  # stops at the in-flight node
        assert time.perf_counter() - t0 < 1.0 and pc.stats["promotions"] == 0
    finally:
        gate.set()
        tier.shutdown()


def test_disk_spill_promote_and_a_corrupt_file_is_a_miss(tmp_path):
    kv, pc, tier = _tiered(num_blocks=16, host_blocks=2, disk_path=str(tmp_path), disk_blocks=8)
    toks = list(range(100, 116))  # 4 blocks: 2 overflow the host pool to disk
    _publish_chain(kv, pc, toks, fill=5)
    assert pc.demote_cold(4) == 4
    _drain(tier)
    snap = tier.snapshot()
    assert snap["demotions"] == 4 and snap["host_evictions"] == 2
    assert snap["disk_spills"] == 2 and snap["disk_used"] == 2
    assert (tmp_path / "MANIFEST.json").exists()
    blocks, n_cached, _ = pc.acquire(toks + [9, 9, 9])
    assert n_cached == 16
    for i, b in enumerate(blocks):
        assert kv.read_block(b).wait()[0].unique().tolist() == [5 + i]
    assert tier.snapshot()["promotions_disk"] == 2
    kv.release(blocks)
    assert pc.demote_cold(4) == 4
    _drain(tier)
    files = sorted(tmp_path.glob("kvblock_*.npz"))
    assert files
    files[0].write_bytes(b"torn write")
    blocks2, n_cached2, _ = pc.acquire(toks + [9, 9, 9])
    assert n_cached2 < 16 and tier.snapshot()["disk_corrupt"] >= 1
    kv.release(blocks2)
    tier.shutdown()


# ---------------------------------------------------------------------------
# the engine: parity, hand-off, telemetry
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    jmodel = jax_llama2("tiny", dtype=jnp.float32, attention_impl="reference", **TINY)
    jparams = jax.jit(lambda r: jmodel.init(r, None))(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              llama2_config("tiny", dtype=torch.float32, **TINY), device="cpu")
    tmodel = llama2("tiny", device="cpu", dtype=torch.float32, params=tparams, **TINY)
    return jmodel, jparams, tmodel


def _port(tiny, cache_on=True, host_tier=None, kv="float32", num_kv_blocks=64,
          telemetry=None, max_context=64, block=8, max_batch=64):
    return InferenceEngineV2(tiny[2], RaggedInferenceEngineConfig(
        kv_block_size=block, num_kv_blocks=num_kv_blocks,
        kv_dtype=torch.int8 if kv == "int8" else torch.float32,
        state_manager=DSStateManagerConfig(max_tracked_sequences=8, max_ragged_batch_size=max_batch,
                                           max_ragged_sequence_count=8, max_context=max_context),
        prefix_cache=PrefixCacheConfig(enabled=cache_on, host_tier=host_tier,
                                       telemetry=telemetry or CacheTelemetryConfig())),
        device="cpu")


@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_greedy_parity_tier_on_off_and_jax(tiny, kv):
    """The same requests with the whole tree pushed to the host tier
    between them: every later hit comes back by promotion, and the streams
    equal the cache off and the JAX engine with its tier on."""
    jmodel, jparams, _ = tiny
    rng = np.random.default_rng(11)
    prefix = rng.integers(0, 128, size=24, dtype=np.int32)
    reqs = [(i, np.concatenate([prefix, rng.integers(0, 128, size=int(rng.integers(4, 10)),
                                                     dtype=np.int32)])) for i in range(3)]
    reqs.append((10, reqs[0][1].copy()))
    jeng = JaxEngine(jmodel, JaxConfig(
        kv_block_size=8, num_kv_blocks=64, kv_dtype=jnp.int8 if kv == "int8" else jnp.float32,
        state_manager=JaxSMConfig(max_tracked_sequences=8, max_ragged_batch_size=64,
                                  max_ragged_sequence_count=8, max_context=64),
        use_pallas_kernels="never",
        prefix_cache=JaxPrefixCacheConfig(enabled=True,
                                          host_tier=JaxHostTierConfig(host_blocks=32))),
        params=jparams)
    outs, stats = {}, {}
    for name, eng, sched_cls in (
            ("off", _port(tiny, cache_on=False, kv=kv), DynamicSplitFuseScheduler),
            ("tier", _port(tiny, host_tier=HostTierConfig(host_blocks=32), kv=kv),
             DynamicSplitFuseScheduler),
            ("jax", jeng, JaxScheduler)):
        sched = sched_cls(eng, token_budget=32)
        for uid, p in reqs:
            sched.submit(uid, p, max_new_tokens=6)
            sched.run()
            if eng.prefix_cache is not None:
                eng.prefix_cache.demote_cold(8)
                _drain(eng.tiered_store)
        outs[name] = sched.results
        if eng.prefix_cache is not None:
            stats[name] = {k: eng.prefix_cache.stats[k] for k in ("hits", "promotions",
                                                                   "cow_copies")}
            eng.shutdown()
    assert outs["tier"] == outs["off"] == outs["jax"]
    assert stats["tier"] == stats["jax"] and stats["tier"]["promotions"] > 0


def test_export_then_install_carries_a_prefix_between_engines(tiny):
    src = _port(tiny)
    dst = _port(tiny, host_tier=HostTierConfig(host_blocks=16))
    prompt = np.random.default_rng(9).integers(0, 128, size=29, dtype=np.int32)
    cold = np.asarray(src.put([1], [prompt]))
    chunks, payloads = src.export_sequence_kv(1, prompt)
    assert len(chunks) == 3 and all(len(c) == 8 for c in chunks)
    assert dst.install_prefix_kv(chunks, payloads) == 3
    assert dst.prefix_cache.host_resident_blocks == 3
    warm = np.asarray(dst.put([2], [prompt]))  # promotes the installed chain
    assert dst.prefix_cache.stats["promotions"] == 3 and dst.query(2).prefix_cached_tokens == 24
    np.testing.assert_allclose(warm, cold, rtol=1e-5, atol=1e-5)
    assert src.install_prefix_kv(chunks, payloads) == 0  # no tier: re-prefill instead
    dst.shutdown()


# MRC estimator against an exact LRU simulation

def _key(k):
    return zlib.crc32(str(k).encode()) & 0xFFFFFFFF


def _lru_hit_rate(trace, capacity):
    cache, refs, hits = OrderedDict(), 0, 0
    for key, counted in trace:
        refs += counted
        if key in cache:
            hits += counted
            cache.move_to_end(key)
        else:
            cache[key] = True
            if len(cache) > capacity:
                cache.popitem(last=False)
    return hits / refs


def _chain_trace(n_lookups, n_chains, chain_len, seed, inserts_per=2):
    rng = np.random.default_rng(seed)
    trace, uniq = [], 10**9
    for r in (rng.zipf(1.2, size=n_lookups) - 1) % n_chains:
        trace += [(_key(f"{int(r)}-{j}"), True) for j in range(chain_len)]
        for _ in range(inserts_per):
            uniq += 1
            trace.append((_key(uniq), False))
    return trace


@pytest.mark.parametrize("rate", [1.0, 0.25])
def test_mrc_matches_exact_lru_and_the_jax_estimator(rate):
    cap = 64 if rate == 1.0 else 200
    trace = _chain_trace(1500 if rate == 1.0 else 4000, 120 if rate == 1.0 else 400,
                         4 if rate == 1.0 else 8, seed=3)
    ests = [cls(cap, sample_rate=rate, max_tracked=10**6) for cls in (MRCEstimator,
                                                                       JaxMRCEstimator)]
    for est in ests:
        for key, counted in trace:
            (est.record if counted else est.note_insert)([key])
    pred = ests[0].predict()
    assert pred == ests[1].predict()
    assert any(0.0 < v < 1.0 for v in pred.values())
    for mult in ests[0].capacity_mults:
        exact = _lru_hit_rate(trace, int(mult * cap))
        if rate == 1.0:
            assert pred[mult] == pytest.approx(exact, abs=1e-12)
        else:
            assert abs(pred[mult] - exact) <= 0.05


def test_refcount_classes_exact_under_engine_churn(tiny):
    eng = _port(tiny, num_kv_blocks=40, max_context=160, block=16, max_batch=128,
                telemetry=CacheTelemetryConfig(enabled=True, mrc_sample_rate=1.0))
    tel, pc = eng.cache_telemetry, eng.prefix_cache
    alloc = eng.state_manager.kv_cache._allocator
    total = eng.state_manager.free_blocks
    rng = np.random.default_rng(5)
    pool = [rng.integers(0, 128, size=48, dtype=np.int32) for _ in range(3)]
    live, next_uid = {}, 0
    for step in range(40):
        op = rng.choice(["put", "decode", "flush"], p=[0.4, 0.4, 0.2])
        for u in [u for u in live if eng.query(u).seen_tokens > 140]:
            eng.flush(u)
            del live[u]
        if op == "put" and len(live) < 4:
            uid, next_uid = next_uid, next_uid + 1
            prompt = np.concatenate([pool[int(rng.integers(0, 3))][:int(rng.integers(8, 49))],
                                     rng.integers(0, 128, size=int(rng.integers(4, 30)),
                                                  dtype=np.int32)])
            live[uid] = [int(eng.put([uid], [prompt], sample="greedy")[0])]
        elif op == "decode" and live:
            uids = sorted(live)
            out = eng.decode(uids, [[live[u][-1]] for u in uids], 8)
            for u, row in zip(uids, out):
                live[u].extend(int(t) for t in row)
        elif op == "flush" and live:
            uid = sorted(live)[int(rng.integers(0, len(live)))]
            eng.flush(uid)
            del live[uid]
        tree = set(pc.cached_block_ids())
        want = {"free": 0, "tree_only": 0, "active": 0}
        for b in range(total):
            rc = alloc.refcount(b)
            want["free" if rc == 0 else "tree_only" if rc == 1 and b in tree else "active"] += 1
        assert tel.refcount_classes() == want, step
        assert {b for b in range(total) if tel._tree_held[b]} == tree, step
        assert tel.counters["allocated"] - tel.counters["freed"] \
            == total - eng.state_manager.free_blocks, step
    assert tel.counters["evicted"] > 0 and tel.evicted_block_age_s.count == tel.counters["evicted"]
    snap = tel.snapshot()
    assert snap["mrc_refs"] > 0 and 0.0 <= snap["fragmentation"] <= 1.0
    assert snap["occupancy_integral_s"] > 0
    for uid in sorted(live):
        eng.flush(uid)
    pc.clear()
    assert tel.refcount_classes() == {"free": total, "tree_only": 0, "active": 0}

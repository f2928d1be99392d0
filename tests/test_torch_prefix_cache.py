"""PyTorch port: refcounted copy-on-write KV blocks and radix-tree prefix
reuse, against the JAX package.

The same operations drive the port's allocator / radix tree and the JAX
package's (match results, refcounts, stats must agree), the port's
``copy_block`` moves KV and int8 scales through views that share the pools'
storage, and the serving engine (tiny Llama, fp32 on the CPU, weights
carried across with ``params_from_jax``) gives greedy streams with the
cache on identical to its own with the cache off and to the JAX engine's
with its cache on, with equal ``hits`` / ``cow_copies`` /
``prefill_tokens_skipped``. Prompts are made from seeds with numpy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2 import DSStateManagerConfig as JaxSMConfig
from deepspeed_tpu.inference.v2 import DynamicSplitFuseScheduler as JaxScheduler
from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.inference.v2 import PrefixCacheConfig as JaxPrefixCacheConfig
from deepspeed_tpu.inference.v2 import RaggedInferenceEngineConfig as JaxConfig
from deepspeed_tpu.inference.v2.ragged import BlockedAllocator as JaxAllocator
from deepspeed_tpu.inference.v2.ragged import BlockedKVCache as JaxKVCache
from deepspeed_tpu.inference.v2.ragged import PrefixKVCache as JaxPrefixKVCache
from deepspeed_tpu.models import llama2 as jax_llama2
from deepspeed_tpu_torch.inference.v2 import (DSStateManagerConfig, DynamicSplitFuseScheduler,
                                              InferenceEngineV2, PrefixCacheConfig,
                                              RaggedInferenceEngineConfig)
from deepspeed_tpu_torch.inference.v2.ragged import BlockedAllocator, BlockedKVCache, PrefixKVCache
from deepspeed_tpu_torch.models import llama2, llama2_config, params_from_jax

TINY = dict(num_layers=2, hidden_size=64, num_heads=4, num_kv_heads=2, intermediate_size=128,
            vocab_size=128, max_seq_len=256)
SIDES = {"jax": (JaxAllocator, JaxKVCache, JaxPrefixKVCache, jnp.float32),
         "torch": (BlockedAllocator, BlockedKVCache, PrefixKVCache, torch.float32)}


# ---------------------------------------------------------------------------
# allocator refcounts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("side", ["jax", "torch"])
def test_allocator_refcounts_and_double_free(side):
    alloc_cls = SIDES[side][0]
    a = alloc_cls(8)
    blocks = a.allocate(3)
    a.free(blocks[0])
    with pytest.raises(ValueError, match="double free"):
        a.free(blocks[0])
    with pytest.raises(ValueError, match="double free"):
        a.free(7)  # never allocated
    with pytest.raises(ValueError, match="invalid block id"):
        a.free(99)
    rest = a.allocate(a.free_blocks)
    held = list(map(int, rest)) + [int(blocks[1]), int(blocks[2])]
    assert sorted(held) == list(range(8))
    b = int(blocks[1])
    a.incref(b)
    a.incref(b)
    assert a.refcount(b) == 3 and a.total_blocks == 8
    a.release(b)
    a.release(b)
    assert a.free_blocks == 0  # one owner still holds it
    a.release(b)
    assert a.refcount(b) == 0 and a.free_blocks == 1
    assert a.refcount_snapshot()[b] == 0
    with pytest.raises(ValueError, match="incref on free block"):
        a.incref(b)


def test_allocator_telemetry_hook_sees_allocate_and_physical_free():
    seen = []

    class Hook:
        def on_allocate(self, blocks):
            seen.append(("alloc", sorted(int(b) for b in blocks)))

        def on_free(self, blocks):
            seen.append(("free", sorted(int(b) for b in blocks)))

    a = BlockedAllocator(4)
    a.telemetry = Hook()
    blocks = a.allocate(2)
    a.incref(blocks[0])
    a.release(blocks)  # only blocks[1] reaches zero
    a.release(blocks[0])
    assert seen == [("alloc", sorted(map(int, blocks))), ("free", [int(blocks[1])]),
                    ("free", [int(blocks[0])])]


# ---------------------------------------------------------------------------
# the radix tree, the same operations on both packages
# ---------------------------------------------------------------------------

class _Seq:
    """The publish surface of DSSequenceDescriptor."""

    def __init__(self, tokens, blocks, seen=None):
        self.token_history = list(tokens)
        self.kv_blocks = list(blocks)
        self.seen_tokens = len(tokens) if seen is None else seen
        self.history_valid = True


def _tiny_pool(side, num_blocks=8, block_size=4):
    _, kv_cls, _, dt = SIDES[side]
    if side == "torch":
        return kv_cls(num_layers=1, num_kv_heads=1, head_dim=2, num_blocks=num_blocks,
                      block_size=block_size, dtype=dt, device="cpu")
    return kv_cls(num_layers=1, num_kv_heads=1, head_dim=2, num_blocks=num_blocks,
                  block_size=block_size, dtype=dt)


def _match_tuple(m):
    return (m.n_cached_tokens, [int(b) for b in m.shared_blocks], m.cow_src, m.cow_tokens,
            m.host_blocks)


def _radix_script(side):
    kv = _tiny_pool(side)
    pc = SIDES[side][2](kv)
    toks = [1, 2, 3, 4, 5, 6, 7, 8]
    blocks = [int(b) for b in kv.reserve(2)]
    out = {"inserted": pc.publish(_Seq(toks, blocks)), "blocks": blocks,
           "refcounts": [kv.refcount(b) for b in blocks]}
    out["full"] = _match_tuple(pc.match([1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9]))
    out["capped"] = _match_tuple(pc.match(toks))  # the last token is always computed
    out["midblock"] = _match_tuple(pc.match([1, 2, 3, 4, 5, 6, 99, 98]))
    out["miss"] = _match_tuple(pc.match([7, 7, 7, 7, 7]))
    out["min_hit"] = _match_tuple(SIDES[side][2](kv, min_hit_blocks=2).match([1, 2, 3, 4, 9]))
    # acquire with copy-on-write of the partial tail, then release
    free0 = kv.free_blocks
    got, n_cached, shared = pc.acquire([1, 2, 3, 4, 5, 6, 99, 98])
    out["acquire"] = ([int(b) for b in got], n_cached, shared, free0 - kv.free_blocks,
                      [kv.refcount(b) for b in blocks + [int(got[-1])]])
    out["stats"] = dict(pc.stats)
    kv.release(got)
    out["after_release"] = (kv.free_blocks, [kv.refcount(b) for b in blocks])
    return out


def test_radix_match_insert_cap_and_acquire_equal_jax():
    j, t = _radix_script("jax"), _radix_script("torch")
    assert t == j
    b0, b1 = t["blocks"]
    assert t["refcounts"] == [2, 2]  # owner + tree
    assert t["full"] == (8, [b0, b1], None, 0, 0)
    assert t["capped"] == (7, [b0], b1, 3, 0)
    assert t["midblock"] == (6, [b0], b1, 2, 0)
    assert t["miss"][0] == 0 and t["min_hit"][0] == 0
    got, n_cached, shared, used, rc = t["acquire"]
    assert n_cached == 6 and shared == 1 and used == 1
    assert got[0] == b0 and got[1] != b1
    assert rc == [3, 2, 1]  # owner + tree + holder; COW source untouched; private copy
    assert t["stats"]["cow_copies"] == 1 and t["stats"]["hits"] == 1


def test_match_is_pure():
    kv = _tiny_pool("torch")
    pc = PrefixKVCache(kv)
    a = kv.reserve(2)
    pc.publish(_Seq([1, 2, 3, 4, 5, 6, 7, 8], a))
    held, _, _ = pc.acquire([1, 2, 3, 4, 9, 9, 9])

    def snapshot():
        nodes, stack = [], [((), pc._root)]
        while stack:
            path, node = stack.pop()
            for chunk, child in sorted(node.children.items()):
                nodes.append((path + chunk, child.block, child.last_access))
                stack.append((path + chunk, child))
        return {"nodes": sorted(nodes), "clock": pc._clock, "free": kv.free_blocks,
                "refcounts": [kv.refcount(b) for b in pc.cached_block_ids()]
                + [kv.refcount(b) for b in held], "stats": dict(pc.stats)}

    before = snapshot()
    for probe in ([1, 2, 3, 4, 5, 6, 7, 8], [1, 2, 3, 4, 5, 6, 7, 8, 9, 9],
                  [1, 2, 3, 4, 5, 6, 99, 98], [7, 7, 7, 7, 7], [1], []):
        pc.match(np.asarray(probe, np.int32))
    assert snapshot() == before


def _lru_script(side):
    kv = _tiny_pool(side)
    pc = SIDES[side][2](kv)
    a, b = [int(x) for x in kv.reserve(2)], [int(x) for x in kv.reserve(2)]
    pc.publish(_Seq([1, 2, 3, 4, 5, 6, 7, 8], a))
    pc.publish(_Seq([9, 9, 9, 9, 8, 8, 8, 8], b))
    kv.release(a)
    kv.release(b)
    out = {"evictable": pc.evictable_blocks, "free": kv.free_blocks}
    held = pc.acquire([1, 2, 3, 4, 5, 6, 7, 8, 7])[0]  # chain A pinned, B is LRU
    out["evict1"] = pc.evict(1)
    out["cached1"] = sorted(pc.cached_block_ids())
    out["evict10"] = pc.evict(10)  # only b[0] is tree-only now
    out["cached2"] = sorted(pc.cached_block_ids())
    out["cleared"] = pc.clear()
    kv.release(held)
    out["end"] = (pc.n_cached_blocks, kv.free_blocks)
    out["stats"] = {k: pc.stats[k] for k in ("evictions", "evicted_tokens", "evict_starved")}
    return out, a, b


def test_lru_eviction_and_clear_equal_jax():
    (j, _, _), (t, a, b) = _lru_script("jax"), _lru_script("torch")
    assert t == j
    assert t["evictable"] == 4 and t["free"] == 4
    assert t["evict1"] == 1 and b[1] not in t["cached1"] and b[0] in t["cached1"]
    assert t["evict10"] == 1 and set(a) <= set(t["cached2"])
    assert t["end"] == (0, 8)


@pytest.mark.parametrize("quantized", [False, True])
def test_copy_block_moves_kv_and_int8_scales_in_place(quantized):
    kv = BlockedKVCache(num_layers=2, num_kv_heads=2, head_dim=2, num_blocks=4, block_size=4,
                        dtype=torch.int8 if quantized else torch.float32, device="cpu")
    g = torch.Generator().manual_seed(0)
    kv.k_flat.copy_(torch.randint(-100, 100, kv.k_flat.shape, generator=g).to(kv.dtype))
    kv.v_flat.copy_(torch.randint(-100, 100, kv.v_flat.shape, generator=g).to(kv.dtype))
    if quantized:
        kv.k_scale_flat.copy_(torch.rand(kv.k_scale_flat.shape, generator=g))
        kv.v_scale_flat.copy_(torch.rand(kv.v_scale_flat.shape, generator=g))
        # the layer-strided scale views alias the pools the forward writes
        for view, flat in zip(kv._scale_l, (kv.k_scale_flat, kv.v_scale_flat)):
            assert view.untyped_storage().data_ptr() == flat.untyped_storage().data_ptr()
            assert view.data_ptr() == flat.data_ptr()
    before_k = kv.k_pool.clone()
    before_ks = kv.k_scale_flat.clone() if quantized else None
    kv.copy_block(1, 3)
    np.testing.assert_array_equal(kv.k_pool[:, 12:16].numpy(), before_k[:, 4:8].numpy())
    np.testing.assert_array_equal(kv.v_pool[:, 12:16].numpy(), kv.v_pool[:, 4:8].numpy())
    np.testing.assert_array_equal(kv.k_pool[:, :12].numpy(), before_k[:, :12].numpy())
    if quantized:
        flat = kv.k_scale_flat[:, :-1].reshape(2, 2, 16)  # [nkv, L, NB * bs], a copy to read
        np.testing.assert_array_equal(flat[:, :, 12:16].numpy(),
                                      before_ks[:, :-1].reshape(2, 2, 16)[:, :, 4:8].numpy())
        np.testing.assert_array_equal(flat[:, :, :12].numpy(),
                                      before_ks[:, :-1].reshape(2, 2, 16)[:, :, :12].numpy())
        assert kv.k_scale_flat[:, -1].eq(before_ks[:, -1]).all()  # scratch column untouched
    # read_block / write_block round trip through host memory
    snap = kv.read_block(3).wait()
    kv.write_block(0, *snap)
    np.testing.assert_array_equal(kv.k_pool[:, 0:4].numpy(), kv.k_pool[:, 12:16].numpy())
    if quantized:
        np.testing.assert_array_equal(kv._scale_l[1][:, :, 0:4].numpy(),
                                      kv._scale_l[1][:, :, 12:16].numpy())
    assert kv.block_bytes() == 2 * 2 * 4 * 2 * (2 * kv.k_flat.element_size()
                                                + (4 if quantized else 0))


# ---------------------------------------------------------------------------
# engine level: the port against itself (cache off) and the JAX engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    jmodel = jax_llama2("tiny", dtype=jnp.float32, attention_impl="reference", **TINY)
    jparams = jax.jit(lambda r: jmodel.init(r, None))(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              llama2_config("tiny", dtype=torch.float32, **TINY), device="cpu")
    tmodel = llama2("tiny", device="cpu", dtype=torch.float32, params=tparams, **TINY)
    return jmodel, jparams, tmodel


def _engines(tiny, cache_on=True, num_kv_blocks=64, kv="float32", max_context=64):
    jmodel, jparams, tmodel = tiny
    sm = dict(max_tracked_sequences=8, max_ragged_batch_size=64, max_ragged_sequence_count=8,
              max_context=max_context)
    jeng = JaxEngine(jmodel, JaxConfig(
        kv_block_size=8, num_kv_blocks=num_kv_blocks,
        kv_dtype=jnp.int8 if kv == "int8" else jnp.float32, state_manager=JaxSMConfig(**sm),
        use_pallas_kernels="never", prefix_cache=JaxPrefixCacheConfig(enabled=cache_on)),
        params=jparams)
    teng = InferenceEngineV2(tmodel, RaggedInferenceEngineConfig(
        kv_block_size=8, num_kv_blocks=num_kv_blocks,
        kv_dtype=torch.int8 if kv == "int8" else torch.float32,
        state_manager=DSStateManagerConfig(**sm),
        prefix_cache=PrefixCacheConfig(enabled=cache_on)), device="cpu")
    return jeng, teng


def _cow_requests(seed):
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, 128, size=24, dtype=np.int32)  # 3 full 8-token blocks
    reqs = [(i, np.concatenate([prefix, rng.integers(0, 128, size=int(rng.integers(4, 10)),
                                                     dtype=np.int32)])) for i in range(3)]
    # diverges 4 tokens into block 2: the shared prefix ends mid-block
    reqs.append((10, np.concatenate([prefix[:20], rng.integers(0, 128, size=7, dtype=np.int32)])))
    reqs.append((11, reqs[0][1].copy()))  # an exact repeat: the cap forces a COW tail
    return reqs


@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_scheduler_streams_and_stats_equal_cache_off_and_jax(tiny, kv):
    reqs = _cow_requests(7)
    outs, stats = {}, {}
    for cache_on in (False, True):
        jeng, teng = _engines(tiny, cache_on, kv=kv)
        for name, eng, sched_cls in (("jax", jeng, JaxScheduler),
                                     ("torch", teng, DynamicSplitFuseScheduler)):
            sched = sched_cls(eng, token_budget=32)
            for uid, p in reqs:
                sched.submit(uid, p, max_new_tokens=6)
            outs[name, cache_on] = sched.run()
            if cache_on:
                pc = eng.prefix_cache
                stats[name] = ({k: pc.stats[k] for k in ("lookups", "hits", "cached_tokens",
                                                         "cow_copies", "insertions")},
                               sched.stats["prefill_tokens_skipped"], pc.n_cached_blocks)
                assert eng.state_manager.n_tracked_sequences == 0
    assert outs["torch", True] == outs["torch", False]
    assert outs["torch", True] == outs["jax", True]
    assert outs["jax", True] == outs["jax", False]
    assert stats["torch"] == stats["jax"]
    st, skipped, _ = stats["torch"]
    assert st["hits"] >= 2 and st["cow_copies"] >= 1 and skipped >= 16


def test_put_level_hit_trims_the_chunk(tiny):
    jeng, teng = _engines(tiny)
    prompt = np.random.default_rng(3).integers(0, 128, size=20, dtype=np.int32)
    res = {}
    for name, eng in (("jax", jeng), ("torch", teng)):
        cold = np.asarray(eng.put([1], [prompt]))
        eng.flush(1)
        warm = np.asarray(eng.put([2], [prompt]))  # the same prompt: a hit
        seq = eng.query(2)
        res[name] = (cold, warm, seq.prefix_cached_tokens, seq.shared_blocks, seq.seen_tokens,
                     eng.query()["prefix_cache"]["hits"])
        eng.flush(2)
        assert eng.free_blocks + eng.prefix_cache.n_cached_blocks \
            == eng.state_manager.kv_cache.total_blocks
    cold, warm, cached, shared, seen, hits = res["torch"]
    assert cached == 16 and shared == 2 and seen == prompt.size and hits == 1  # 2 full blocks
    assert res["jax"][2:] == res["torch"][2:]
    np.testing.assert_allclose(warm, cold, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(warm, res["jax"][1], rtol=2e-4, atol=2e-4)


def test_warm_cache_admission_never_overcommits(tiny):
    """An 8-block pool half held by the tree: a filler and a repeat of the
    cached prompt must not be co-admitted on credit counted twice (the run
    would then fail mid-way); streams match the cache off and JAX."""
    rng = np.random.default_rng(21)
    pA = rng.integers(0, 128, size=32, dtype=np.int32)
    filler = rng.integers(0, 128, size=28, dtype=np.int32)
    outs = {}
    for cache_on in (False, True):  # JAX with its cache on (the off run is the port's)
        jeng, teng = _engines(tiny, cache_on, num_kv_blocks=8)
        sides = (("jax", jeng, JaxScheduler),) if cache_on else ()
        for name, eng, sched_cls in sides + (("torch", teng, DynamicSplitFuseScheduler),):
            s1 = sched_cls(eng, token_budget=64)
            s1.submit(1, pA, max_new_tokens=4)
            s1.run()
            s2 = sched_cls(eng, token_budget=64)
            s2.submit(2, filler, max_new_tokens=4)
            s2.submit(3, pA.copy(), max_new_tokens=8)
            outs[name, cache_on] = s2.run()
    assert outs["torch", True] == outs["torch", False] == outs["jax", True]


def test_parity_under_eviction_pressure(tiny):
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, 128, size=int(rng.integers(20, 31)), dtype=np.int32)
               for _ in range(8)]
    outs, evictions = {}, {}
    for cache_on in (False, True):  # JAX with its cache on (the off run is the port's)
        jeng, teng = _engines(tiny, cache_on, num_kv_blocks=16)
        for name, eng in ((("jax", jeng),) if cache_on else ()) + (("torch", teng),):
            outs[name, cache_on] = []
            for i, p in enumerate(prompts):
                outs[name, cache_on].append(
                    int(np.asarray(eng.put([i], [p], sample="greedy")).reshape(-1)[0]))
                eng.flush(i)
            if cache_on:
                evictions[name] = eng.prefix_cache.stats["evictions"]
    assert outs["torch", True] == outs["torch", False] == outs["jax", True]
    assert evictions["torch"] == evictions["jax"] > 0


def test_decode_publishes_and_rollback_copies_a_shared_tail(tiny):
    """A decode horizon publishes the blocks it completes; a rewind into a
    block the tree shares copies it first, so the tree's copy keeps its
    KV."""
    _, teng = _engines(tiny)
    prompt = np.random.default_rng(5).integers(0, 128, size=13, dtype=np.int32)
    first = teng.put([1], [prompt], sample="greedy")
    teng.decode([1], [[int(first[0])]], 8)
    seq = teng.query(1)
    assert seq.seen_tokens == 21 and seq.published_blocks == 2
    shared = seq.kv_blocks[1]
    kv = teng.state_manager.kv_cache
    assert kv.refcount(shared) == 2  # the sequence and the tree
    before = kv.k_pool[:, shared * 8:(shared + 1) * 8].clone()
    teng.state_manager.rollback_to(seq, 12)  # mid-block 1
    assert seq.kv_blocks[1] != shared and kv.refcount(shared) == 1
    torch.testing.assert_close(kv.k_pool[:, seq.kv_blocks[1] * 8:][:, :4], before[:, :4])
    teng.put([1], [np.asarray([7], np.int32)])  # writes slot 12 into the private copy
    torch.testing.assert_close(kv.k_pool[:, shared * 8:(shared + 1) * 8], before)
    teng.flush(1)

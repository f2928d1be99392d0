"""PyTorch port: the serving slice end to end on the CPU.

``InferenceEngineV2.put`` + ``decode`` and ``DynamicSplitFuseScheduler``
of the port against the JAX package's engine (plain attention,
``use_pallas_kernels="never"``) on shared tiny-Mistral weights (GQA and a
sliding window) in fp32: greedy token streams must be IDENTICAL, and
admission control must return the same ``SchedulingResult`` on
over-budget batches. Prompts are made from a seed with numpy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2 import DSStateManagerConfig as JaxSMConfig
from deepspeed_tpu.inference.v2 import DynamicSplitFuseScheduler as JaxScheduler
from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.inference.v2 import RaggedInferenceEngineConfig as JaxConfig
from deepspeed_tpu.models import mistral as jax_mistral
from deepspeed_tpu_torch.inference.v2 import (DSStateManagerConfig, DynamicSplitFuseScheduler,
                                              InferenceEngineV2, PrefixCacheConfig,
                                              RaggedInferenceEngineConfig, SchedulingError,
                                              SchedulingResult, SpeculativeConfig,
                                              build_model_engine)
from deepspeed_tpu_torch.models import mistral, mistral_config, params_from_jax

TINY = dict(num_layers=2, hidden_size=64, num_heads=4, num_kv_heads=2, intermediate_size=128,
            vocab_size=512, max_seq_len=256, sliding_window=24)
SM = dict(max_tracked_sequences=8, max_ragged_batch_size=48, max_ragged_sequence_count=4,
          max_context=96)
VOCAB = TINY["vocab_size"]


def _engines(kv="float32", num_kv_blocks=48, **sm_over):
    sm = dict(SM, **sm_over)
    jmodel = jax_mistral("tiny", dtype=jnp.float32, attention_impl="reference", **TINY)
    jparams = jmodel.init(jax.random.PRNGKey(7))
    jkv = jnp.int8 if kv == "int8" else jnp.float32
    jeng = JaxEngine(jmodel, JaxConfig(kv_block_size=8, num_kv_blocks=num_kv_blocks, kv_dtype=jkv,
                                       state_manager=JaxSMConfig(**sm),
                                       use_pallas_kernels="never"), params=jparams)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              mistral_config("tiny", dtype=torch.float32, **TINY), device="cpu")
    tmodel = mistral("tiny", device="cpu", dtype=torch.float32, params=tparams, **TINY)
    tkv = torch.int8 if kv == "int8" else torch.float32
    teng = InferenceEngineV2(tmodel, RaggedInferenceEngineConfig(
        kv_block_size=8, num_kv_blocks=num_kv_blocks, kv_dtype=tkv,
        state_manager=DSStateManagerConfig(**sm)), device="cpu")
    return jeng, teng


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, VOCAB, size=n).astype(np.int32) for n in lens]


@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_put_and_decode_streams_identical_to_jax(kv):
    """Prefill (one mixed put), then decode horizons with an eos rollback:
    the argmax streams and the freed blocks match the JAX engine."""
    jeng, teng = _engines(kv)
    p = _prompts(1, [11, 30, 5])
    outs = []
    for eng in (jeng, teng):
        first = np.asarray(eng.put([1, 2, 3], p, sample="greedy")).reshape(-1)
        toks = np.asarray(eng.decode([1, 2, 3], [[t] for t in first], 8))
        eos = int(toks[1, 2])  # uid 2 "ends" mid-horizon on its third token
        more = np.asarray(eng.decode([1, 2, 3], [[t] for t in toks[:, -1]], 4,
                                     eos_token_ids=[None, eos, None]))
        logits = np.asarray(eng.put([4], [p[0][:7]]))  # a fresh prefill's logits
        outs.append((first, toks, more, eng.free_blocks, logits))
    (jf, jt, jm, jfree, jl), (tf, tt, tm, tfree, tl) = outs
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(tm, jm)
    assert tfree == jfree
    np.testing.assert_allclose(tl, jl, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("budget", [48, 16])
def test_scheduler_streams_identical_to_jax(budget):
    """SplitFuse over a queue that outgrows the batch: prompts chunked at
    the token budget, decode rows riding with prefill chunks, multi-step
    decode bursts, an eos stop — every greedy stream equals the JAX one."""
    jeng, teng = _engines()
    prompts = _prompts(2, [40, 9, 23, 3, 17, 31])
    results = []
    for eng, sched_cls in ((jeng, JaxScheduler), (teng, DynamicSplitFuseScheduler)):
        sched = sched_cls(eng, token_budget=budget)
        for uid, p in enumerate(prompts):
            sched.submit(uid, p, max_new_tokens=5 + 3 * uid, eos_token_id=(
                VOCAB - 1 if uid == 4 else None))
        results.append(sched.run())
        assert eng.free_blocks == 48
    assert results[1] == results[0]
    assert sum(len(v) for v in results[1].values()) > 60


def test_over_budget_batches_get_the_same_scheduling_results():
    jeng, teng = _engines(num_kv_blocks=12, max_ragged_sequence_count=3,
                          max_ragged_batch_size=40, max_context=64)
    for eng in (jeng, teng):
        eng.put([100], [np.arange(20, dtype=np.int32)])  # 3 blocks held
    cases = [
        ([1, 2, 3, 4], [1, 1, 1, 1]),  # too many sequences
        ([1, 1], [2, 2]),              # one uid twice
        ([1], [41]),                   # over the token budget
        ([1, 2], [30, 11]),            # over the token budget, summed
        ([100], [45]),                 # past max_context with the cached 20
        ([1, 2], [40, 0]),             # 5 + 0 blocks: fits
        ([1, 2, 3], [33, 1, 1]),       # 5 + 1 + 1 = 7 of the 9 free blocks: fits
        ([1, 2], [39, 33]),            # over the token budget first
        ([1], [40]),                   # 5 blocks: fits
    ]
    for uids, lens in cases:
        got = teng.can_schedule(uids, lens)
        assert got is not None and got.name == jeng.can_schedule(uids, lens).name, (uids, lens)
    # a pool too small for the batch: KV limit on both
    for eng in (jeng, teng):
        eng.put([101], [np.arange(40, dtype=np.int32)])
        eng.put([102], [np.arange(30, dtype=np.int32)])
    assert teng.can_schedule([1], [9]).name == jeng.can_schedule([1], [9]).name \
        == SchedulingResult.KVCacheLimitExceeded.name
    with pytest.raises(SchedulingError):
        teng.put([1], [np.arange(9, dtype=np.int32)])


def test_unported_features_are_refused():
    base = dict(kv_block_size=8, num_kv_blocks=16,
                state_manager=DSStateManagerConfig(**SM))
    kw = dict(device="cpu", dtype=torch.float32, **TINY)
    with pytest.raises(NotImplementedError):
        build_model_engine("mistral", "tiny", RaggedInferenceEngineConfig(
            prefix_cache=PrefixCacheConfig(enabled=True), **base), **kw)
    with pytest.raises(NotImplementedError):
        build_model_engine("mistral", "tiny", RaggedInferenceEngineConfig(
            speculative=SpeculativeConfig(mode="ngram"), **base), **kw)
    eng = build_model_engine("mistral", "tiny", RaggedInferenceEngineConfig(**base), **kw)
    with pytest.raises(NotImplementedError):
        eng.put([1], [np.arange(4, dtype=np.int32)], sample="sample")
    with pytest.raises(ValueError):
        build_model_engine("gpt2", "tiny", RaggedInferenceEngineConfig(**base), **kw)


def test_cuda_is_the_default_device():
    """Entry points run on CUDA unless asked for the CPU; without a card the
    default raises instead of falling back."""
    kw = dict(dtype=torch.float32, **TINY)
    if torch.cuda.is_available():
        eng = build_model_engine("mistral", "tiny", RaggedInferenceEngineConfig(
            kv_block_size=8, num_kv_blocks=16), **kw)
        assert eng.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            build_model_engine("mistral", "tiny", RaggedInferenceEngineConfig(
                kv_block_size=8, num_kv_blocks=16), **kw)

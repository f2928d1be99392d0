"""PyTorch port: the v1 inference engine (``init_inference``), its KV-cache
forward and the hybrid engine, against the JAX package.

Weights come from the JAX package's initialisation (``params_from_jax``),
inputs from numpy seeds; everything runs in fp32 on a tiny Mistral (2
layers, hidden 64, GQA 4/2, window 16) or the reference tests'
learned-position / layernorm / gelu / bias / tied configuration. On the CPU
``attention_impl="flash"`` takes the paged route, whose kernel wrappers
return their plain versions there; ``"auto"`` and ``"reference"`` take the
dense einsum. Greedy streams must equal the JAX package's token for token;
sampled streams cannot (threefry), so sampling is held to seeded
determinism, ``top_k=1`` == greedy, and the softmax's frequencies.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import TransformerConfig as JaxConfig
from deepspeed_tpu.models import TransformerLM as JaxLM
from deepspeed_tpu.models import mistral_config as jax_mistral_config
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu.ops.pallas.paged_attention import \
    paged_attention_reference as jax_paged_reference
from deepspeed_tpu.parallel import groups
from deepspeed_tpu.parallel.mesh import single_device_mesh
from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig
from deepspeed_tpu_torch.inference.engine import _select
from deepspeed_tpu_torch.models import (TransformerConfig, TransformerLM, mistral_config,
                                        params_from_jax)
from deepspeed_tpu_torch.models import transformer as tt

TINY = dict(num_layers=2, hidden_size=64, num_heads=4, num_kv_heads=2, intermediate_size=128,
            vocab_size=97, max_seq_len=256, sliding_window=16)
MOE = dict(moe_num_experts=4, moe_top_k=2)
# the reference tests' learned-position configuration (tests/test_inference.py:32-43)
LEARNED = dict(vocab_size=96, hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
               intermediate_size=128, max_seq_len=64, positions="learned", norm="layernorm",
               mlp="gelu", use_bias=True, tie_embeddings=True)


def _mistral(impl="auto", **over):
    kw = dict(TINY, **over)
    return (jax_mistral_config("tiny", dtype=jnp.float32, attention_impl="reference", **kw),
            mistral_config("tiny", dtype=torch.float32, attention_impl=impl, **kw))


def _learned(impl="auto"):
    return (JaxConfig(dtype=jnp.float32, attention_impl="reference", **LEARNED),
            TransformerConfig(dtype=torch.float32, attention_impl=impl, **LEARNED))


def _jax_params(jcfg, seed=0):
    return jax.tree.map(np.asarray, jt.init_params(jcfg, jax.random.PRNGKey(seed)))


@functools.lru_cache(maxsize=None)
def _tiny_prefill():
    """The tiny Mistral's JAX weights, a [2, 16] prompt, and the JAX
    package's prefill logits and cache (32 positions) and full-forward
    logits on it (computed once for the parametrised tests)."""
    jcfg, _ = _mistral()
    npp = _jax_params(jcfg)
    ids = _ids(0, (2, 16), 97)
    jlogits, jcache = jax.jit(lambda p, i: jt.forward_with_cache(
        jcfg, p, i, jt.init_kv_cache(jcfg, 2, 32, dtype=jnp.float32)))(npp, jnp.asarray(ids))
    jfull = jax.jit(lambda p, i: jt.forward(jcfg, p, i))(npp, jnp.asarray(ids))
    return npp, ids, np.asarray(jlogits), jax.tree.map(np.asarray, jcache), np.asarray(jfull)


@functools.lru_cache(maxsize=None)
def _learned_reference():
    jcfg, _ = _learned()
    npp = _jax_params(jcfg, seed=1)
    ids = _ids(1, (1, 12), 96)
    return npp, ids, np.asarray(jax.jit(lambda p, i: jt.forward(jcfg, p, i))(npp, jnp.asarray(ids)))


def _model(tcfg, npp):
    return TransformerLM(tcfg, params_from_jax(npp, tcfg, device="cpu"), device="cpu")


def _ids(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, size=shape).astype(np.int32)


def _jax_engine(jcfg):
    """The JAX package's ``init_inference`` on one device (fp32)."""
    groups.set_mesh(single_device_mesh())
    return deepspeed_tpu.init_inference(model=JaxLM(jcfg), config={"dtype": "float32"})


# ---------------------------------------------------------------------------
# forward_with_cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["reference", "flash"])
def test_prefill_matches_jax_forward_with_cache_and_forward(impl):
    """Prefill logits against the JAX package's ``forward_with_cache`` and
    ``forward`` (fp32 sums in another order: rtol / atol 1e-4), and the k / v
    the port wrote in place against the JAX cache, positions below the
    prompt's length (1e-5)."""
    _, tcfg = _mistral(impl)
    npp, ids, jlogits, jcache, jfull = _tiny_prefill()
    cache = tt.init_kv_cache(tcfg, 2, 128, device="cpu")  # the paged route takes 128-multiples
    logits, cache = tt.forward_with_cache(tcfg, params_from_jax(npp, tcfg, device="cpu"),
                                          torch.from_numpy(ids), cache)
    assert cache["length"] == 16 and logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), jlogits, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(logits.numpy(), jfull, rtol=1e-4, atol=1e-4)
    for name in ("k", "v"):
        np.testing.assert_allclose(cache[name][:, :, :16].numpy(), jcache[name][:, :, :16],
                                   rtol=1e-5, atol=1e-5)
        assert not cache[name][:, :, 16:].any()


@pytest.mark.parametrize("impl", ["reference", "flash"])
def test_token_by_token_decode_matches_jax(impl):
    """The reference test's learned-position / layernorm / gelu / bias /
    tied model, decoded one token a step through the cache, against the JAX
    package's full forward on the whole sequence (2e-4, as that test)."""
    _, tcfg = _learned(impl)
    npp, ids, jfull = _learned_reference()
    params = params_from_jax(npp, tcfg, device="cpu")
    cache = tt.init_kv_cache(tcfg, 1, 128, device="cpu")
    steps = []
    for t in range(12):
        logits, cache = tt.forward_with_cache(tcfg, params, torch.from_numpy(ids[:, t:t + 1]),
                                              cache)
        steps.append(logits[:, 0].numpy())
    np.testing.assert_allclose(np.stack(steps, axis=1), jfull, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("B,T,start,window,alibi", [(2, 1, 37, None, False),
                                                    (3, 1, 200, 16, True),
                                                    (4, 20, 5, 16, False),
                                                    (2, 40, 100, None, True)])
def test_paged_route_matches_dense_and_jax_paged_reference(B, T, start, window, alibi):
    """One layer's cached attention: the paged route (the cache viewed as a
    pool of 128-slot blocks with the identity table) against the dense
    einsum, and against the JAX package's ``paged_attention_reference`` on
    the same pool and table (fp32: 1e-5). Decode (T 1) and prefill-shaped
    calls (B x T >= 64 takes the prefill wrapper), a window, ALiBi."""
    nq, nkv, d, smax = 4, 2, 16, 256
    cfg = mistral_config("tiny", dtype=torch.float32, num_heads=nq, num_kv_heads=nkv,
                         hidden_size=nq * d, sliding_window=window,
                         positions="alibi" if alibi else "rotary")
    rng = np.random.default_rng(B * 1000 + T)
    q = torch.from_numpy(rng.normal(size=(B, T, nq, d)).astype(np.float32))
    ck = torch.from_numpy(rng.normal(size=(B, smax, nkv, d)).astype(np.float32))
    cv = torch.from_numpy(rng.normal(size=(B, smax, nkv, d)).astype(np.float32))
    cache = {"k": ck[None], "v": cv[None], "length": start}
    desc = tt._paged_descriptors(cfg, cache, B, T, start)
    paged = tt._cached_attention(cfg, q, ck, cv, start, "paged", desc)
    dense = tt._cached_attention(cfg, q, ck, cv, start, "dense")
    np.testing.assert_allclose(paged.numpy(), dense.numpy(), rtol=1e-5, atol=1e-5)
    tables, seq_idx, pos, _ = desc
    assert tables.tolist() == [[b * 2 + j for j in range(2)] for b in range(B)]
    ref = jax.jit(lambda *a: jax_paged_reference(
        *a, tt.V1_BLOCK, window=window, alibi=tt.alibi_slopes(nq) if alibi else None))(
            q.reshape(B * T, nq, d).numpy(), ck.reshape(B * smax, nkv, d).numpy(),
            cv.reshape(B * smax, nkv, d).numpy(), tables.numpy(), seq_idx.numpy(), pos.numpy())
    np.testing.assert_allclose(paged.reshape(B * T, nq, d).numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("impl", ["reference", "flash"])
def test_rounded_cache_length_gives_the_same_logits(impl):
    """``generate`` allocates S + new rounded up to 128: a prefill and three
    decode steps give the same logits over a cache of exactly S + new
    positions (the dense route; the paged route takes only multiples of 128,
    so it runs at 128 against the dense exact one) and of 128 (fp32 sums of
    extra exact zeros in another order: 1e-5)."""
    _, tcfg = _mistral("reference")
    params = params_from_jax(_tiny_prefill()[0], tcfg, device="cpu")
    ids = _ids(2, (2, 9), 97)

    def run(cfg, smax):
        cache = tt.init_kv_cache(cfg, 2, smax, device="cpu")
        out, tok = [], torch.from_numpy(ids)
        for _ in range(4):
            logits, cache = tt.forward_with_cache(cfg, params, tok, cache)
            out.append(logits[:, -1])
            tok = torch.argmax(logits[:, -1:], dim=-1)
        return torch.stack(out).numpy()

    _, rounded_cfg = _mistral(impl)
    np.testing.assert_allclose(run(rounded_cfg, 128), run(tcfg, 12), rtol=1e-5, atol=1e-5)


def test_route_gate():
    """The KV-cache forward's route as a pure function of (attention_impl,
    device, cache dtype, nq, nkv, d, Smax): 'reference' is always dense,
    'auto' dense on the CPU, and every other case paged; a paged cache the
    kernels do not take raises, naming every miss, and never falls back to
    the dense route."""
    bf, f32 = torch.bfloat16, torch.float32
    mistral = (32, 8, 128)
    cases = [
        (("auto", "cuda", bf, *mistral, 1024), "paged"),
        (("auto", "cuda", bf, 32, 8, 64, 128), "paged"),
        (("auto", "cuda", bf, 8, 1, 128, 256), "paged"),  # g 8, one decode head tile
        (("auto", "cuda", bf, 32, 8, 96, 1024), "paged"),  # head dims 80 / 96 / 256
        (("auto", "cuda", bf, 16, 1, 128, 1024), "paged"),  # g 16, two head tiles
        (("auto", "cpu", bf, *mistral, 1024), "dense"),
        (("auto", "cpu", f32, *mistral, 1000), "dense"),
        (("auto", "cuda", f32, *mistral, 1024), "cache dtype torch.float32"),
        (("auto", "cuda", torch.float16, *mistral, 1024), "cache dtype torch.float16"),
        (("auto", "cuda", bf, 32, 8, 32, 1024), "head_dim 32"),
        (("auto", "cuda", bf, 16, 3, 128, 1024), "16 query heads over 3"),
        (("auto", "cuda", bf, *mistral, 1000), "cache length 1000"),
        (("reference", "cuda", f32, 32, 8, 96, 1000), "dense"),
        (("reference", "cpu", f32, *mistral, 1024), "dense"),
        (("flash", "cpu", f32, *mistral, 1024), "paged"),
        (("flash", "cpu", f32, 32, 8, 96, 1024), "paged"),  # plain versions take any shape
        (("flash", "cpu", f32, *mistral, 1000), "cache length 1000"),
        (("flash", "cuda", f32, *mistral, 1024), "cache dtype"),
        (("flash", "cuda", bf, *mistral, 1024), "paged"),
    ]
    for args, want in cases:
        if want in ("paged", "dense"):
            assert tt.cached_attention_route(*args) == want, args
        else:
            with pytest.raises(ValueError, match=want):
                tt.cached_attention_route(*args)
    with pytest.raises(ValueError) as err:
        tt.cached_attention_route("auto", "cuda", f32, 32, 8, 32, 1000)
    assert str(err.value).count(";") == 3  # every miss is named


def test_flash_route_refuses_a_cache_off_the_block():
    _, tcfg = _mistral("flash")
    params = params_from_jax(_tiny_prefill()[0], tcfg, device="cpu")
    cache = tt.init_kv_cache(tcfg, 1, 100, device="cpu")
    with pytest.raises(ValueError, match="multiple of 128"):
        tt.forward_with_cache(tcfg, params, torch.zeros((1, 4), dtype=torch.int64), cache)


# ---------------------------------------------------------------------------
# init_inference: greedy generate against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("over", [{}, dict(MOE, moe_impl="einsum"), dict(MOE, moe_impl="grouped")],
                         ids=["dense", "moe-einsum", "moe-grouped"])
def test_init_inference_greedy_generate_matches_jax(over):
    """Greedy streams of the port's ``init_inference(...).generate`` equal
    the JAX package's on the same weights, token for token, through the
    dense route (``"auto"`` on the CPU) and the paged route (``"flash"``);
    a second call repeats the stream; eos truncation as the JAX engine's."""
    jcfg, tcfg = _mistral(**over)
    jeng = _jax_engine(jcfg)
    prompt = _ids(3, (2, 7), 97)
    jout = np.asarray(jeng.generate(prompt, max_new_tokens=6))
    npp = jax.tree.map(np.asarray, jeng.params)
    for impl in ("auto", "flash"):
        tcfg.attention_impl = impl
        eng = deepspeed_tpu_torch.init_inference(_model(tcfg, npp), {"dtype": "float32"},
                                                 device="cpu")
        out = eng.generate(prompt, max_new_tokens=6)
        assert out.shape == (2, 13) and out.dtype == jout.dtype
        np.testing.assert_array_equal(out, jout, err_msg=impl)
        np.testing.assert_array_equal(eng.generate(prompt, max_new_tokens=6), out)
    eos = int(jout[0, 9])
    got = eng.generate(prompt, max_new_tokens=6, eos_token_id=eos)
    want = jout.copy()
    for row in want:
        hits = np.flatnonzero(row[7:] == eos)
        if hits.size:
            row[7 + hits[0] + 1:] = eos
    np.testing.assert_array_equal(got, want)
    assert (got[0, 10:] == eos).all()


def test_moe_model_is_served_by_v1_and_refused_by_v2():
    """A MoE model builds as a serving ``TransformerLM`` and generates
    through ``init_inference``; ``InferenceEngineV2`` still refuses it."""
    from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2

    model = TransformerLM(mistral_config("tiny", dtype=torch.float32, **TINY, **MOE), device="cpu")
    out = deepspeed_tpu_torch.init_inference(model, {"dtype": "float32"},
                                             device="cpu").generate(_ids(4, (1, 5), 97), 3)
    assert out.shape == (1, 8) and ((0 <= out) & (out < 97)).all()
    with pytest.raises(NotImplementedError, match="dense MLPs"):
        InferenceEngineV2(model, device="cpu")


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

def test_sampling_is_seeded_and_top_k_1_is_greedy():
    _, tcfg = _mistral()
    eng = deepspeed_tpu_torch.init_inference(TransformerLM(tcfg, device="cpu"),
                                             {"dtype": "float32"}, device="cpu")
    prompt = _ids(5, (2, 6), 97)
    a = eng.generate(prompt, 8, temperature=1.0, seed=7)
    np.testing.assert_array_equal(eng.generate(prompt, 8, temperature=1.0, seed=7), a)
    assert not np.array_equal(eng.generate(prompt, 8, temperature=1.0, seed=8), a)
    np.testing.assert_array_equal(eng.generate(prompt, 8, temperature=0.7, top_k=1, seed=3),
                                  eng.generate(prompt, 8))


@pytest.mark.parametrize("temperature,top_k", [(1.0, 0), (0.5, 0), (2.0, 3)])
def test_sampled_frequencies_match_the_softmax(temperature, top_k):
    """20000 draws of one five-letter row: each letter's frequency within
    0.015 of softmax(logits / temperature) over the top_k letters (about
    4.5 standard deviations of a frequency near 0.5), and letters outside
    the top_k never drawn."""
    logits = torch.tensor([1.0, 0.2, -0.5, 2.0, 0.0])
    n = 20000
    gen = torch.Generator().manual_seed(0)
    draws = _select(logits.expand(n, 5), gen, temperature, top_k)
    freq = np.bincount(draws.numpy(), minlength=5) / n
    scaled = logits / temperature
    if top_k:
        scaled = torch.where(scaled < torch.topk(scaled, top_k).values[-1], -torch.inf, scaled)
    want = torch.softmax(scaled, dim=0).numpy()
    np.testing.assert_allclose(freq, want, atol=0.015)
    assert (freq[want == 0] == 0).all()


# ---------------------------------------------------------------------------
# profiling, config, device
# ---------------------------------------------------------------------------

def test_profile_model_time():
    """``profile_model_time`` / ``model_times`` (the analog of
    tests/test_inference.py:73-95): per-forward times after enabling,
    drained on read."""
    _, tcfg = _mistral()
    eng = deepspeed_tpu_torch.init_inference(TransformerLM(tcfg, device="cpu"),
                                             {"dtype": "float32"}, device="cpu")
    ids = np.zeros((1, 8), np.int32)
    assert eng(ids).shape == (1, 8, 97)  # before enabling: nothing recorded
    with pytest.raises(AssertionError, match="not enabled"):
        eng.model_times()
    eng.profile_model_time()
    eng.forward(ids)
    eng.forward(ids)
    times = eng.model_times()
    assert len(times) == 2 and all(t > 0 for t in times)
    assert eng.model_times() == []


def test_config_aliases_and_refusals():
    cfg = DeepSpeedInferenceConfig.from_dict(
        {"kernel_injection": True, "tp": {"tp_size": 1}, "tm": False, "max_out_tokens": 64,
         "replace_method_kernel": True, "injection_dict": {}, "moe": {"num_experts": [8]},
         "enable_cuda_graph": True, "dtype": "fp16", "replace_method": "auto"})
    assert (cfg.kernel_inject, cfg.tensor_parallel.tp_size, cfg.triangular_masking,
            cfg.max_tokens, cfg.replace_with_kernel_inject, cfg.injection_policy,
            cfg.moe.moe_experts) == (True, 1, False, 64, True, {}, [8])
    assert cfg.compute_dtype == torch.float16
    assert DeepSpeedInferenceConfig(dtype=torch.float32).compute_dtype == torch.float32
    assert DeepSpeedInferenceConfig().compute_dtype == torch.bfloat16
    # tensor parallelism (A3b) is accepted, under both names
    for tp in ({"tensor_parallel": {"tp_size": 2}}, {"tp": {"tp_size": 2}}):
        assert DeepSpeedInferenceConfig.from_dict(tp).tensor_parallel.tp_size == 2
    refusals = [({"not_a_key": 1}, "not_a_key"), ({"tp": {"bogus": 1}}, "bogus"),
                ({"quant": {"enabled": True}}, "A7"), ({"dtype": "int8"}, "A7"),
                ({"checkpoint": "ckpt.json"}, "A9"), ({"dtype": "float64"}, "float64")]
    for bad, name in refusals:
        with pytest.raises(Exception, match=name):
            DeepSpeedInferenceConfig.from_dict(bad)
    with pytest.raises(NotImplementedError, match="hybrid engine at world size >= 2.*A1"):
        deepspeed_tpu_torch.DeepSpeedConfig({"train_batch_size": 1,
                                             "hybrid_engine": {"inference_tp_size": 2}})
    model = TransformerLM(_mistral()[1], device="cpu")
    eng = deepspeed_tpu_torch.init_inference(model, device="cpu", dtype="float32",
                                             enable_cuda_graph=True)
    assert eng.config.enable_cuda_graph and eng.eval() is eng
    with pytest.raises(NotImplementedError, match="A9"):
        eng.load_checkpoint("somewhere")


def test_default_device_is_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = TransformerLM(_mistral()[1], device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        deepspeed_tpu_torch.init_inference(model, {"dtype": "float32"})


# ---------------------------------------------------------------------------
# the hybrid engine
# ---------------------------------------------------------------------------

HYBRID_DS_CONFIG = {"train_batch_size": 2, "train_micro_batch_size_per_gpu": 2,
                    "gradient_accumulation_steps": 1,
                    "optimizer": {"type": "AdamW", "params": {"lr": 5e-2}},
                    "hybrid_engine": {"enabled": True}, "steps_per_print": 100}


def test_hybrid_engine_train_generate_interleave_matches_jax():
    """At world size 1 (the analog of tests/test_module_inject.py:102-136):
    ``initialize`` returns the hybrid engine; ``generate`` restores the train
    mode; two ``train_batch`` steps move the view once; the greedy rollouts
    before and after equal the JAX hybrid engine's on the same weights and
    batches (fp32)."""
    from deepspeed_tpu.runtime.hybrid_engine import DeepSpeedHybridEngine as JaxHybrid

    jcfg, tcfg = _mistral("reference")
    je, _, _, _ = deepspeed_tpu.initialize(model=JaxLM(jcfg), config=HYBRID_DS_CONFIG,
                                           mesh=single_device_mesh())
    assert isinstance(je, JaxHybrid)
    npp = jax.tree.map(np.asarray, je.state["params"])
    model = TransformerLM(tcfg, params_from_jax(npp, tcfg, device="cpu", per_layer=True),
                          trainable=True)
    te, _, _, _ = deepspeed_tpu_torch.initialize(model=model, config=HYBRID_DS_CONFIG)
    assert isinstance(te, deepspeed_tpu_torch.DeepSpeedHybridEngine)
    rng = np.random.default_rng(6)
    batch = {"input_ids": rng.integers(0, 97, size=(2, 16)).astype(np.int32)}
    prompt = rng.integers(0, 97, size=(2, 6)).astype(np.int32)

    out1 = te.generate(prompt, max_new_tokens=5)
    assert out1.shape == (2, 11) and te._train_mode
    np.testing.assert_array_equal(out1, np.asarray(je.generate(prompt, max_new_tokens=5)))
    wq_before = te._inference_engine.params["blocks"][0]["wq"].clone()
    for _ in range(2):
        te.train_batch(batch)
        je.train_batch(batch)
    te.eval()
    out2 = te.generate(prompt, max_new_tokens=5)
    assert not te._train_mode  # an engine in eval mode stays there
    te.train()
    assert te._inference_params_step == 2 and len(te.generate_latency()) == 2
    assert not torch.equal(te._inference_engine.params["blocks"][0]["wq"], wq_before)
    np.testing.assert_array_equal(out2, np.asarray(je.generate(prompt, max_new_tokens=5)))
    a, b = torch.ones(3, 2), torch.ones(2, 4)
    w = torch.zeros(3, 4)
    fused = te.fuse_lora_weight(w, a, b, 0.5)
    assert torch.equal(fused, torch.full((3, 4), 1.0))
    assert torch.equal(te.unfuse_lora_weight(fused, a, b, 0.5), w)


def test_engines_leave_the_model_config_alone():
    """An engine runs a copy of the model's config in its compute dtype: the
    caller's model keeps its own, so a hybrid engine whose rollouts run in
    fp32 goes on training in the bf16 its model's config names."""
    _, tcfg = _mistral()
    model = TransformerLM(tcfg, device="cpu")
    eng = deepspeed_tpu_torch.init_inference(model, {"dtype": "bfloat16"}, device="cpu")
    assert eng.model_config.dtype == torch.bfloat16 and model.config.dtype == torch.float32
    train_cfg = dataclasses.replace(tcfg, dtype=torch.bfloat16)
    te, _, _, _ = deepspeed_tpu_torch.initialize(
        model=TransformerLM(train_cfg, device="cpu", trainable=True), config=HYBRID_DS_CONFIG)
    out = te.generate(_ids(7, (1, 4), 97), max_new_tokens=2)
    assert out.shape == (1, 6)
    assert te._inference_engine.model_config.dtype == torch.float32
    assert te.module.config.dtype == torch.bfloat16

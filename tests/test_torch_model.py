"""PyTorch port: model numerics, the weights carrier and the ragged forward.

Inputs are made from a seed with numpy and fed to both packages in fp32:
rotary, norms, MLP activations, ALiBi slopes, the ``params_from_jax`` round
trip (stacked serving weights, per-layer fp32 training masters and the
Adam state), and ``ragged_forward`` (logits and updated KV pools: fp32, bf16
and int8 pools with scales) on a tiny Mistral with GQA and a sliding window.
The last test scans the port's sources: it imports neither ``jax`` nor the
JAX package.
"""

import ast
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2.model_implementations.flat_model import \
    ragged_forward as jax_ragged_forward
from deepspeed_tpu.models import llama2_config as jax_llama2_config
from deepspeed_tpu.models import mistral_config as jax_mistral_config
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu_torch.inference.v2.model_implementations.flat_model import ragged_forward
from deepspeed_tpu_torch.inference.v2.ragged.kv_cache import BlockedKVCache
import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import (TransformerLM, init_params, llama2_config,
                                        mistral_config, params_from_jax, params_to_numpy)
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.models.convert import (optimizer_state_from_numpy,
                                                optimizer_state_to_numpy)

REPO = os.path.join(os.path.dirname(__file__), os.pardir)
TINY = dict(num_layers=2, hidden_size=64, num_heads=4, num_kv_heads=2, intermediate_size=128,
            vocab_size=256, max_seq_len=256, sliding_window=16)


def _cfgs(**over):
    kw = dict(TINY, **over)
    return (jax_mistral_config("tiny", dtype=jnp.float32, attention_impl="reference", **kw),
            mistral_config("tiny", dtype=torch.float32, **kw))


def _jax_params(jcfg, seed=0):
    params = jt.init_params(jcfg, jax.random.PRNGKey(seed))
    return jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("rotary_dim", [None, 8])
def test_rope_matches_jax(rotary_dim):
    jcfg, tcfg = _cfgs(rotary_dim=rotary_dim)
    rng = np.random.default_rng(0)
    positions = rng.integers(0, 4000, size=11).astype(np.int32)
    x = rng.normal(size=(1, 11, 4, 16)).astype(np.float32)
    js, jc = jt.rope_table(jcfg, jnp.asarray(positions))
    ts, tc = tt.rope_table(tcfg, torch.from_numpy(positions))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5, atol=1e-5)
    out = tt.apply_rope(torch.from_numpy(x), ts, tc).numpy()
    ref = np.asarray(jt.apply_rope(jnp.asarray(x), js, jc))
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norm_matches_jax(kind):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(7, 64)).astype(np.float32) * 3
    scale = rng.normal(size=(64, )).astype(np.float32)
    bias = rng.normal(size=(64, )).astype(np.float32)
    out = tt._norm(torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(bias), kind, 1e-5)
    ref = jt._norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), kind, 1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mlp", ["swiglu", "gelu", "relu"])
def test_mlp_activation_matches_jax(mlp):
    jcfg, tcfg = _cfgs(mlp=mlp)
    rng = np.random.default_rng(2)
    up = rng.normal(size=(5, 32)).astype(np.float32) * 2
    gate = rng.normal(size=(5, 32)).astype(np.float32) * 2
    out = tt.mlp_activation(tcfg, torch.from_numpy(up), torch.from_numpy(gate))
    ref = jt.mlp_activation(jcfg, jnp.asarray(up), jnp.asarray(gate))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n", [1, 4, 6, 12, 32])
def test_alibi_slopes_match_jax(n):
    np.testing.assert_array_equal(tt.alibi_slopes(n), jt.alibi_slopes(n))


MOE = dict(moe_num_experts=4, moe_top_k=2)


@pytest.mark.parametrize("moe", [False, True])
def test_params_from_jax_round_trip_and_layout(moe):
    """Name-for-name copy: the round trip is exact in fp32; in bf16 only
    matrix weights change dtype (the MoE experts too, not the fp32 gate),
    and init_params draws the same tree."""
    jcfg, tcfg = _cfgs(**(MOE if moe else {}))
    npp = _jax_params(jcfg)
    back = params_to_numpy(params_from_jax(npp, tcfg, device="cpu"))
    assert back.keys() == npp.keys()
    for group in npp:
        assert back[group].keys() == npp[group].keys()
        for name in npp[group]:
            np.testing.assert_array_equal(back[group][name], npp[group][name])
    bf = params_from_jax(npp, tcfg, device="cpu", dtype=torch.bfloat16)
    assert bf["blocks"]["wq"].dtype == torch.bfloat16
    assert bf["embed"]["embedding"].dtype == torch.bfloat16
    assert bf["blocks"]["ln1_scale"].dtype == torch.float32
    assert bf["final_norm"]["scale"].dtype == torch.float32
    if moe:
        assert {bf["blocks"][n].dtype for n in ("moe_wi", "moe_wg", "moe_wo")} == {torch.bfloat16}
        assert bf["blocks"]["gate_wg"].dtype == torch.float32
    drawn = init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    assert {g: {n: tuple(t.shape) for n, t in leaves.items()} for g, leaves in drawn.items()} == \
        {g: {n: a.shape for n, a in leaves.items()} for g, leaves in npp.items()}


@pytest.mark.parametrize("moe", [False, True])
def test_trainable_masters_round_trip_exactly(moe):
    """numpy -> fp32 masters of a trainable TransformerLM (one parameter per
    layer and weight) -> numpy is exact, and the per-layer draws of
    init_params equal the stacked ones."""
    jcfg, tcfg = _cfgs(**(MOE if moe else {}))
    npp = _jax_params(jcfg, seed=7)
    model = TransformerLM(tcfg, params_from_jax(npp, tcfg, device="cpu", dtype=torch.float32,
                                                per_layer=True), trainable=True)
    params = list(model.parameters())
    assert all(p.dtype == torch.float32 and p.requires_grad for p in params)
    n_block = len(npp["blocks"])
    assert len(params) == tcfg.num_layers * n_block + sum(
        len(v) for g, v in npp.items() if g != "blocks")
    back = params_to_numpy(model.params())
    for group in npp:
        for name in npp[group]:
            np.testing.assert_array_equal(back[group][name], npp[group][name])
    stacked = init_params(tcfg, torch.Generator().manual_seed(1), device="cpu",
                          dtype=torch.float32)
    per_layer = init_params(tcfg, torch.Generator().manual_seed(1), device="cpu",
                            dtype=torch.float32, per_layer=True)
    for name, t in stacked["blocks"].items():
        assert torch.equal(t, torch.stack([layer[name] for layer in per_layer["blocks"]]))


@pytest.mark.parametrize("mode,moe", [("never", False), ("always", False), ("never", True),
                                      ("always", True)])
def test_optimizer_state_round_trip_exactly(mode, moe):
    """numpy mu / nu / step -> the engine's Adam state (``FusedAdamState``
    with the fused kernel, the optax-equivalent optimizer's otherwise) ->
    numpy is exact; leaves are matched by name (the state tree lists them
    in reverse order here)."""
    _, tcfg = _cfgs(**(MOE if moe else {}))
    model = TransformerLM(tcfg, device="cpu", trainable=True)
    engine, _, _, _ = deepspeed_tpu_torch.initialize(model=model, config={
        "train_batch_size": 2, "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
        "tpu": {"pallas_fused_adam": mode}})
    assert (engine._pallas_adam is not None) == (mode == "always")
    like = params_to_numpy(model.params())
    rng = np.random.default_rng(8)
    state = {"step": np.int32(7),
             "mu": {g: {n: rng.normal(size=a.shape).astype(np.float32)
                        for n, a in reversed(v.items())} for g, v in like.items()},
             "nu": {g: {n: rng.random(size=a.shape).astype(np.float32)
                        for n, a in reversed(v.items())} for g, v in like.items()}}
    optimizer_state_from_numpy(engine, state)
    back = optimizer_state_to_numpy(engine)
    assert int(back["step"]) == 7 and int(engine.adam_state()[2]) == 7
    for key in ("mu", "nu"):
        for group in like:
            for name in like[group]:
                np.testing.assert_array_equal(back[key][group][name], state[key][group][name])


def test_unported_model_features_are_refused():
    """A MoE model builds in the serving layout (the v1 engine serves it,
    tests/test_torch_inference_v1.py) and trains on the per-layer model; the
    ragged serving engine refuses both (the JAX v2 engine's flat model runs
    dense MLPs only, too). A block-sparse model trains, and serving it is
    refused by the engine and the ragged forward, as the JAX package refuses
    it."""
    serving = TransformerLM(mistral_config("tiny", moe_num_experts=4, **TINY), device="cpu")
    assert serving.params()["blocks"]["moe_wi"].shape[:2] == (TINY["num_layers"], 4)
    from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2

    with pytest.raises(NotImplementedError, match="dense MLPs"):
        InferenceEngineV2(serving, device="cpu")
    trainable = TransformerLM(mistral_config("tiny", moe_num_experts=4, **TINY), device="cpu",
                              trainable=True)
    with pytest.raises(NotImplementedError, match="dense MLPs"):
        InferenceEngineV2(trainable, device="cpu")
    sparse_cfg = llama2_config("tiny", sparse_attention=dict(SPARSE, attention="unidirectional"),
                               **SPARSE_TINY)
    sparse = TransformerLM(sparse_cfg, device="cpu", trainable=True)
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, 97, (1, 64)))
    assert torch.isfinite(sparse.loss({"input_ids": ids}))
    with pytest.raises(NotImplementedError, match="sparse_attention serving"):
        InferenceEngineV2(TransformerLM(sparse_cfg, device="cpu"), device="cpu")
    with pytest.raises(NotImplementedError, match="sparse_attention serving"):
        ragged_forward(sparse_cfg, 8, sparse.params(), *([None] * 8))


# a tiny MHA Llama with a genuinely sparse unidirectional layout at seq 64:
# 4 block rows of 16, local windows of 2 blocks plus one global block per
# window, a different global pattern for each pair of heads
SPARSE_TINY = dict(num_layers=2, hidden_size=64, num_heads=4, num_kv_heads=4,
                   intermediate_size=128, vocab_size=97, max_seq_len=64)
SPARSE = {"mode": "fixed", "block": 16, "different_layout_per_head": True, "num_local_blocks": 2,
          "num_global_blocks": 1, "num_different_global_patterns": 2,
          "attention": "unidirectional"}


def _sparse_cfgs(sparse=SPARSE):
    kw = dict(SPARSE_TINY, sparse_attention=sparse)
    return (jax_llama2_config("tiny", dtype=jnp.float32, attention_impl="reference", **kw),
            llama2_config("tiny", dtype=torch.float32, **kw))


def test_sparse_model_logits_loss_and_every_gradient_match_jax():
    """fp32: the port's block-sparse model (the plain forward on the CPU,
    the gathered recompute in the backward) against JAX ``forward`` and
    ``jax.grad(loss_fn)`` on shared weights, rtol 2e-4 / atol 2e-5."""
    jcfg, tcfg = _sparse_cfgs()
    npp = _jax_params(jcfg, seed=4)
    model = TransformerLM(tcfg, params_from_jax(npp, tcfg, device="cpu", dtype=torch.float32,
                                                per_layer=True), trainable=True)
    ids = np.random.default_rng(5).integers(0, 97, size=(2, 64)).astype(np.int32)
    logits = model(torch.from_numpy(ids))
    ref = np.asarray(jt.forward(jcfg, jax.tree.map(jnp.asarray, npp), jnp.asarray(ids)))
    np.testing.assert_allclose(logits.detach().numpy(), ref, rtol=2e-4, atol=2e-5)
    dense = np.asarray(jt.forward(dataclasses.replace(jcfg, sparse_attention=None),
                                  jax.tree.map(jnp.asarray, npp), jnp.asarray(ids)))
    assert not np.allclose(ref, dense, atol=1e-2)  # the layout really drops keys
    loss = model.loss({"input_ids": torch.from_numpy(ids)})
    loss.backward()
    j_loss, j_grads = jax.jit(jax.value_and_grad(
        lambda p: jt.loss_fn(jcfg, p, {"input_ids": jnp.asarray(ids)})))(
            jax.tree.map(jnp.asarray, npp))
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=2e-5)
    grads = params_to_numpy({g: ([{n: p.grad for n, p in layer.items()} for layer in leaves]
                                 if isinstance(leaves, list) else
                                 {n: p.grad for n, p in leaves.items()})
                             for g, leaves in model.params().items()})
    for group, leaves in jax.tree.map(np.asarray, j_grads).items():
        for name, g in leaves.items():
            np.testing.assert_allclose(grads[group][name], g, rtol=2e-4, atol=2e-5,
                                       err_msg=f"{group}/{name}")


def test_all_visible_sparse_layout_equals_dense_causal():
    """A unidirectional 'fixed' layout whose local window covers every block
    row is the dense causal model."""
    jcfg, tcfg = _sparse_cfgs({"mode": "fixed", "block": 16, "num_local_blocks": 4,
                               "attention": "unidirectional"})
    npp = _jax_params(jcfg, seed=6)
    params = params_from_jax(npp, tcfg, device="cpu", dtype=torch.float32)
    ids = torch.from_numpy(np.random.default_rng(7).integers(0, 97, size=(2, 64)))
    full = tt.forward(tcfg, params, ids)
    dense = tt.forward(dataclasses.replace(tcfg, sparse_attention=None,
                                           attention_impl="reference"), params, ids)
    np.testing.assert_allclose(full.numpy(), dense.numpy(), rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("over,match", [
    (dict(sliding_window=32), "sliding_window"),
    (dict(positions="alibi"), "alibi"),
    (dict(num_kv_heads=2), "num_kv_heads == num_heads"),
])
def test_sparse_attention_config_checks_raise_as_jax(over, match):
    kw = dict(SPARSE_TINY, sparse_attention=SPARSE)
    kw.update(over)
    for make in (jax_llama2_config, llama2_config):
        with pytest.raises(NotImplementedError, match=match):
            make("tiny", **kw)


def _ragged_case(rng, cfg_t, bs, nb, max_blocks):
    """Two sequences (a 13-token chunk from position 0 and a 6-token chunk
    after 9 cached tokens), one decode token of a third, and 4 pad tokens."""
    tables = rng.permutation(nb)[:3 * max_blocks].astype(np.int32).reshape(3, max_blocks)
    tables = np.concatenate([tables, np.zeros((1, max_blocks), np.int32)])  # pad row
    seq_idx = np.asarray([0] * 13 + [1] * 6 + [2] + [0] * 4, np.int32)
    pos = np.asarray(list(range(13)) + list(range(9, 15)) + [21] + [0] * 4, np.int32)
    valid = np.asarray([True] * 20 + [False] * 4)
    ids = rng.integers(0, cfg_t.vocab_size, size=seq_idx.size).astype(np.int32)
    last = np.asarray([12, 18, 19, 0], np.int32)
    return ids, seq_idx, pos, valid, tables, last


@pytest.mark.parametrize("kv", ["float32", "bfloat16", "int8"])
def test_ragged_forward_matches_jax(kv):
    """Logits and the updated pools (and int8 scales) equal the JAX
    forward's on shared weights and shared initial pools (fp32 model)."""
    jcfg, tcfg = _cfgs()
    npp = _jax_params(jcfg, seed=3)
    params = params_from_jax(npp, tcfg, device="cpu")
    rng = np.random.default_rng(4)
    L, nkv, d, bs, nb, mb = tcfg.num_layers, tcfg.num_kv_heads, tcfg.head_dim, 8, 16, 4
    ids, seq_idx, pos, valid, tables, last = _ragged_case(rng, tcfg, bs, nb, mb)
    cache = BlockedKVCache(L, nkv, d, nb, bs, dtype=getattr(torch, kv), device="cpu")
    if kv == "int8":
        k0 = rng.integers(-127, 128, size=cache.k_pool.shape).astype(np.int8)
        v0 = rng.integers(-127, 128, size=cache.v_pool.shape).astype(np.int8)
        ks0 = rng.uniform(0.001, 0.05, size=cache.k_scale.shape).astype(np.float32)
        vs0 = rng.uniform(0.001, 0.05, size=cache.v_scale.shape).astype(np.float32)
        cache.k_scale.copy_(torch.from_numpy(ks0))
        cache.v_scale.copy_(torch.from_numpy(vs0))
        jscales = dict(k_scale=jnp.asarray(ks0), v_scale=jnp.asarray(vs0))
    else:
        k0 = rng.normal(size=cache.k_pool.shape).astype(np.float32)
        v0 = rng.normal(size=cache.v_pool.shape).astype(np.float32)
        jscales = {}
    cache.k_pool.copy_(torch.from_numpy(k0))
    cache.v_pool.copy_(torch.from_numpy(v0))
    jk0, jv0 = jnp.asarray(k0), jnp.asarray(v0)
    if kv == "bfloat16":
        jk0, jv0 = jk0.astype(jnp.bfloat16), jv0.astype(jnp.bfloat16)

    t = torch.from_numpy
    pools = cache.pools()
    scales = {"k_scale": pools[2], "v_scale": pools[3]} if kv == "int8" else {}
    logits = ragged_forward(tcfg, bs, params, t(ids), t(seq_idx), t(pos), t(valid), t(tables),
                            t(last), pools[0], pools[1], **scales)
    jout = jax_ragged_forward(jcfg, bs, npp, jnp.asarray(ids), jnp.asarray(seq_idx),
                              jnp.asarray(pos), jnp.asarray(valid), jnp.asarray(tables),
                              jnp.asarray(last), jk0, jv0, **jscales)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jout[0]), rtol=2e-4, atol=2e-4)
    if kv == "int8":
        # int8 codes may differ by one where rounding sits on a .5 boundary
        # after fp32 products in another order; the scales agree closely
        for ours, ref in ((cache.k_pool, jout[1]), (cache.v_pool, jout[2])):
            diff = np.abs(ours.numpy().astype(np.int32) - np.asarray(ref).astype(np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
        np.testing.assert_allclose(cache.k_scale.numpy(), np.asarray(jout[3]), rtol=1e-5)
        np.testing.assert_allclose(cache.v_scale.numpy(), np.asarray(jout[4]), rtol=1e-5)
    elif kv == "bfloat16":
        # fresh K/V agree to fp32 rounding before the bf16 cast, so a stored
        # value may differ by one bf16 ulp (2^-8 relative) where the cast
        # sits on a rounding boundary
        for ours, ref in ((cache.k_pool, jout[1]), (cache.v_pool, jout[2])):
            a, b = ours.float().numpy(), np.asarray(ref.astype(jnp.float32))
            np.testing.assert_allclose(a, b, rtol=2**-7, atol=1e-6)
            assert (a != b).mean() < 1e-3
    else:
        np.testing.assert_allclose(cache.k_pool.numpy(), np.asarray(jout[1]), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(cache.v_pool.numpy(), np.asarray(jout[2]), rtol=1e-5,
                                   atol=1e-5)


def _port_sources():
    root = os.path.join(REPO, "deepspeed_tpu_torch")
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_port_imports_neither_jax_nor_the_jax_package():
    bad = []
    n = 0
    for path in _port_sources():
        n += 1
        tree = ast.parse(open(path).read(), filename=path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
                names = [node.module]
            elif (isinstance(node, ast.Call) and getattr(node.func, "id", "") == "__import__"
                  and node.args and isinstance(node.args[0], ast.Constant)):
                names = [str(node.args[0].value)]
            for name in names:
                top = name.split(".")[0]
                if top in ("jax", "jaxlib", "deepspeed_tpu", "flax", "optax"):
                    bad.append(f"{os.path.relpath(path, REPO)}:{node.lineno} imports {name}")
    assert n > 20 and os.path.exists(os.path.join(REPO, "chip_smoke.py"))
    scanned = {os.path.relpath(p, REPO) for p in _port_sources()}
    for rel in ("accelerator/__init__.py", "accelerator/abstract_accelerator.py",
                "accelerator/real_accelerator.py", "accelerator/cpu_accelerator.py",
                "accelerator/cuda_accelerator.py", "ops/__init__.py", "ops/evoformer_attn.py",
                "ops/evoformer_attention.py", "inference/config.py", "inference/engine.py",
                "runtime/hybrid_engine.py", "comm/functional.py", "module_inject/__init__.py",
                "module_inject/layers.py", "module_inject/auto_tp.py",
                "module_inject/policies.py", "module_inject/replace_module.py",
                "module_inject/tp_shard.py"):
        assert os.path.join("deepspeed_tpu_torch", rel) in scanned, rel
    assert not bad, "\n".join(bad)

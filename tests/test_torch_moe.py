"""PyTorch port, MoE slice: gating, dispatch, the MoE layers, the MoE
transformer and its training against the JAX package.

Inputs come from numpy with a seed and go to both packages; the weights are
the JAX package's initialisation moved with ``params_from_jax``. Without a
random generator (``rng=None`` on the JAX side) the routing is identical:
``block_align_dispatch``'s outputs and the gating's combine / dispatch
masks compare exactly, ties included. Numbers compare in fp32 at rtol 1e-5
/ atol 1e-6 for single layers and rtol 2e-5 (losses) / 2e-4 + atol 2e-6
(parameters after three Adam steps) for whole models, as the port's other
parity tests (fp32 sums in another order). The sampled gating cannot
reproduce threefry's bits: it is held to seeded determinism and to the
distribution it samples from. The grouped path runs with block_rows 8 on
both sides (the JAX package's CPU choice, its Pallas kernels in interpret
mode).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.inference.v2.modules import DSMoERegistry as JaxMoERegistry
from deepspeed_tpu.inference.v2.modules.configs import DSMoEConfig as JaxMoEConfig
from deepspeed_tpu.inference.v2.modules.module_registry import ConfigBundle as JaxBundle
from deepspeed_tpu.models import TransformerLM as JaxLM
from deepspeed_tpu.models import mistral_config as jax_mistral_config
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu.moe import grouped as jgrouped
from deepspeed_tpu.moe import layer as jlayer
from deepspeed_tpu.moe import sharded_moe as jsm
from deepspeed_tpu.parallel.mesh import single_device_mesh
from deepspeed_tpu_torch.inference.v2.modules import ConfigBundle, DSMoEConfig, DSMoERegistry
from deepspeed_tpu_torch.models import TransformerLM, mistral_config, params_from_jax, params_to_numpy
from deepspeed_tpu_torch.moe import grouped as tgrouped
from deepspeed_tpu_torch.moe import layer as tlayer
from deepspeed_tpu_torch.moe import sharded_moe as tsm

TOL = dict(rtol=1e-5, atol=1e-6)
TINY = dict(num_layers=2, hidden_size=64, num_heads=4, num_kv_heads=2, intermediate_size=128,
            vocab_size=256, max_seq_len=256, sliding_window=16, moe_num_experts=4, moe_top_k=2)


def t(x):
    return torch.from_numpy(np.array(x))


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return tuple(tree.shape)


def tree_to_torch(tree):
    if isinstance(tree, dict):
        return {k: tree_to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, dtype=np.float32))


# ---------------------------------------------------------------------------
# dispatch and gating
# ---------------------------------------------------------------------------

def _w_se_with_ties(seed, S=24, E=4, dtype=np.float32):
    """Combine weights with dropped assignments (zero weights, so top-k
    picks among equal zeros) and a fully dropped token."""
    rng = np.random.default_rng(seed)
    w = rng.random((S, E)).astype(np.float32)
    w[rng.random((S, E)) < 0.55] = 0.0
    w[3] = 0.0
    w[5, 1] = w[5, 2] = 0.25  # a tie between two kept weights
    return w.astype(dtype)


@pytest.mark.parametrize("top_k,dtype", [(1, "float32"), (2, "float32"), (2, "bfloat16")])
def test_block_align_dispatch_equals_jax_ties_included(top_k, dtype):
    w = _w_se_with_ties(top_k)
    jw = jnp.asarray(w).astype(getattr(jnp, dtype))
    tw = t(w).to(getattr(torch, dtype))
    ref = jgrouped.block_align_dispatch(jw, top_k, 8)
    got = tgrouped.block_align_dispatch(tw, top_k, 8)
    assert got[4] == ref[4]
    for name, a, b in zip(("tok", "w", "dest", "block_expert"), got[:4], ref[:4]):
        np.testing.assert_array_equal(a.float().numpy(), np.asarray(b.astype(jnp.float32)),
                                      err_msg=name)
    assert got[3].dtype == torch.int32


def test_block_align_dispatch_precomputed_routing_equals_jax():
    rng = np.random.default_rng(7)
    idx = rng.integers(0, 5, size=(10, 2)).astype(np.int32)
    w = rng.random((10, 2)).astype(np.float32)
    ref = jgrouped.block_align_dispatch(None, 2, 8, top_idx=jnp.asarray(idx), top_w=jnp.asarray(w),
                                        num_experts=5)
    got = tgrouped.block_align_dispatch(None, 2, 8, top_idx=t(idx), top_w=t(w), num_experts=5)
    assert got[4] == ref[4]
    for a, b in zip(got[:4], ref[:4]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _compare_gating(got, ref):
    l_t, c_t, d_t, cap_t = got
    l_j, c_j, d_j, cap_j = ref
    assert cap_t == cap_j
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), **TOL)
    np.testing.assert_allclose(float(l_t), float(l_j), rtol=1e-6)


@pytest.mark.parametrize("cf,min_cap,drop", [(1.0, 4, True), (0.5, 2, True), (1.0, 4, False)])
def test_top1gating_without_rng_equals_jax(cf, min_cap, drop):
    logits = np.random.default_rng(11).normal(size=(32, 4)).astype(np.float32) * 2
    used = (np.random.default_rng(12).random(32) > 0.2).astype(np.float32)
    for used_token in (None, used):
        ref = jsm.top1gating(jnp.asarray(logits), cf, min_cap, drop_tokens=drop,
                             used_token=None if used_token is None else jnp.asarray(used_token))
        got = tsm.top1gating(t(logits), cf, min_cap, drop_tokens=drop,
                             used_token=None if used_token is None else t(used_token))
        _compare_gating(got, ref)


@pytest.mark.parametrize("cf,min_cap,drop", [(1.0, 4, True), (0.25, 2, True), (1.0, 4, False)])
def test_top2gating_without_rng_equals_jax(cf, min_cap, drop):
    logits = np.random.default_rng(13).normal(size=(40, 5)).astype(np.float32) * 2
    ref = jsm.top2gating(jnp.asarray(logits), cf, min_cap, drop_tokens=drop)
    got = tsm.top2gating(t(logits), cf, min_cap, drop_tokens=drop)
    _compare_gating(got, ref)


def test_sampled_gating_is_seeded_and_deterministic():
    """Same generator seed -> identical routing; another seed -> another
    routing (Gumbel second expert, RSample, random token priority)."""
    logits = t(np.random.default_rng(14).normal(size=(64, 8)).astype(np.float32))

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        return (tsm.top2gating(logits, 1.0, 4, generator=g)[1],
                tsm.top1gating(logits, 0.5, 4, noisy_gate_policy="RSample", generator=g)[1],
                tsm.top1gating(logits, 0.5, 4, generator=g)[1])

    a, b, c = run(0), run(0), run(1)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not all(torch.equal(x, y) for x, y in zip(a, c))
    # random token priority keeps the capacity: at most C tokens per expert
    kept = (a[2] > 0).any(dim=2).sum(dim=0)
    assert int(kept.max()) <= tsm._capacity(64, 8, 0.5, 4)


def test_gumbel_second_expert_follows_the_softmax_of_the_rest():
    """Gumbel-max sampling of the second expert: over many tokens with the
    same logits, its frequencies match softmax(logits) over the experts
    other than the first (4 standard deviations at n = 20000)."""
    lg = np.asarray([2.0, 1.0, 0.5, 0.0, -0.5, -1.0], np.float32)
    n, chunk = 20000, 2000  # in chunks: combine is [S, E, S] without dropping
    gen = torch.Generator().manual_seed(3)
    counts = np.zeros(6)
    for _ in range(n // chunk):
        _, combine, _, _ = tsm.top2gating(t(np.tile(lg, (chunk, 1))), 1.0, 4, drop_tokens=False,
                                          generator=gen)
        w = combine.sum(dim=2)
        assert bool((w[:, 0] > 0).all())  # the first expert is the argmax
        counts += np.bincount((torch.where(w[:, 1:] > 0)[1] + 1).numpy(), minlength=6)
    freq = counts[1:] / n
    p = np.exp(lg[1:]) / np.exp(lg[1:]).sum()
    assert np.abs(freq - p).max() <= 4 * np.sqrt(p * (1 - p) / n).max(), (freq, p)


def test_jitter_and_gumbel_draw_on_the_generator_device():
    g = torch.Generator().manual_seed(0)
    x = torch.ones(5, 3)
    y = tsm.multiplicative_jitter(x, g)
    assert bool(((y >= 0.99) & (y < 1.01)).all()) and not torch.equal(y, x)
    assert torch.equal(tsm.multiplicative_jitter(x, g, epsilon=0), x)


# ---------------------------------------------------------------------------
# the MoE FFN and layers
# ---------------------------------------------------------------------------

def _ffn_weights(seed, E, M, F, swiglu):
    rng = np.random.default_rng(seed)
    wi = rng.normal(size=(E, M, F)).astype(np.float32) / np.sqrt(M)
    wo = rng.normal(size=(E, F, M)).astype(np.float32) / np.sqrt(F)
    wg = rng.normal(size=(E, M, F)).astype(np.float32) / np.sqrt(M) if swiglu else None
    return wi, wo, wg


@pytest.mark.parametrize("top_k,mlp", [(1, "gelu"), (2, "gelu"), (2, "swiglu")])
def test_grouped_moe_ffn_matches_jax_forward_and_gradients(top_k, mlp):
    rng = np.random.default_rng(20 + top_k)
    S, M, F, E = 32, 16, 24, 4
    x = rng.normal(size=(S, M)).astype(np.float32)
    logits = rng.normal(size=(S, E)).astype(np.float32)
    gate = jsm.top1gating if top_k == 1 else jsm.top2gating
    w_se = np.asarray(gate(jnp.asarray(logits), 1.0, 4)[1].sum(axis=2))
    wi, wo, wg = _ffn_weights(21, E, M, F, mlp == "swiglu")
    dy = rng.normal(size=(S, M)).astype(np.float32)

    def jfn(x_, wi_, wo_, *wg_):
        return jgrouped.grouped_moe_ffn(x_, jnp.asarray(w_se), wi_, wo_, top_k,
                                        wg=wg_[0] if wg_ else None, block_rows=8, interpret=True)

    args = [x, wi, wo] + ([wg] if wg is not None else [])
    y_ref, vjp = jax.vjp(jfn, *(jnp.asarray(a) for a in args))
    grads_ref = vjp(jnp.asarray(dy))
    targs = [t(a).requires_grad_() for a in args]
    y = tgrouped.grouped_moe_ffn(targs[0], t(w_se), targs[1], targs[2], top_k,
                                 wg=targs[3] if wg is not None else None, block_rows=8)
    y.backward(t(dy))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref), **TOL)
    for name, a, r in zip(("x", "wi", "wo", "wg"), targs, grads_ref):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(r), err_msg=name, rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("impl,k", [("einsum", 1), ("einsum", 2), ("grouped", 1), ("grouped", 2)])
def test_moelayer_matches_jax(impl, k):
    S, M, F, E = 24, 16, 32, 4
    jgate = jsm.TopKGate(M, E, k=k)
    jl = jsm.MOELayer(jgate, M, F, num_local_experts=E, moe_impl=impl)
    params = jax.tree.map(np.asarray, jl.init(jax.random.PRNGKey(k)))
    x = np.random.default_rng(30 + k).normal(size=(S, M)).astype(np.float32)
    y_ref, aux_ref = jl(params, jnp.asarray(x), train=False)
    tl = tsm.MOELayer(tsm.TopKGate(M, E, k=k), M, F, num_local_experts=E, moe_impl=impl)
    tparams = tree_to_torch(params)
    y, aux = tl(tparams, t(x), train=False)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(aux), float(aux_ref), rtol=1e-6)
    # the other impl on the same weights: the same function
    other = tsm.MOELayer(tsm.TopKGate(M, E, k=k), M, F, num_local_experts=E,
                         moe_impl="grouped" if impl == "einsum" else "einsum")
    np.testing.assert_allclose(other(tparams, t(x), train=False)[0].numpy(), y.numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("use_residual", [False, True])
def test_moe_layer_matches_jax(use_residual):
    H, E = 16, 4
    jm = jlayer.MoE(H, num_experts=E, k=2, use_residual=use_residual, ffn_dim=24)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(5)))
    x = np.random.default_rng(40).normal(size=(20, H)).astype(np.float32)
    y_ref, aux_ref = jm(params, jnp.asarray(x), train=False)
    tm = tlayer.MoE(H, num_experts=E, k=2, use_residual=use_residual, ffn_dim=24)
    y, aux = tm(tree_to_torch(params), t(x), train=False)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(aux), float(aux_ref), rtol=1e-6)
    drawn = tm.init(torch.Generator().manual_seed(0))
    assert _shapes(drawn) == _shapes(params)


def test_expert_parallelism_is_refused_naming_world_size_one():
    """At world size 1 the expert group has one rank, and ``ep_size`` must
    equal its size; the grouped path does not compose with EP, in the port
    as in the reference (``sharded_moe.py:225-233``)."""
    gate = tsm.TopKGate(16, 4, k=2)
    with pytest.raises(ValueError, match="ep_size 2 must equal the size of the expert group, 1"):
        tsm.MOELayer(gate, 16, 32, num_local_experts=2, ep_size=2)
    with pytest.raises(ValueError, match="ep_size 2 must equal the size of the expert group, 1"):
        tlayer.MoE(16, num_experts=4, ep_size=2, k=2)
    with pytest.raises(NotImplementedError, match="does not compose with expert parallelism"):
        jsm.MOELayer(jsm.TopKGate(16, 4, k=2), 16, 32, num_local_experts=2, ep_axis="data",
                     ep_size=2, moe_impl="grouped")
    with pytest.raises(NotImplementedError, match="does not compose with expert parallelism"):
        tsm.MOELayer(gate, 16, 32, num_local_experts=2, ep_size=2, moe_impl="grouped")
    with pytest.raises(ValueError, match="moe_impl"):
        tsm.MOELayer(gate, 16, 32, num_local_experts=4, moe_impl="banana")


def test_serving_moe_modules_match_each_other_and_jax():
    """``grouped_gemm_moe`` == ``top_k_gated_moe`` on the same weights, and
    both equal the JAX package's modules (swiglu and gelu)."""
    T, H, F, E, K = 12, 16, 32, 4, 2
    rng = np.random.default_rng(11)
    x = rng.normal(size=(T, H)).astype(np.float32)
    gate_w = rng.normal(size=(H, E)).astype(np.float32)
    up = (rng.normal(size=(E, H, F)) * 0.1).astype(np.float32)
    gt = (rng.normal(size=(E, H, F)) * 0.1).astype(np.float32)
    down = (rng.normal(size=(E, F, H)) * 0.1).astype(np.float32)
    for act, g in (("swiglu", gt), ("gelu", None)):
        outs = {}
        for name in ("top_k_gated_moe", "grouped_gemm_moe"):
            jm = JaxMoERegistry.instantiate_config(JaxBundle(name=name, config=JaxMoEConfig(
                n_experts=E, top_k=K, activation=act, dtype=jnp.float32)))
            tm = DSMoERegistry.instantiate_config(ConfigBundle(name=name, config=DSMoEConfig(
                n_experts=E, top_k=K, activation=act, dtype=torch.float32)))
            ref = jm(*(None if a is None else jnp.asarray(a) for a in (x, gate_w, up, g, down)))
            outs[name] = tm(*(None if a is None else t(a) for a in (x, gate_w, up, g, down)))
            np.testing.assert_allclose(outs[name].numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5,
                                       err_msg=f"{name} {act}")
        np.testing.assert_allclose(outs["grouped_gemm_moe"].numpy(),
                                   outs["top_k_gated_moe"].numpy(), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the MoE transformer: loss, gradients, training
# ---------------------------------------------------------------------------

def _cfgs(impl, **over):
    kw = dict(TINY, moe_impl=impl, **over)
    return (jax_mistral_config("tiny", dtype=jnp.float32, attention_impl="reference", **kw),
            mistral_config("tiny", dtype=torch.float32, attention_impl="reference", **kw))


def _grads_numpy(model):
    return params_to_numpy({g: ([{n: p.grad for n, p in layer.items()} for layer in v]
                                if isinstance(v, list) else {n: p.grad for n, p in v.items()})
                            for g, v in model.params().items()})


@pytest.mark.parametrize("impl,loss_chunk", [("einsum", None), ("grouped", None), ("grouped", 8)])
def test_moe_model_loss_and_every_gradient_match_jax(impl, loss_chunk):
    """Loss (cross entropy + 0.01 x the layers' summed aux loss) and the
    gradient of every parameter against ``jax.value_and_grad`` of the JAX
    package's ``loss_fn(cfg, params, batch, None)``."""
    jcfg, tcfg = _cfgs(impl, loss_chunk=loss_chunk)
    npp = jax.tree.map(np.asarray, jt.init_params(jcfg, jax.random.PRNGKey(0)))
    ids = np.random.default_rng(50).integers(0, 256, (2, 24)).astype(np.int32)
    loss_ref, g_ref = jax.value_and_grad(
        lambda p: jt.loss_fn(jcfg, p, {"input_ids": jnp.asarray(ids)}, None))(npp)
    model = TransformerLM(tcfg, params_from_jax(npp, tcfg, device="cpu", dtype=torch.float32,
                                                per_layer=True), trainable=True)
    loss = model.loss({"input_ids": t(ids)})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_ref), rtol=1e-6)
    grads = _grads_numpy(model)
    assert grads["blocks"].keys() == g_ref["blocks"].keys()
    assert {"gate_wg", "moe_wi", "moe_wg", "moe_wo"} <= set(grads["blocks"])
    for group in g_ref:
        for name in g_ref[group]:
            np.testing.assert_allclose(grads[group][name], np.asarray(g_ref[group][name]),
                                       rtol=1e-4, atol=1e-6, err_msg=f"{group}/{name}")


def test_moe_aux_loss_is_summed_over_layers_and_weighted():
    _, tcfg = _cfgs("grouped")
    model = TransformerLM(tcfg, device="cpu", trainable=True, seed=2)
    ids = t(np.random.default_rng(51).integers(0, 256, (2, 16)))
    from deepspeed_tpu_torch.models.transformer import _ce_aux, _ce_loss, forward_with_aux

    logits, aux = forward_with_aux(tcfg, model.params(), ids)
    ce = _ce_loss(logits, _ce_aux({"input_ids": ids}, ids))
    np.testing.assert_allclose(model.loss({"input_ids": ids}).item(),
                               (ce + tcfg.moe_aux_loss_coef * aux).item(), rtol=1e-7)
    assert aux.item() > 0


class _NoRngJax:
    """The JAX model with its gating's rng dropped (deterministic routing)."""

    def __init__(self, cfg):
        self.model = JaxLM(cfg)

    def init(self, rng, example_batch=None):
        return self.model.init(rng, example_batch)

    def loss(self, params, batch, rng=None):
        return jt.loss_fn(self.model.config, params, batch, None)


class _NoGenerator(torch.nn.Module):
    """The port's model with no generator passed to the gating."""

    def __init__(self, model):
        super().__init__()
        self.inner = model

    def loss(self, batch):
        return self.inner.loss(batch)


def _ds_config(mode):
    return {"train_batch_size": 8, "train_micro_batch_size_per_gpu": 2,
            "gradient_accumulation_steps": 4,
            "optimizer": {"type": "AdamW", "params": {"lr": 1e-4, "weight_decay": 0.1}},
            "scheduler": {"type": "WarmupLR", "params": {"warmup_num_steps": 2,
                                                         "warmup_max_lr": 1e-4,
                                                         "warmup_type": "linear"}},
            "gradient_clipping": 1.0, "steps_per_print": 100, "tpu": {"pallas_fused_adam": mode}}


@pytest.mark.parametrize("mode", ["never", "always"])
def test_moe_train_batch_matches_jax_engine(mode):
    """Three ``train_batch`` steps of a tiny MoE Mistral (grouped path) in
    both engines, from the same initial parameters, gating rng dropped on
    both sides: losses rtol 2e-5, parameters rtol 2e-4 / atol 2e-6."""
    jcfg, tcfg = _cfgs("grouped")
    je, _, _, _ = deepspeed_tpu.initialize(model=_NoRngJax(jcfg), config=_ds_config(mode),
                                           mesh=single_device_mesh())
    npp = jax.tree.map(np.asarray, je.state["params"])
    inner = TransformerLM(tcfg, params_from_jax(npp, tcfg, device="cpu", dtype=torch.float32,
                                                per_layer=True), trainable=True)
    te, _, _, _ = deepspeed_tpu_torch.initialize(model=_NoGenerator(inner), config=_ds_config(mode))
    assert (te._pallas_adam is not None) == (mode == "always")
    assert not te._loss_takes_generator
    for step in range(3):
        b = {"input_ids": np.random.default_rng(60 + step).integers(0, 256, (8, 24)).astype(np.int32)}
        np.testing.assert_allclose(float(te.train_batch(b)), float(je.train_batch(b)), rtol=2e-5)
    ours = params_to_numpy(inner.params())
    ref = jax.tree.map(np.asarray, je.state["params"])
    for group in ref:
        for name in ref[group]:
            np.testing.assert_allclose(ours[group][name], ref[group][name], rtol=2e-4, atol=2e-6,
                                       err_msg=f"{group}/{name}")


def test_engine_feeds_its_seeded_generator_to_the_gating():
    """A MoE TransformerLM's loss takes the engine's generators, one a batch
    row on the model's device, seeded from (the engine's seed, the step,
    the row of the step's global batch): two engines with one seed train
    identically with the sampled gating (Gumbel second expert, jitter), and
    each row, step and seed draws its own noise."""
    _, tcfg = _cfgs("grouped", moe_noisy_gate_policy="Jitter")
    losses = []
    for _ in range(2):
        model = TransformerLM(tcfg, device="cpu", trainable=True, seed=4)
        e, _, _, _ = deepspeed_tpu_torch.initialize(model=model, config=_ds_config("always"))
        assert e._loss_takes_generator
        gens = e.row_generators(1, 2)
        assert [g.device for g in gens] == [e.device] * 2
        draws = [torch.rand(4, generator=g) for g in gens + e.row_generators(3, 1)]
        assert not torch.equal(draws[0], draws[1]) and torch.equal(draws[1], draws[2])
        b = {"input_ids": np.random.default_rng(70).integers(0, 256, (8, 16)).astype(np.int32)}
        losses.append([float(e.train_batch(b)) for _ in range(2)])
        moved = torch.rand(4, generator=e.row_generators(1, 2)[0])  # step 2 now
        assert not torch.equal(moved, draws[0])
        e.seed += 1
        assert not torch.equal(torch.rand(4, generator=e.row_generators(1, 2)[0]), moved)
    assert losses[0] == losses[1]
    assert all(np.isfinite(losses[0]))

"""PyTorch port, activation checkpointing: ``checkpointing`` and the model's
``remat``, against the plain forward and the JAX package.

The analogs of ``tests/test_activation_checkpointing.py`` (a checkpointed
function's value and gradients equal the plain ones under every policy; the
policy names; ``configure`` from a ds_config; the decorator form with a
dropout drawn from a tracker ``fork`` replaying; the tracker), plus what the
dispatcher-level policies keep (the matrix products a backward runs), a
tiny ``TransformerLM`` with ``remat`` under each policy bit-equal to
``remat`` off (dense, block-sparse, parallel residual, chunked CE; every
policy through ``train_batch`` and the eager API; both sampled MoE gatings
through ``train_batch``, whose generators must replay),
and ``train_batch`` with ``remat`` against the JAX engine with ``remat`` and
the same policy, the same weights through ``models/convert.py``, at the
tolerances of ``tests/test_torch_engine.py``. Inputs from numpy seeds; fp32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import TransformerLM as JaxLM
from deepspeed_tpu.models import mistral_config as jax_mistral_config
from deepspeed_tpu.parallel.mesh import single_device_mesh
from deepspeed_tpu_torch import checkpointing as ckpt
from deepspeed_tpu_torch.models import (TransformerLM, llama2_config, mistral_config,
                                        params_from_jax, params_to_numpy)

TINY = dict(num_layers=2, hidden_size=64, num_heads=4, num_kv_heads=2, intermediate_size=128,
            vocab_size=256, max_seq_len=256, sliding_window=16)
POLICIES = ["nothing_saveable", "dots_saveable", "checkpoint_dots",
            "dots_with_no_batch_dims_saveable", "checkpoint_dots_with_no_batch_dims",
            "everything_saveable", "save_only_these_names(attn_out)"]
# the sampled gatings of tests/test_torch_zero.py: (top-k, noisy gate policy, moe_impl)
SAMPLED = {"jitter_top1": (1, "Jitter", "einsum"), "gumbel_top2": (2, None, "grouped")}


@pytest.fixture(autouse=True)
def _reset_ckpt():
    ckpt.reset()
    ckpt.get_rng_tracker().reset()
    yield
    ckpt.reset()
    ckpt.get_rng_tracker().reset()


def _mlp_params(seed, d=16):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=s).astype(np.float32)).requires_grad_()
            for s in ((d, 4 * d), (4 * d, d))]


def _mlp(w1, w2, x):
    h = torch.tanh(x @ w1)
    h = ckpt.checkpoint_name("mid", h)
    pair = torch.einsum("bsf,btf->bst", h, h)  # a batched product (bmm)
    return ((h @ w2)**2).sum() + pair.sum()


def _x(seed, shape=(2, 8, 16)):
    return torch.from_numpy(np.random.default_rng(seed).normal(size=shape).astype(np.float32))


@pytest.mark.parametrize("policy", POLICIES[:-1] + ["save_only_these_names(mid)"])
def test_checkpoint_matches_baseline(policy):
    w1, w2 = _mlp_params(0)
    x = _x(1)
    base = _mlp(w1, w2, x)
    g_base = torch.autograd.grad(base, [w1, w2])
    ck = ckpt.checkpoint(lambda x_: _mlp(w1, w2, x_), x, policy=policy)
    g_ck = torch.autograd.grad(ck, [w1, w2])
    assert torch.equal(ck, base)
    assert all(torch.equal(a, b) for a, b in zip(g_ck, g_base))


class _CountOps(TorchDispatchMode):

    def __init__(self):
        super().__init__()
        self.n = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n[func] = self.n.get(func, 0) + 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("policy,mm,bmm", [
    ("nothing_saveable", 2, 1), ("dots_saveable", 0, 0),
    ("dots_with_no_batch_dims_saveable", 0, 1), ("save_only_these_names(mid)", 2, 1)])
def test_policies_keep_what_they_name(policy, mm, bmm):
    """The backward's recompute runs again every product the policy does
    not keep: the MLP's two ``mm`` and the pairwise ``bmm``, beside the
    backward's own three ``mm`` and two ``bmm``. A names policy keeps the
    tagged value, not the products upstream of it."""
    w1, w2 = _mlp_params(0)
    out = ckpt.checkpoint(lambda x_: _mlp(w1, w2, x_), _x(1), policy=policy)
    with _CountOps() as c:
        torch.autograd.grad(out, [w1, w2])
    aten = torch.ops.aten
    assert c.n.get(aten.mm.default, 0) == 3 + mm
    assert c.n.get(aten.bmm.default, 0) == 2 + bmm


def test_policy_names_resolve_and_an_unknown_name_raises():
    for name in POLICIES:
        assert ckpt.resolve_policy(name).name == name
    assert ckpt.resolve_policy(None).name == "nothing_saveable"
    assert ckpt.resolve_policy("save_only_these_names(a, b)").names == {"a", "b"}
    assert not ckpt.resolve_policy("everything_saveable").checkpoint
    with pytest.raises(ValueError, match="bogus_policy.*nothing_saveable"):
        ckpt.resolve_policy("bogus_policy")


def test_configure_from_ds_config_and_explicit_kwargs_win():
    config = {"train_batch_size": 8,
              "activation_checkpointing": {"partition_activations": True,
                                           "remat_policy": "dots_saveable", "profile": True,
                                           "number_checkpoints": 4}}
    assert not ckpt.is_configured()
    ckpt.configure(deepspeed_config=config)
    assert ckpt.is_configured()
    st = ckpt._state
    assert st.partition_activations and st.profile and st.num_checkpoints == 4
    assert st.policy.name == "dots_saveable" and not st.cpu_checkpointing
    ckpt.configure(deepspeed_config=config, remat_policy="nothing_saveable", profile=False,
                   checkpoint_in_cpu=True)
    assert st.policy.name == "nothing_saveable" and not st.profile and st.cpu_checkpointing
    ckpt.reset()
    assert not ckpt.is_configured() and st.policy is None and not st.cpu_checkpointing
    cfg = deepspeed_tpu_torch.DeepSpeedConfig(config)
    assert cfg.activation_checkpointing_config.remat_policy == "dots_saveable"
    with pytest.raises(ValueError, match="not_a_policy"):
        deepspeed_tpu_torch.DeepSpeedConfig(
            {"train_batch_size": 2, "activation_checkpointing": {"remat_policy": "not_a_policy"}})
    with pytest.raises(deepspeed_tpu_torch.DeepSpeedConfigError, match="offload"):
        deepspeed_tpu_torch.DeepSpeedConfig(
            {"train_batch_size": 2, "activation_checkpointing": {"offload": True}})


def test_configured_cpu_checkpointing_recomputes_everything():
    """``cpu_checkpointing`` keeps nothing of a region on the device (its
    inputs go to pinned host memory: on the card; a CPU input is on the
    host already) and gives the plain values."""
    ckpt.configure(checkpoint_in_cpu=True, remat_policy="dots_saveable")
    w1, w2 = _mlp_params(2)
    x = _x(3)
    base = _mlp(w1, w2, x)
    g_base = torch.autograd.grad(base, [w1, w2])
    out = ckpt.checkpoint(lambda x_: _mlp(w1, w2, x_), x)
    with _CountOps() as c:
        g = torch.autograd.grad(out, [w1, w2])
    assert c.n[torch.ops.aten.mm.default] == 5  # both products recomputed
    assert torch.equal(out, base) and all(torch.equal(a, b) for a, b in zip(g, g_base))


def test_checkpoint_name_is_the_value_outside_a_names_region():
    x = _x(4)
    assert ckpt.checkpoint_name("attn_out", x) is x
    seen = []

    def f(x_):
        seen.append(ckpt.checkpoint_name("attn_out", x_) is x_)
        return x_.sum()

    ckpt.checkpoint(f, x.requires_grad_(), policy="dots_saveable")
    ckpt.checkpoint(f, x, policy="save_only_these_names(attn_out)")
    assert seen == [True, False]


def _dropout_block(w1):
    tracker = ckpt.get_rng_tracker()

    def block(x):
        h = x @ w1
        with tracker.fork(device="cpu") as g:
            keep = torch.rand(h.shape, generator=g) < 0.5
        return (torch.where(keep, h, torch.zeros_like(h))**2).sum()

    return block


def test_decorator_form_and_dropout_replay():
    """A dropout drawn from a tracker fork inside a checkpointed function
    draws the same mask in the recompute (the tracker's streams replay), and
    the stream ends where one plain forward leaves it."""
    w1, _ = _mlp_params(5)
    x = _x(6)
    tracker = ckpt.get_rng_tracker()
    ckpt.model_parallel_reconfigure_tp_seed(1234)
    start = tracker.get_states()
    block = _dropout_block(w1)
    v1 = block(x)
    (g1, ) = torch.autograd.grad(v1, [w1])
    after_plain = tracker.get_states()
    tracker.set_states(start)
    remat_block = ckpt.checkpoint(block)
    v2 = remat_block(x)
    (g2, ) = torch.autograd.grad(v2, [w1])
    assert torch.equal(v1, v2) and torch.equal(g1, g2)
    assert all(torch.equal(after_plain[k], v) for k, v in tracker.get_states().items())


def test_dropout_replay_is_what_keeps_the_gradient(monkeypatch):
    """Without the replay the recompute draws another mask: the forward's
    value is the plain one, its gradient is not."""
    w1, _ = _mlp_params(5)
    x = _x(6)
    tracker = ckpt.get_rng_tracker()
    ckpt.model_parallel_reconfigure_tp_seed(1234)
    start = tracker.get_states()
    block = _dropout_block(w1)
    (g1, ) = torch.autograd.grad(block(x), [w1])
    tracker.set_states(start)
    monkeypatch.setattr(ckpt, "_replayed", lambda args: [])
    v2 = ckpt.checkpoint(block, x)
    (g2, ) = torch.autograd.grad(v2, [w1])
    assert not torch.equal(g1, g2)


def test_rng_tracker():
    tr = ckpt.get_rng_tracker()
    name = ckpt.model_parallel_rng_tracker_name()
    tr.add(name, 1234)
    with tr.fork(device="cpu") as g1:
        a = torch.rand(8, generator=g1)
    with tr.fork(device="cpu") as g2:
        b = torch.rand(8, generator=g2)
    assert not torch.equal(a, b)  # the stream advances
    with pytest.raises(Exception, match="already exists"):
        tr.add(name, 99)
    with pytest.raises(Exception, match="not added"):
        tr.split("other", device="cpu")
    states = tr.get_states()
    c = torch.rand(8, generator=tr.split(device="cpu"))
    tr.set_states(states)
    assert torch.equal(torch.rand(8, generator=tr.split(device="cpu")), c)
    assert ckpt.get_cuda_rng_tracker() is tr
    ckpt.model_parallel_reconfigure_tp_seed(1234)
    with tr.fork(device="cpu") as g3:
        assert torch.equal(torch.rand(8, generator=g3), a)


# ---------------------------------------------------------------------------
# the model's remat
# ---------------------------------------------------------------------------

def _loss_and_grads(cfg, ids, seed=1, generator=None):
    model = TransformerLM(cfg, device="cpu", trainable=True, seed=seed)
    loss = model.loss({"input_ids": ids}, generator=generator)
    return loss, torch.autograd.grad(loss, list(model.parameters()))


def _ids(seed, shape=(2, 24)):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, 256, shape))


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_is_bit_equal_to_no_remat(policy):
    base = mistral_config("tiny", dtype=torch.float32, attention_impl="reference", **TINY)
    remat = mistral_config("tiny", dtype=torch.float32, attention_impl="reference", remat=True,
                           remat_policy=policy, **TINY)
    ids = _ids(0)
    l0, g0 = _loss_and_grads(base, ids)
    l1, g1 = _loss_and_grads(remat, ids)
    assert torch.equal(l0, l1) and all(torch.equal(a, b) for a, b in zip(g0, g1))


SPARSE_SA = {"mode": "fixed", "block": 16, "different_layout_per_head": True,
             "num_local_blocks": 2, "num_global_blocks": 1, "horizontal_global_attention": False,
             "num_different_global_patterns": 2, "attention": "unidirectional"}
COMPOSED = {
    "sparse_attention": lambda **kw: llama2_config(
        "tiny", dtype=torch.float32, num_layers=2, hidden_size=64, num_heads=4, num_kv_heads=4,
        intermediate_size=128, vocab_size=256, max_seq_len=64, sparse_attention=SPARSE_SA, **kw),
    "parallel_residual": lambda **kw: mistral_config(
        "tiny", dtype=torch.float32, attention_impl="reference", parallel_residual=True,
        shared_ln=True, **TINY, **kw),
    "loss_chunk": lambda **kw: mistral_config(
        "tiny", dtype=torch.float32, attention_impl="reference", loss_chunk=8, **TINY, **kw),
}


@pytest.mark.parametrize("name", list(COMPOSED))
def test_remat_composes_with_sparse_attention_parallel_residual_and_loss_chunk(name):
    ids = _ids(1, (2, 64 if name == "sparse_attention" else 24))
    l0, g0 = _loss_and_grads(COMPOSED[name](), ids)
    l1, g1 = _loss_and_grads(COMPOSED[name](remat=True, remat_policy="dots_saveable"), ids)
    assert torch.equal(l0, l1) and all(torch.equal(a, b) for a, b in zip(g0, g1))


def test_an_unknown_remat_policy_raises_naming_it():
    cfg = mistral_config("tiny", dtype=torch.float32, remat=True, remat_policy="offload_all",
                         **TINY)
    with pytest.raises(ValueError, match="offload_all"):
        TransformerLM(cfg, device="cpu", trainable=True)


def _ds_config(**over):
    cfg = {"train_batch_size": 4, "train_micro_batch_size_per_gpu": 2,
           "gradient_accumulation_steps": 2,
           "optimizer": {"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.1}},
           "gradient_clipping": 1.0, "steps_per_print": 100,
           "tpu": {"pallas_fused_adam": "always"}}
    cfg.update(over)
    return cfg


def _train(cfg, steps=2, seed=3):
    model = TransformerLM(cfg, device="cpu", trainable=True, seed=seed)
    engine, _, _, _ = deepspeed_tpu_torch.initialize(model=model, config=_ds_config())
    losses = [float(engine.train_batch({"input_ids": _ids(10 + s, (4, 24)).int().numpy()}))
              for s in range(steps)]
    return losses, [p.detach().clone() for p in model.parameters()]


def _train_eager(cfg, steps=2, seed=3):
    """``_train`` through ``forward`` / ``backward`` / ``step``."""
    model = TransformerLM(cfg, device="cpu", trainable=True, seed=seed)
    engine, _, _, _ = deepspeed_tpu_torch.initialize(model=model, config=_ds_config())
    losses = []
    for s in range(steps):
        ids = _ids(10 + s, (4, 24)).int().numpy()
        for i in range(2):
            engine.backward(engine({"input_ids": ids[2 * i:2 * i + 2]}))
            engine.step()
        losses.append(float(engine._step_metrics["loss"]))
    return losses, [p.detach().clone() for p in model.parameters()]


@pytest.mark.parametrize("policy", POLICIES)
def test_every_policy_trains_through_train_batch_and_the_eager_api(policy):
    """Two steps under ``policy`` through ``train_batch`` and through the
    eager API, each bit-equal to ``train_batch`` without remat."""
    kw = dict(dtype=torch.float32, attention_impl="reference", **TINY)
    base = _train(mistral_config("tiny", **kw))
    remat = mistral_config("tiny", remat=True, remat_policy=policy, **kw)
    for losses, params in (_train(remat), _train_eager(remat)):
        assert losses == base[0]
        assert all(torch.equal(a, b) for a, b in zip(params, base[1]))


@pytest.mark.parametrize("name", list(SAMPLED))
def test_sampled_moe_gating_trains_bit_equal_under_remat(name):
    """The engine hands the gating one generator a row, which every layer
    advances: the checkpoint replays them, so the recompute routes every
    token as the forward did."""
    k, policy, impl = SAMPLED[name]
    moe = dict(moe_num_experts=4, moe_top_k=k, moe_noisy_gate_policy=policy, moe_impl=impl)
    runs = [_train(mistral_config("tiny", dtype=torch.float32, attention_impl="reference",
                                  remat=remat, **TINY, **moe)) for remat in (False, True)]
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


def test_sampled_moe_routing_needs_the_replay(monkeypatch):
    """Without the generators' replay the recompute routes the second
    expert by other noise: the same loss, other gradients."""
    moe = dict(moe_num_experts=4, moe_top_k=2, moe_impl="grouped")
    ids = _ids(2)
    gens = lambda: [torch.Generator().manual_seed(20 + b) for b in range(2)]  # noqa: E731
    kw = dict(dtype=torch.float32, attention_impl="reference", **TINY, **moe)
    l0, g0 = _loss_and_grads(mistral_config("tiny", **kw), ids, generator=gens())
    monkeypatch.setattr(ckpt, "_replayed", lambda args: [])
    l1, g1 = _loss_and_grads(mistral_config("tiny", remat=True, **kw), ids, generator=gens())
    assert torch.equal(l0, l1)
    assert not all(torch.equal(a, b) for a, b in zip(g0, g1))


@pytest.mark.parametrize("policy", ["nothing_saveable", "dots_saveable",
                                    "save_only_these_names(attn_out)"])
def test_remat_train_batch_matches_the_jax_engine_with_remat(policy):
    """Two ``train_batch`` steps of the JAX engine with ``remat=True`` and
    ``policy`` and of the port's, from the JAX engine's initial weights:
    losses at rtol 2e-5, parameters at rtol 2e-4 / atol 2e-6."""
    jcfg = jax_mistral_config("tiny", dtype=jnp.float32, attention_impl="reference", remat=True,
                              remat_policy=policy, **TINY)
    je, _, _, _ = deepspeed_tpu.initialize(model=JaxLM(jcfg), config=_ds_config(),
                                           mesh=single_device_mesh())
    npp = jax.tree.map(np.asarray, je.state["params"])
    tcfg = mistral_config("tiny", dtype=torch.float32, attention_impl="reference", remat=True,
                          remat_policy=policy, **TINY)
    model = TransformerLM(tcfg, params_from_jax(npp, tcfg, device="cpu", dtype=torch.float32,
                                                per_layer=True), trainable=True)
    te, _, _, _ = deepspeed_tpu_torch.initialize(model=model, config=_ds_config())
    for step in range(2):
        b = {"input_ids": _ids(30 + step, (4, 24)).int().numpy()}
        np.testing.assert_allclose(float(te.train_batch(b)), float(je.train_batch(b)), rtol=2e-5)
    ours = params_to_numpy(te.module.params())
    ref = jax.tree.map(np.asarray, je.state["params"])
    for group in ref:
        for name in ref[group]:
            np.testing.assert_allclose(ours[group][name], ref[group][name], rtol=2e-4, atol=2e-6,
                                       err_msg=f"{group}/{name}")

"""PyTorch port, training slice: ``initialize`` -> ``train_batch`` against
the JAX engine.

Both engines start from the JAX engine's initial parameters (moved with
``params_from_jax(per_layer=True)``) on a tiny Mistral (2 layers, hidden 64,
GQA 4/2, window 16, fp32, reference attention), and take the same batches
(numpy, from a seed). Losses agree at rtol 2e-5 and final parameters at
rtol 2e-4 / atol 2e-6 (the tolerances of ``tests/test_fused_adam.py``:
fp32 sums in another order), with the optax-equivalent optimizer
(``pallas_fused_adam: "never"``) and with the fused Adam path
(``"always"``: the kernel's plain version on the CPU, the Pallas kernel in
interpret mode on the JAX side). Also: the chunked CE, ``labels`` /
``loss_mask`` batches, the fp16 loss-scale state machine with an injected
overflow, a mid-run resume from the JAX engine's optimizer state, the
config's refusals, and the eager ``forward`` / ``backward`` / ``step`` API
(bit-equal to ``train_batch``; against the JAX engine's eager API at rtol
2e-4 / atol 2e-5; ``eval()``, the accumulation boundary, and the hybrid
engine's view after eager steps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import TransformerLM as JaxLM
from deepspeed_tpu.models import llama2_config as jax_llama2_config
from deepspeed_tpu.models import mistral_config as jax_mistral_config
from deepspeed_tpu.parallel.mesh import single_device_mesh
from deepspeed_tpu_torch.models import (TransformerLM, llama2_config, mistral_config,
                                        params_from_jax, params_to_numpy)
from deepspeed_tpu_torch.models.convert import optimizer_state_from_numpy, tree_leaves

TINY = dict(num_layers=2, hidden_size=64, num_heads=4, num_kv_heads=2, intermediate_size=128,
            vocab_size=256, max_seq_len=256, sliding_window=16)


def _ds_config(mode, **over):
    cfg = {"train_batch_size": 8, "train_micro_batch_size_per_gpu": 2,
           "gradient_accumulation_steps": 4,
           "optimizer": {"type": "AdamW", "params": {"lr": 1e-4, "weight_decay": 0.1}},
           "scheduler": {"type": "WarmupLR", "params": {"warmup_num_steps": 2,
                                                        "warmup_max_lr": 1e-4,
                                                        "warmup_type": "linear"}},
           "gradient_clipping": 1.0, "steps_per_print": 100,
           "tpu": {"pallas_fused_adam": mode}}
    cfg.update(over)
    return cfg


def _engines(mode, loss_chunk=None, **over):
    jcfg = jax_mistral_config("tiny", dtype=jnp.float32, attention_impl="reference",
                              loss_chunk=loss_chunk, **TINY)
    je, _, _, _ = deepspeed_tpu.initialize(model=JaxLM(jcfg), config=_ds_config(mode, **over),
                                           mesh=single_device_mesh())
    npp = jax.tree.map(np.asarray, je.state["params"])
    tcfg = mistral_config("tiny", dtype=torch.float32, attention_impl="reference",
                          loss_chunk=loss_chunk, **TINY)
    model = TransformerLM(tcfg, params_from_jax(npp, tcfg, device="cpu", dtype=torch.float32,
                                                per_layer=True), trainable=True)
    te, _, _, _ = deepspeed_tpu_torch.initialize(model=model, config=_ds_config(mode, **over))
    return je, te


def _batch(seed, extra=False, seq=24):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 256, size=(8, seq)).astype(np.int32)
    if not extra:
        return {"input_ids": ids}
    return {"input_ids": ids, "labels": rng.integers(0, 256, size=(8, seq)).astype(np.int32),
            "loss_mask": (rng.random((8, seq)) > 0.3).astype(np.float32)}


def _assert_params_close(je, te):
    ours = params_to_numpy(te.module.params())
    ref = jax.tree.map(np.asarray, je.state["params"])
    for group in ref:
        for name in ref[group]:
            np.testing.assert_allclose(ours[group][name], ref[group][name], rtol=2e-4, atol=2e-6,
                                       err_msg=f"{group}/{name}")


@pytest.mark.parametrize("mode", ["never", "always"])
def test_train_batch_matches_jax_engine(mode):
    je, te = _engines(mode)
    assert (te._pallas_adam is not None) == (mode == "always")
    assert (je._pallas_adam is not None) == (mode == "always")
    for step in range(3):
        b = _batch(step)
        lj = float(je.train_batch(b))
        lt = float(te.train_batch(b))
        np.testing.assert_allclose(lt, lj, rtol=2e-5)
    _assert_params_close(je, te)
    assert te.global_steps == 3 and int(te.state["step"]) == int(je.state["step"]) == 3
    np.testing.assert_allclose(te.get_lr(), je.get_lr(), rtol=1e-6)


@pytest.mark.parametrize("loss_chunk,extra", [(8, False), (None, True), (8, True)])
def test_chunked_ce_and_labels_mask_match_jax_engine(loss_chunk, extra):
    je, te = _engines("never", loss_chunk=loss_chunk)
    for step in range(2):
        b = _batch(10 + step, extra=extra)
        np.testing.assert_allclose(float(te.train_batch(b)), float(je.train_batch(b)), rtol=2e-5)
    _assert_params_close(je, te)


def test_chunked_ce_equals_full_ce():
    tcfg = mistral_config("tiny", dtype=torch.float32, attention_impl="reference", **TINY)
    model = TransformerLM(tcfg, device="cpu", trainable=True)
    b = {k: torch.from_numpy(v) for k, v in _batch(3, extra=True, seq=21).items()}
    for extra in (False, True):
        batch = b if extra else {"input_ids": b["input_ids"]}
        full = model.loss(batch)
        g_full = torch.autograd.grad(full, list(model.parameters()))
        tcfg.loss_chunk = 8
        chunked = model.loss(batch)
        g_chunk = torch.autograd.grad(chunked, list(model.parameters()))
        tcfg.loss_chunk = None
        np.testing.assert_allclose(chunked.item(), full.item(), rtol=1e-6)
        for a, c in zip(g_chunk, g_full):
            np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=1e-5, atol=1e-7)


def test_resume_from_jax_optimizer_state():
    """Two JAX steps, then both engines continue from the same mid-run
    params and fused-Adam state (numpy carrier both ways)."""
    je, te = _engines("always")
    for step in range(2):
        je.train_batch(_batch(20 + step))
    npp = jax.tree.map(np.asarray, je.state["params"])
    cfg = te.module.config
    with torch.no_grad():
        for dst, src in zip(te._params, tree_leaves(
                params_from_jax(npp, cfg, device="cpu", dtype=torch.float32, per_layer=True))):
            dst.copy_(src)
    opt = je.state["opt_state"]
    optimizer_state_from_numpy(te, {"step": np.asarray(opt.step),
                                    "mu": jax.tree.map(np.asarray, opt.mu),
                                    "nu": jax.tree.map(np.asarray, opt.nu)})
    te.state["step"].fill_(int(je.state["step"]))
    b = _batch(22)
    np.testing.assert_allclose(float(te.train_batch(b)), float(je.train_batch(b)), rtol=2e-5)
    _assert_params_close(je, te)


def _quadratic_jax(params, batch):
    return jnp.mean((batch["x"] @ params["w"]) ** 2)


def _quadratic_torch(params, batch):
    return torch.mean((batch["x"] @ params["w"]) ** 2)


def test_fp16_overflow_skips_step_and_halves_scale():
    """Dynamic loss scale: an inf in one batch makes every gradient
    non-finite; the step is skipped (params and step unchanged), the scale
    halves, and good steps double it after the window, as in the JAX
    engine."""
    cfg = {"train_batch_size": 4, "train_micro_batch_size_per_gpu": 2,
           "gradient_accumulation_steps": 2,
           "optimizer": {"type": "Adam", "params": {"lr": 1e-2}},
           "fp16": {"enabled": True, "initial_scale_power": 4, "loss_scale_window": 2},
           "steps_per_print": 100}
    w0 = np.random.default_rng(0).normal(size=(3, 2)).astype(np.float32)
    je, _, _, _ = deepspeed_tpu.initialize(model=_quadratic_jax,
                                           model_parameters={"w": jnp.asarray(w0)},
                                           config=cfg, mesh=single_device_mesh())
    te, _, _, _ = deepspeed_tpu_torch.initialize(model=_quadratic_torch,
                                                 model_parameters={"w": torch.from_numpy(w0.copy())},
                                                 config=cfg)
    rng = np.random.default_rng(1)
    scales, steps = [], []
    for i in range(6):
        x = rng.normal(size=(4, 3)).astype(np.float32)
        if i in (1, 4):
            x[0, 0] = np.inf
        lj = je.train_batch({"x": x})
        lt = te.train_batch({"x": x})
        if np.isfinite(float(lj)):
            np.testing.assert_allclose(float(lt), float(lj), rtol=2e-5)
        scales.append((te.loss_scale, float(je.state["loss_scale"])))
        steps.append((int(te.state["step"]), int(je.state["step"])))
    assert [a for a, _ in scales] == [b for _, b in scales]
    assert [a for a, _ in steps] == [b for _, b in steps]
    assert scales[1][0] == 8.0 and steps[1][0] == 1  # the overflow halved 16 and skipped
    assert te.skipped_steps == je.skipped_steps == 2
    np.testing.assert_allclose(te.module.params["w"].detach().numpy(),
                               np.asarray(je.state["params"]["w"]), rtol=2e-4, atol=2e-6)


@pytest.mark.parametrize("key,value", [
    ("curriculum_learning", {"enabled": True}),
    ("pipeline", {"stages": 2}),
    ("progressive_layer_drop", {"enabled": True}),
    ("zero_optimization", {"stage": 2, "offload_optimizer": {"device": "cpu"}}),
    ("zero_optimization", {"stage": 3, "zero_hpz_partition_size": 2}),
    ("tpu", {"donate_buffers": True}),
    ("fp16", {"enabled": True, "auto_cast": True}),
])
def test_unported_config_keys_raise_and_name_the_key(key, value):
    name = next(iter(value)) if key in ("zero_optimization", "tpu", "fp16") else key
    if key == "zero_optimization":
        name = [k for k in value if k != "stage"][0]
    with pytest.raises((NotImplementedError, deepspeed_tpu_torch.DeepSpeedConfigError),
                       match=name if key != "fp16" else "auto_cast"):
        deepspeed_tpu_torch.DeepSpeedConfig({"train_batch_size": 2, key: value})


def test_unported_optimizers_and_model_fields_raise():
    tcfg = mistral_config("tiny", dtype=torch.float32, **TINY)
    model = TransformerLM(tcfg, device="cpu", trainable=True)
    for name in ("Lamb", "Lion", "OneBitAdam"):
        with pytest.raises(NotImplementedError, match=name.lower()):
            deepspeed_tpu_torch.initialize(model=model, config={
                "train_batch_size": 2, "optimizer": {"type": name, "params": {}}})
    for field, value in (("sequence_parallel", True), ("dropout", 0.1)):
        with pytest.raises(NotImplementedError, match=field):
            TransformerLM(mistral_config("tiny", dtype=torch.float32, **dict(TINY, **{field: value})),
                          device="cpu", trainable=True)


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_zero_stages_at_world_size_one_train_alike(stage):
    """Every stage partitions over one rank: the same trajectory as stage 0."""
    tcfg = mistral_config("tiny", dtype=torch.float32, attention_impl="reference", **TINY)
    losses = []
    for st in (0, stage):
        model = TransformerLM(tcfg, device="cpu", trainable=True, seed=5)
        e, _, _, _ = deepspeed_tpu_torch.initialize(
            model=model, config=_ds_config("never", zero_optimization={"stage": st}))
        losses.append([float(e.train_batch(_batch(30 + i))) for i in range(2)])
    assert losses[0] == losses[1]
    assert e.zero_optimization_stage() == stage


def test_dataloader_and_data_iter():
    """``training_data`` builds a loader of microbatches; ``train_batch
    (data_iter=...)`` takes gas of them, the same as one stacked batch."""
    tcfg = mistral_config("tiny", dtype=torch.float32, attention_impl="reference", **TINY)
    data = [{"input_ids": np.random.default_rng(i).integers(0, 256, 16).astype(np.int32)}
            for i in range(16)]
    m1 = TransformerLM(tcfg, device="cpu", trainable=True, seed=1)
    e1, _, loader, _ = deepspeed_tpu_torch.initialize(model=m1, config=_ds_config("never"),
                                                      training_data=data)
    assert len(loader) == 8
    mbs = list(iter(loader))[:4]
    l1 = float(e1.train_batch(data_iter=iter(mbs)))
    m2 = TransformerLM(tcfg, device="cpu", trainable=True, seed=1)
    e2, _, _, _ = deepspeed_tpu_torch.initialize(model=m2, config=_ds_config("never"))
    l2 = float(e2.train_batch({"input_ids": np.concatenate([mb["input_ids"] for mb in mbs])}))
    assert l1 == l2


# the slice's ds_config shape at a tiny size: a unidirectional 'fixed' layout
# with per-head global patterns, on a tiny MHA Llama (block-sparse attention
# needs num_kv_heads == num_heads)
SPARSE_TINY = dict(num_layers=2, hidden_size=64, num_heads=4, num_kv_heads=4,
                   intermediate_size=128, vocab_size=256, max_seq_len=64)
SPARSE_SA = {"mode": "fixed", "block": 16, "different_layout_per_head": True,
             "num_local_blocks": 2, "num_global_blocks": 1, "horizontal_global_attention": False,
             "num_different_global_patterns": 2, "attention": "unidirectional"}


@pytest.mark.parametrize("mode", ["never", "always"])
def test_sparse_train_batch_matches_jax_engine(mode):
    """Three block-sparse ``train_batch`` steps (seq 64: 4 block rows) against
    the JAX engine, with the dense test's tolerances; the model takes the
    layout through ``TransformerConfig.sparse_attention``, the engine hands
    the ds_config's block back from ``sparse_attention_config()``."""
    over = dict(sparse_attention=SPARSE_SA, sparse_gradients=True)
    jcfg = jax_llama2_config("tiny", dtype=jnp.float32, attention_impl="reference",
                             sparse_attention=SPARSE_SA, **SPARSE_TINY)
    je, _, _, _ = deepspeed_tpu.initialize(model=JaxLM(jcfg), config=_ds_config(mode, **over),
                                           mesh=single_device_mesh())
    npp = jax.tree.map(np.asarray, je.state["params"])
    tcfg = llama2_config("tiny", dtype=torch.float32, sparse_attention=SPARSE_SA, **SPARSE_TINY)
    model = TransformerLM(tcfg, params_from_jax(npp, tcfg, device="cpu", dtype=torch.float32,
                                                per_layer=True), trainable=True)
    te, _, _, _ = deepspeed_tpu_torch.initialize(model=model, config=_ds_config(mode, **over))
    assert te.sparse_attention_config() == je.sparse_attention_config() == SPARSE_SA
    assert te.config.sparse_gradients_enabled and je.config.sparse_gradients_enabled
    for step in range(3):
        b = _batch(40 + step, seq=64)
        np.testing.assert_allclose(float(te.train_batch(b)), float(je.train_batch(b)), rtol=2e-5)
    _assert_params_close(je, te)


def test_sparse_attention_config_round_trips_and_is_raw():
    """The block is kept as given (validated where the model builds its
    layout), ``sparse_gradients`` is accepted, and absent both are off."""
    sa = {"mode": "bigbird", "block": 32, "num_random_blocks": 2, "seed": 5}
    cfg = deepspeed_tpu_torch.DeepSpeedConfig({"train_batch_size": 2, "sparse_attention": sa,
                                               "sparse_gradients": True})
    assert cfg.sparse_attention == sa and cfg.sparse_attention is not sa
    assert cfg.sparse_gradients_enabled is True
    plain = deepspeed_tpu_torch.DeepSpeedConfig({"train_batch_size": 2})
    assert plain.sparse_attention is None and plain.sparse_gradients_enabled is False
    model = TransformerLM(mistral_config("tiny", dtype=torch.float32, **TINY), device="cpu",
                          trainable=True)
    engine, _, _, _ = deepspeed_tpu_torch.initialize(model=model, config={"train_batch_size": 2})
    assert engine.sparse_attention_config() is None


# ---------------------------------------------------------------------------
# the eager API: forward / backward / step
# ---------------------------------------------------------------------------

EAGER = dict(train_batch_size=4, train_micro_batch_size_per_gpu=2, gradient_accumulation_steps=2)


def _eager_steps(engine, batches):
    """``engine(mb)`` / ``backward`` / ``step`` over each batch's gas
    microbatches; returns (every microbatch's loss, each step's mean
    loss)."""
    gas, micro = engine.gradient_accumulation_steps(), engine.train_micro_batch_size_per_gpu()
    mb_losses, step_losses = [], []
    for b in batches:
        for i in range(gas):
            loss = engine({k: v[i * micro:(i + 1) * micro] for k, v in b.items()})
            engine.backward(loss)
            engine.step()
            mb_losses.append(float(loss.detach()))
        step_losses.append(float(engine._step_metrics["loss"]))
    return mb_losses, step_losses


@pytest.mark.parametrize("mode,extra", [("never", False), ("always", True)])
def test_eager_api_is_bit_equal_to_train_batch(mode, extra):
    """Two steps at gas 2 through ``forward`` / ``backward`` / ``step`` and
    through ``train_batch`` from one seed: equal losses and parameters (the
    same per-microbatch code)."""
    tcfg = mistral_config("tiny", dtype=torch.float32, attention_impl="reference", **TINY)
    batches = [{k: v[:4] for k, v in _batch(50 + s, extra=extra).items()} for s in range(2)]
    m1 = TransformerLM(tcfg, device="cpu", trainable=True, seed=7)
    e1, _, _, _ = deepspeed_tpu_torch.initialize(model=m1, config=_ds_config(mode, **EAGER))
    fused = [float(e1.train_batch(b)) for b in batches]
    m2 = TransformerLM(tcfg, device="cpu", trainable=True, seed=7)
    e2, _, _, _ = deepspeed_tpu_torch.initialize(model=m2, config=_ds_config(mode, **EAGER))
    _, eager = _eager_steps(e2, batches)
    assert eager == fused
    assert all(torch.equal(a, b) for a, b in zip(m1.parameters(), m2.parameters()))
    assert (e2.global_steps, e2.micro_steps, e2.global_samples) == (2, 4, 8)
    assert int(e2.state["step"]) == int(e1.state["step"]) == 2


def test_eager_api_matches_the_jax_eager_engine():
    """The JAX engine's eager API (the analog of
    ``tests/test_engine_zero.py::test_eager_api_matches_fused``) at gas 2
    over two steps: microbatch losses and final parameters at rtol 2e-4 /
    atol 2e-5."""
    je, te = _engines("never", **EAGER)
    batches = [{k: v[:4] for k, v in _batch(60 + s).items()} for s in range(2)]
    ours, _ = _eager_steps(te, batches)
    ref = []
    for b in batches:
        for i in range(2):
            loss = je.forward({k: v[2 * i:2 * i + 2] for k, v in b.items()})
            je.backward(loss)
            je.step()
            ref.append(float(loss))
    np.testing.assert_allclose(ours, ref, rtol=2e-4, atol=2e-5)
    got = params_to_numpy(te.module.params())
    want = jax.tree.map(np.asarray, je.state["params"])
    for group in want:
        for name in want[group]:
            np.testing.assert_allclose(got[group][name], want[group][name], rtol=2e-4, atol=2e-5,
                                       err_msg=f"{group}/{name}")


def test_eager_eval_forward_mid_accumulation_step_and_boundary():
    """``eval()``: a loss without a graph, no gradient written. ``step()``
    mid-accumulation changes nothing; ``is_gradient_accumulation_boundary``
    turns true once the step's last microbatch has had its backward, and
    ``step()`` there updates once (twice raises)."""
    tcfg = mistral_config("tiny", dtype=torch.float32, attention_impl="reference", **TINY)
    model = TransformerLM(tcfg, device="cpu", trainable=True, seed=8)
    cfg = _ds_config("never", **EAGER)
    del cfg["scheduler"]  # the warm-up's first lr is 0
    engine, _, _, _ = deepspeed_tpu_torch.initialize(model=model, config=cfg)
    ids = _batch(70)["input_ids"][:4]
    engine.eval()
    loss = engine(ids[:2])
    assert not loss.requires_grad and all(p.grad is None for p in model.parameters())
    with torch.no_grad():
        assert torch.equal(loss, model.loss({"input_ids": torch.from_numpy(ids[:2])}))
    engine.train()
    before = [p.detach().clone() for p in model.parameters()]
    engine.backward(engine(ids[:2]))
    assert not engine.is_gradient_accumulation_boundary()
    engine.step()
    assert engine.global_steps == 0
    assert all(torch.equal(a, p) for a, p in zip(before, model.parameters()))
    engine.backward(engine(ids[2:]))
    assert engine.is_gradient_accumulation_boundary()
    engine.step()
    assert engine.global_steps == 1 and not engine.is_gradient_accumulation_boundary()
    assert not all(torch.equal(a, p) for a, p in zip(before, model.parameters()))
    with pytest.raises(RuntimeError, match="no backward"):
        engine.step()


def test_hybrid_engine_view_follows_eager_steps():
    """The hybrid engine rewrites its bf16-or-fp32 view when the step moved:
    after two eager steps its rollouts and view equal those of a twin
    trained by ``train_batch``."""
    tcfg = mistral_config("tiny", dtype=torch.float32, attention_impl="reference", **TINY)
    cfg = _ds_config("never", hybrid_engine={"enabled": True}, **EAGER)
    prompt = _batch(80)["input_ids"][:2, :6]
    batches = [{k: v[:4] for k, v in _batch(81 + s).items()} for s in range(2)]
    engines = []
    for eager in (False, True):
        model = TransformerLM(tcfg, device="cpu", trainable=True, seed=9)
        e, _, _, _ = deepspeed_tpu_torch.initialize(model=model, config=cfg)
        first = e.generate(prompt, max_new_tokens=4)
        if eager:
            _eager_steps(e, batches)
        else:
            for b in batches:
                e.train_batch(b)
        engines.append((e, first, e.generate(prompt, max_new_tokens=4)))
    (e1, first1, out1), (e2, first2, out2) = engines
    np.testing.assert_array_equal(first1, first2)
    np.testing.assert_array_equal(out1, out2)
    assert e2._inference_params_step == 2
    view1, view2 = e1._inference_engine.params, e2._inference_engine.params
    assert torch.equal(view1["blocks"][0]["wq"], view2["blocks"][0]["wq"])

"""PyTorch port: the training runtime's helpers against the JAX package.

The same numpy inputs go through both packages: the optimizers built from a
DeepSpeed ``optimizer`` block (``torch.optim`` objects against the optax
chains, several steps), the five lr schedules (evaluated on host numbers
and on a device step counter), the dynamic loss scaler's state machine, the
gradient-norm and clipping helpers, the data loader's batches, and the
batch-size triad's resolution. Tolerances: rtol 2e-6 / atol 2e-7 for the
optimizer updates (the tolerance of ``tests/test_fused_adam.py``: the same
fp32 formulas, one rounding more or less where XLA fuses a product and a
sum), rtol 1e-6 for schedules and norms, exact for the state machines.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deepspeed_tpu.runtime import dataloader as jdl
from deepspeed_tpu.runtime import lr_schedules as jlr
from deepspeed_tpu.runtime import utils as jutils
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JaxDeepSpeedConfig
from deepspeed_tpu.runtime.fp16 import loss_scaler as jls
from deepspeed_tpu.runtime.optimizers import build_optimizer as jax_build_optimizer
from deepspeed_tpu_torch import DeepSpeedConfig, DeepSpeedConfigError
from deepspeed_tpu_torch.runtime import dataloader as tdl
from deepspeed_tpu_torch.runtime import lr_schedules as tlr
from deepspeed_tpu_torch.runtime import utils as tutils
from deepspeed_tpu_torch.runtime.fp16 import loss_scaler as tls
from deepspeed_tpu_torch.runtime.optimizers import build_optimizer

SHAPES = [(5, 7), (128, ), (3, )]


def _grads(rng):
    return [rng.normal(size=s).astype(np.float32) for s in SHAPES]


@pytest.mark.parametrize("name,params", [
    ("adam", {"lr": 1e-2, "weight_decay": 0.1, "adam_w_mode": False}),
    ("adam", {"lr": 1e-2, "weight_decay": 0.1}),
    ("adamw", {"lr": 1e-2, "weight_decay": 0.05, "betas": [0.8, 0.99], "eps": 1e-6}),
    ("sgd", {"lr": 1e-2, "momentum": 0.9, "nesterov": True, "weight_decay": 0.01}),
    ("sgd", {"lr": 1e-2}),
    ("adagrad", {"lr": 1e-1}),
])
def test_optimizers_match_optax(name, params):
    rng = np.random.default_rng(0)
    p0 = _grads(rng)
    ours = [torch.nn.Parameter(torch.from_numpy(x.copy())) for x in p0]
    opt = build_optimizer(name, ours, params)
    tx = jax_build_optimizer(name, params)
    ref = [jnp.asarray(x) for x in p0]
    st = tx.init(ref)
    for _ in range(3):
        g = _grads(rng)
        upd, st = tx.update([jnp.asarray(x) for x in g], st, ref)
        ref = optax.apply_updates(ref, upd)
        for t, x in zip(ours, g):
            t.grad = torch.from_numpy(x)
        opt.step()
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=2e-6, atol=2e-7)
    assert int(opt.count) == 3
    # the overflow gate: a False device flag leaves params, state and count
    before = [t.detach().clone() for t in ours]
    state = {k: v.clone() for k, v in opt.state[ours[0]].items()}
    for t in ours:
        t.grad = torch.full_like(t, float("nan"))
    opt.step(gate=torch.tensor(False))
    assert int(opt.count) == 3 and all(torch.equal(a, b) for a, b in zip(ours, before))
    assert all(torch.equal(v, opt.state[ours[0]][k]) for k, v in state.items())


def test_optimizer_lr_schedule_runs_on_the_update_counter():
    """An lr schedule is evaluated on the optimizer's own count (optax's
    ``scale_by_schedule``), before the count advances."""
    sched = {"warmup_min_lr": 0.0, "warmup_max_lr": 1e-2, "warmup_num_steps": 4,
             "warmup_type": "linear"}
    rng = np.random.default_rng(1)
    p0 = _grads(rng)
    ours = [torch.nn.Parameter(torch.from_numpy(x.copy())) for x in p0]
    opt = build_optimizer("adamw", ours, {"weight_decay": 0.01},
                          lr=tlr.get_lr_schedule_fn("WarmupLR", sched))
    tx = jax_build_optimizer("adamw", {"weight_decay": 0.01},
                             lr=jlr.get_lr_schedule_fn("WarmupLR", sched))
    ref = [jnp.asarray(x) for x in p0]
    st = tx.init(ref)
    for _ in range(5):
        g = _grads(rng)
        upd, st = tx.update([jnp.asarray(x) for x in g], st, ref)
        ref = optax.apply_updates(ref, upd)
        for t, x in zip(ours, g):
            t.grad = torch.from_numpy(x)
        opt.step()
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=2e-6, atol=2e-7)


@pytest.mark.parametrize("name,params", [
    ("LRRangeTest", {"lr_range_test_min_lr": 1e-4, "lr_range_test_step_size": 10,
                     "lr_range_test_step_rate": 2.0, "lr_range_test_staircase": True}),
    ("OneCycle", {"cycle_min_lr": 1e-4, "cycle_max_lr": 1e-2, "cycle_first_step_size": 20,
                  "decay_lr_rate": 0.5, "decay_step_size": 10}),
    ("WarmupLR", {"warmup_min_lr": 1e-5, "warmup_max_lr": 1e-3, "warmup_num_steps": 30}),
    ("WarmupLR", {"warmup_num_steps": 30, "warmup_type": "linear"}),
    ("WarmupDecayLR", {"total_num_steps": 100, "warmup_num_steps": 10}),
    ("WarmupCosineLR", {"total_num_steps": 100, "warmup_num_steps": 10,
                        "warmup_min_ratio": 0.1, "cos_min_ratio": 0.01}),
])
def test_lr_schedules_match_jax(name, params):
    ours = tlr.get_lr_schedule_fn(name, params, base_lr=3e-3)
    ref = jlr.get_lr_schedule_fn(name, params, base_lr=3e-3)
    steps = [0, 1, 2, 5, 9, 10, 11, 19, 20, 21, 29, 30, 31, 45, 60, 99, 100, 150, 1000]
    expect = [float(ref(jnp.asarray(s, jnp.int32))) for s in steps]
    on_host = [float(ours(s)) for s in steps]
    on_counter = [float(ours(torch.tensor(s, dtype=torch.int32))) for s in steps]
    np.testing.assert_allclose(on_host, expect, rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(on_counter, expect, rtol=1e-6, atol=1e-12)
    a, b = tlr.LRScheduler(ours), jlr.LRScheduler(ref)
    for _ in range(12):
        np.testing.assert_allclose(a.step(), b.step(), rtol=1e-6)
    assert a.state_dict() == b.state_dict()


@pytest.mark.parametrize("delayed_shift,consecutive", [(1, False), (2, False), (2, True)])
def test_dynamic_loss_scaler_matches_jax(delayed_shift, consecutive):
    kw = dict(init_scale=2.0**10, scale_window=3, min_scale=1.0, delayed_shift=delayed_shift,
              consecutive_hysteresis=consecutive)
    ours, ref = tls.DynamicLossScaler(**kw), jls.DynamicLossScaler(**kw)
    overflows = [False, True, False, False, False, True, True, False, True, False, False, False,
                 False, False, True, True, True]
    seen = []
    for o in overflows:
        ours.update_scale(o)
        ref.update_scale(o)
        seen.append((ours.cur_scale, ours.cur_hysteresis))
        assert (ours.cur_scale, ours.cur_hysteresis) == (ref.cur_scale, ref.cur_hysteresis)
    assert len({s for s, _ in seen}) > 2
    assert ours.has_overflow([np.ones(3), np.array([1.0, np.inf])])
    assert not ours.has_overflow([np.ones(3)])
    static = tls.CreateLossScaler(np.float16, 128.0, False, None)
    assert type(static).__name__ == "LossScaler" and static.loss_scale == 128.0
    dyn = tls.CreateLossScaler(np.float16, 0, True, {"init_scale": 2.0**8})
    assert dyn.dynamic and dyn.loss_scale == 256.0


def test_norm_and_clip_helpers_match_jax():
    rng = np.random.default_rng(2)
    g = [x * 3 for x in _grads(rng)]
    tg = [torch.from_numpy(x.copy()) for x in g]
    jg = [jnp.asarray(x) for x in g]
    np.testing.assert_allclose(float(tutils.global_norm(tg)), float(optax.global_norm(jg)),
                               rtol=1e-6)
    for norm_type in (2.0, 3.0, float("inf")):
        np.testing.assert_allclose(float(tutils.get_grad_norm(tg, norm_type)),
                                   float(jutils.get_grad_norm(jg, norm_type)), rtol=1e-6)
    assert tutils.get_global_norm([3.0, 4.0]) == jutils.get_global_norm([3.0, 4.0]) == 5.0
    # clip_grad_norm_ (min(1, max_norm / (norm + 1e-6)) scale) in place
    clipped, total = jutils.clip_grad_norm_(jg, 1.5)
    ours = [t.clone() for t in tg]
    np.testing.assert_allclose(float(tutils.clip_grad_norm_(ours, 1.5)), float(total), rtol=1e-6)
    for a, b in zip(ours, clipped):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    # optax's clip_by_global_norm, above and below the threshold
    for max_norm in (1.0, 1e3):
        ref, _ = optax.clip_by_global_norm(max_norm).update(jg, optax.EmptyState())
        ours = [t.clone() for t in tg]
        tutils.clip_by_global_norm_(ours, max_norm)
        for a, b in zip(ours, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


@pytest.mark.parametrize("drop_last", [False, True])
def test_dataloader_batches_match_jax(drop_last):
    rng = np.random.default_rng(3)
    data = [{"input_ids": rng.integers(0, 100, 6).astype(np.int32), "y": np.float32(i)}
            for i in range(11)]
    ours = tdl.DeepSpeedDataLoader(data, batch_size=3, drop_last=drop_last, seed=4)
    ref = jdl.DeepSpeedDataLoader(data, batch_size=3, drop_last=drop_last, seed=4)
    assert len(ours) == len(ref)
    a, b = tdl.RepeatingLoader(ours), jdl.RepeatingLoader(ref)
    for _ in range(3 * len(ours) + 1):  # across two epoch restarts
        x, y = next(a), next(b)
        assert x.keys() == y.keys()
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])
    assert ours.sampler.epoch == ref.sampler.epoch == 3


@pytest.mark.parametrize("triad", [
    {"train_batch_size": 16, "train_micro_batch_size_per_gpu": 2},
    {"train_batch_size": 16, "gradient_accumulation_steps": 4},
    {"train_micro_batch_size_per_gpu": 3},
    {"train_micro_batch_size_per_gpu": 3, "gradient_accumulation_steps": 5},
    {"train_batch_size": 8},
    {"train_batch_size": 8, "train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 4},
])
def test_batch_triad_resolves_as_jax(triad):
    ours, ref = DeepSpeedConfig(dict(triad)), JaxDeepSpeedConfig(dict(triad))
    ours.resolve_batch_config(1)
    ref.resolve_batch_config(1)
    got = (ours.train_batch_size, ours.train_micro_batch_size_per_gpu,
           ours.gradient_accumulation_steps)
    assert got == (ref.train_batch_size, ref.train_micro_batch_size_per_gpu,
                   ref.gradient_accumulation_steps)


def test_config_refusals():
    with pytest.raises(DeepSpeedConfigError, match="simultaneously"):
        DeepSpeedConfig({"train_batch_size": 2, "fp16": {"enabled": True},
                         "bf16": {"enabled": True}})
    with pytest.raises(AssertionError, match="train_batch_size is not equal"):
        DeepSpeedConfig({"train_batch_size": 6, "train_micro_batch_size_per_gpu": 4,
                         "gradient_accumulation_steps": 1}).resolve_batch_config(1)
    with pytest.raises(DeepSpeedConfigError, match="stage"):
        DeepSpeedConfig({"train_batch_size": 2, "zero_optimization": {"stage": 4}})
    with pytest.raises(NotImplementedError, match="optimizer.legacy_fusion"):
        DeepSpeedConfig({"train_batch_size": 2,
                         "optimizer": {"type": "Adam", "params": {}, "legacy_fusion": True}})
    # the model axis (tensor parallelism, A3b) is accepted and resolves
    mesh = DeepSpeedConfig({"train_batch_size": 2, "tpu": {"mesh": {"data": 2, "model": 2}}}
                           ).tpu_config.mesh_config()
    assert (mesh.resolve(4)["data"], mesh.resolve(4)["model"]) == (2, 2)
    with pytest.raises(NotImplementedError, match="mesh axis 'pipe'.*A6.8"):
        DeepSpeedConfig({"train_batch_size": 2, "tpu": {"mesh": {"data": 2, "pipe": 2}}})


def test_add_config_arguments_and_initialize_from_args(tmp_path):
    """The CLI flags of ``add_config_arguments``, and ``initialize(args=...)``
    reading ``--deepspeed_config``; a bare loss function with its initial
    parameters is adapted to the model protocol."""
    import argparse
    import json

    import deepspeed_tpu_torch

    path = tmp_path / "ds_config.json"
    path.write_text(json.dumps({"train_batch_size": 4, "train_micro_batch_size_per_gpu": 2,
                                "optimizer": {"type": "SGD", "params": {"lr": 0.5}}}))
    parser = deepspeed_tpu_torch.add_config_arguments(argparse.ArgumentParser())
    args = parser.parse_args(["--deepspeed", "--deepspeed_config", str(path)])
    assert args.deepspeed and args.deepspeed_config == str(path)
    w0 = torch.ones(3, 1)

    def loss_fn(params, batch):
        return torch.mean((batch["x"] @ params["w"])**2)

    engine, opt, loader, sched = deepspeed_tpu_torch.initialize(args=args, model=loss_fn,
                                                                model_parameters={"w": w0})
    assert engine.get_batch_info() == (4, 2, 2) and loader is None and sched is None
    x = np.ones((4, 3), np.float32)
    loss = engine.train_batch({"x": x})
    assert float(loss) == 9.0  # (1 + 1 + 1)^2 on every row
    # d/dw mean((x w)^2) = 2 * 3 * x_row = 6 per weight; one SGD step of lr 0.5
    np.testing.assert_allclose(engine.module.params["w"].detach().numpy(), np.full((3, 1), -2.0))

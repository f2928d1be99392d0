"""PyTorch port: Lamb and Lion (``runtime/optimizers.py``) against the JAX
package's ``build_optimizer("lamb" / "lion")`` optax chains on the CPU.

Five steps on seeded numpy tensors, with and without weight decay,
including an all-zero tensor (Lamb's trust ratio is then 1), at rtol 1e-6;
Lamb's ``trust_groups`` against a stacked JAX leaf. Then three
``train_batch`` steps of a tiny Mistral under each, through
``deepspeed_tpu_torch.initialize`` against ``deepspeed_tpu.initialize``, at
the tolerances of ``tests/test_torch_family_training.py`` (losses rtol 2e-5,
parameters rtol 2e-4 / atol 2e-6); the registry's four names; the 1-bit
names mapped to ``Adam`` and ``Lamb``, as the JAX package maps them.

Lion moves every element by exactly lr times the sign of ``(1 - b1) g +
b1 m``. The two frameworks' gradients agree to ~1e-6 of each tensor's
largest element (fp32 sums in another order), so where that argument is
itself at the noise level its sign is the noise's and the element may move
by +lr on one side and -lr on the other. The engine test reads the JAX
engine's own argument at every step from its Lion state (``g = (m_t - b2
m_{t-1}) / (1 - b2)``), holds every other element to the tolerances above,
and those (at most one in 10^3 of a tensor) to 2 lr a step. An argument
that is exactly 0 (a gradient that is 0 on both sides) is no noise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import TransformerLM as JaxLM
from deepspeed_tpu.models import mistral_config as jax_mistral_config
from deepspeed_tpu.parallel.mesh import single_device_mesh
from deepspeed_tpu.runtime.optimizers import build_optimizer as jax_build
from deepspeed_tpu_torch.models import (TransformerLM, mistral_config, params_from_jax,
                                        params_to_numpy)
from deepspeed_tpu_torch.runtime.optimizers import Lamb, Lion, build_optimizer

TINY = dict(num_layers=2, hidden_size=64, num_heads=4, num_kv_heads=2, intermediate_size=128,
            vocab_size=256, max_seq_len=256, sliding_window=16)


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((16, 8)).astype(np.float32),
            "b": rng.standard_normal((40,)).astype(np.float32),
            "z": np.zeros((3, 5), np.float32)}


def _run_both(name, params, steps=5, stacked=False):
    tree = _tree(0)
    tx = jax_build(name, params)
    jp = {k: jnp.asarray(v) for k, v in tree.items()}
    state = tx.init(jp)
    if stacked:  # the port holds "a" as two tensors sharing one trust ratio
        ts = [torch.from_numpy(tree["a"][:8].copy()), torch.from_numpy(tree["a"][8:].copy()),
              torch.from_numpy(tree["b"].copy()), torch.from_numpy(tree["z"].copy())]
        opt = build_optimizer(name, ts, params, trust_groups=[[0, 1], [2], [3]])
    else:
        ts = [torch.from_numpy(tree[k].copy()) for k in sorted(tree)]
        opt = build_optimizer(name, ts, params)
    for step in range(steps):
        g = _tree(10 + step)
        g["z"] = np.random.default_rng(99 + step).standard_normal((3, 5)).astype(np.float32)
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)
        flat = ([g["a"][:8], g["a"][8:], g["b"], g["z"]] if stacked else
                [g[k] for k in sorted(g)])
        for t, gt in zip(ts, flat):
            t.grad = torch.from_numpy(np.ascontiguousarray(gt))
        opt.step()
    ours = ([torch.cat(ts[:2]), ts[2], ts[3]] if stacked else ts)
    return [np.asarray(jp[k]) for k in sorted(jp)], [t.numpy() for t in ours], opt


@pytest.mark.parametrize("name", ["lamb", "lion"])
@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_lamb_lion_match_the_optax_chains(name, wd):
    want, got, opt = _run_both(name, {"lr": 1e-2, "weight_decay": wd})
    assert isinstance(opt, Lamb if name == "lamb" else Lion)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7)
    assert int(opt.count) == 5
    if name == "lamb" and wd == 0.0:
        # the all-zero tensor: ||p|| = 0, so the ratio is 1 and it moves by lr * u
        assert np.abs(got[2]).max() > 0


def test_lamb_trust_groups_equal_a_stacked_leaf():
    want, got, _ = _run_both("lamb", {"lr": 1e-2, "weight_decay": 0.01}, stacked=True)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7)


def test_lamb_lion_gate_and_schedule():
    p = torch.ones(4)
    opt = Lion([p], lr=lambda count: 0.1 * (count.float() + 1), weight_decay=0.0)
    p.grad = torch.tensor([1.0, -1.0, 2.0, 0.0])
    opt.step(gate=torch.tensor(False))
    assert torch.equal(p, torch.ones(4)) and int(opt.count) == 0
    opt.step(gate=torch.tensor(True))
    assert torch.allclose(p, torch.tensor([0.9, 1.1, 0.9, 1.0])) and int(opt.count) == 1
    with pytest.raises(ValueError, match="trust_groups"):
        Lamb([torch.ones(2), torch.ones(2)], trust_groups=[[0]])


def _ds_config(name):
    return {"train_batch_size": 8, "train_micro_batch_size_per_gpu": 2,
            "gradient_accumulation_steps": 4,
            "optimizer": {"type": name, "params": {"lr": 1e-4, "weight_decay": 0.1}},
            "scheduler": {"type": "WarmupLR", "params": {"warmup_num_steps": 2,
                                                         "warmup_max_lr": 1e-4,
                                                         "warmup_type": "linear"}},
            "gradient_clipping": 1.0, "steps_per_print": 100,
            "tpu": {"pallas_fused_adam": "never"}}


@pytest.mark.parametrize("name", ["Lamb", "Lion"])
def test_train_batch_matches_jax_engine(name):
    jcfg = jax_mistral_config("tiny", dtype=jnp.float32, attention_impl="reference", **TINY)
    je, _, _, _ = deepspeed_tpu.initialize(model=JaxLM(jcfg), config=_ds_config(name),
                                           mesh=single_device_mesh())
    npp = jax.tree.map(np.asarray, je.state["params"])
    tcfg = mistral_config("tiny", dtype=torch.float32, attention_impl="reference", **TINY)
    model = TransformerLM(tcfg, params_from_jax(npp, tcfg, device="cpu", dtype=torch.float32,
                                                per_layer=True), trainable=True)
    te, opt, _, _ = deepspeed_tpu_torch.initialize(model=model, config=_ds_config(name))
    assert isinstance(opt, Lamb if name == "Lamb" else Lion)
    if name == "Lamb":  # one trust ratio a JAX leaf: the layers' tensors of a stacked leaf share it
        assert len(opt.trust_groups) == len(jax.tree_util.tree_leaves(npp))
    lion_mu = (lambda: jax.tree.map(np.asarray, je.state["opt_state"][1][0].mu))
    noise = jax.tree.map(lambda p: np.zeros(p.shape, bool), npp)
    mu = lion_mu() if name == "Lion" else None
    for step in range(3):
        ids = np.random.default_rng(step).integers(0, 256, size=(8, 24)).astype(np.int32)
        lj = float(je.train_batch({"input_ids": ids}))
        lt = float(te.train_batch({"input_ids": ids}))
        np.testing.assert_allclose(lt, lj, rtol=2e-5, err_msg=f"{name} step {step}")
        if name == "Lion":  # the JAX side's sign argument this step, where it is noise
            new_mu = lion_mu()
            arg = jax.tree.map(lambda m1, m0: 0.1 * (m1 - 0.99 * m0.astype(np.float64)) / 0.01
                               + 0.9 * m0, new_mu, mu)
            # (an exact 0, e.g. an embedding row no token of the step used, is
            # no noise: sign(0) is 0 on both sides)
            noise = jax.tree.map(lambda n, a: n | ((a != 0) & (np.abs(a) <= 1e-5
                                                              * np.abs(a).max())), noise, arg)
            mu = new_mu
    ours = params_to_numpy(te.module.params())
    ref = jax.tree.map(np.asarray, je.state["params"])
    for group in ref:
        for key in ref[group]:
            n = noise[group][key]
            assert n.mean() <= 1e-3, (group, key)
            np.testing.assert_allclose(ours[group][key][~n], ref[group][key][~n], rtol=2e-4,
                                       atol=2e-6, err_msg=f"{name}: {group}/{key}")
            assert np.all(np.abs(ours[group][key][n] - ref[group][key][n]) <= 2e-4 * 3 + 2e-6)


def test_registry_names_and_one_bit_refusals():
    from deepspeed_tpu_torch.ops import op_registry
    from deepspeed_tpu_torch.runtime import optimizers

    for key in ("FusedLambBuilder", "FusedLionBuilder", "CPULionBuilder", "CPUAdagradBuilder"):
        b = op_registry[key]
        assert b.is_compatible() and b.load() is optimizers, key
    assert hasattr(optimizers, "Lamb") and hasattr(optimizers, "Lion")
    assert op_registry["CPUAdamBuilder"].load().DeepSpeedCPUAdam is not None
    assert op_registry["AsyncIOBuilder"].load().AsyncIOHandle is not None
    # the 1-bit names map to the update rule the JAX package pairs with
    # their compressed exchange (optimizers.py:48,61)
    for name, cls in (("OneBitAdam", optimizers.Adam), ("ZeroOneAdam", optimizers.Adam),
                      ("OneBitLamb", Lamb)):
        assert type(build_optimizer(name, [torch.ones(2)], {})) is cls, name


@pytest.mark.parametrize("mesh,stage,ok", [({"data": 2}, 0, True), ({"data": 2}, 1, True),
                                          ({"data": 2}, 2, False), ({"data": 2}, 3, False),
                                          ({"data": 1, "model": 2}, 0, False)])
def test_lamb_at_world_size_two(mesh, stage, ok):
    """Lamb at world size 2 (a fake process group in this process): at ZeRO
    stages 0-1 each JAX leaf's trust ratio is taken over the slices its
    tensors occupy in the partition's buffers (at stage 1 this rank's
    shards, their square sums summed over the data group); under tensor
    parallelism and at stages 2-3 it raises, naming A6.3, left open."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    model = TransformerLM(mistral_config("tiny", dtype=torch.float32, **TINY), device="cpu",
                          trainable=True)
    config = dict(_ds_config("Lamb"), train_batch_size=8 * mesh["data"], zero_optimization={
        "stage": stage}, tpu={"mesh": mesh, "pallas_fused_adam": "never"})
    dist.init_process_group("fake", rank=1, world_size=2, store=FakeStore())
    try:
        if not ok:
            with pytest.raises(NotImplementedError, match="A6.3, left open"):
                deepspeed_tpu_torch.initialize(model=model, config=config)
            return
        engine, opt, _, _ = deepspeed_tpu_torch.initialize(model=model, config=config)
        z = engine._zero
        assert isinstance(opt, Lamb) and len(opt.trust_groups) == 12  # the JAX leaves
        assert opt.norm_group is (z.group if stage == 1 else None)
        # every element of every leaf lies in one slice, on one of the ranks
        for unit, groups_ in zip(engine._jax_leaf_units(), opt.trust_groups):
            n = sum(engine._params[i].numel() for i in unit)
            held = sum(hi - lo for _, lo, hi in groups_)
            assert held == n if stage == 0 else 0 <= held <= n
    finally:
        dist.destroy_process_group()

"""PyTorch port: the 1-bit optimizers (``runtime/comm/compressed.py``,
``runtime/fp16/onebit``) against the JAX package on the CPU.

- ``pack_signs`` / ``unpack_signs`` and ``onebit_chunk_len``, bit for bit.
- ``onebit_allreduce`` on two gloo ranks against the JAX one in
  ``shard_map`` over two virtual devices, on seeded inputs with non-zero
  error buffers: the output and both new error buffers within 1e-6.
- ``train_batch`` with ``OneBitAdam`` (ZeRO stage 0), ``OneBitLamb`` (stage
  1: Lamb's trust ratio over each rank's shards, one ``all_reduce`` of the
  JAX leaves' square sums) and ``ZeroOneAdam`` (stage 1) at ``data`` 2
  against the JAX engine on two virtual devices, ``freeze_step`` 2 and 4
  steps (two exact, two compressed): losses at rtol 2e-5, the gathered
  parameters at rtol 2e-4 / atol 2e-6 (the tolerances of
  ``tests/test_torch_zero.py``), every error buffer at rtol 2e-4 and an atol
  of 2e-4 times its leaf's largest element (an error element is a gradient
  element plus the last error, and the two frameworks' fp32 gradient sums
  differ by ~1e-6 of the leaf's largest terms). The port compresses each JAX
  leaf whole (a ``TransformerLM``'s per-layer tensors of one stacked leaf
  concatenated), so its scales are the JAX engine's.
- A non-finite gradient on one rank sends both ranks down the exact path:
  the error buffers stay as they were and the update is skipped; a skipped
  step before ``freeze_step`` does not advance the step that the switch
  reads (the JAX engine's ``state["step"]`` counts finite steps only).
- The refusals: tensor parallelism, ZeRO stage 2, offload, MiCS and a MoE
  model.
"""

import os
import pickle

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import TransformerLM, mistral_config, params_from_jax
from deepspeed_tpu_torch.runtime.comm import compressed as tc

WORLD, MICRO, GAS, STEPS, FREEZE = 2, 2, 2, 4, 2
TINY = dict(num_layers=2, hidden_size=64, num_heads=4, num_kv_heads=2, intermediate_size=128,
            vocab_size=256, max_seq_len=256, sliding_window=16)
# name -> (optimizer type, ZeRO stage)
CASES = {"adam": ("OneBitAdam", 0), "lamb": ("OneBitLamb", 1), "zoadam": ("ZeroOneAdam", 1)}
ALLREDUCE_SIZES = (3, 40, 1000)  # elements of each onebit_allreduce case
TIMEOUT_S = 180


def _ds_config(name, stage, freeze=FREEZE, **over):
    params = {"lr": 1e-3, "weight_decay": 0.1,
              ("var_freeze_step" if name == "ZeroOneAdam" else "freeze_step"): freeze}
    cfg = {"train_batch_size": MICRO * GAS * WORLD, "train_micro_batch_size_per_gpu": MICRO,
           "gradient_accumulation_steps": GAS, "optimizer": {"type": name, "params": params},
           "gradient_clipping": 1.0, "steps_per_print": 100,
           "zero_optimization": {"stage": stage}, "tpu": {"mesh": {"data": WORLD}}}
    cfg.update(over)
    return cfg


def _global_batch(step):
    rng = np.random.default_rng(200 + step)
    return {"input_ids": rng.integers(0, 256, size=(MICRO * GAS * WORLD, 24)).astype(np.int32)}


def _rank_rows(batch, rank):
    return {k: v.reshape(GAS, WORLD, MICRO, *v.shape[1:])[:, rank].reshape(GAS * MICRO,
                                                                            *v.shape[1:])
            for k, v in batch.items()}


def _allreduce_inputs(n, world=WORLD):
    rng = np.random.default_rng(n)
    chunk = tc.onebit_chunk_len(n, world)
    return (rng.standard_normal((world, n)).astype(np.float32),
            0.1 * rng.standard_normal((world, n)).astype(np.float32),
            0.1 * rng.standard_normal((world, chunk)).astype(np.float32))


class _PoisonLM(TransformerLM):
    """The port's model whose loss is NaN on a microbatch whose ``poison``
    is set (the JAX test's ``PoisonableModel``)."""

    def _loss_terms(self, batch, generator=None, params=None):
        ce, aux = super()._loss_terms({k: v for k, v in batch.items() if k != "poison"},
                                      generator, params)
        return ce * torch.where(batch["poison"].any(), float("nan"), 1.0), aux


def _torch_model(npp, cls=TransformerLM):
    cfg = mistral_config("tiny", dtype=torch.float32, attention_impl="reference", **TINY)
    return cls(cfg, params_from_jax(npp, cfg, device="cpu", dtype=torch.float32,
                                    per_layer=True), trainable=True)


def _poison_run(rank, npp, freeze, poison_step):
    """OneBitAdam at stage 0 over STEPS steps, rank 1's rows of step
    ``poison_step`` poisoned: per step (compressed, loss finite, the error
    buffers after, the engine's step counter, a parameter's sum)."""
    engine, _, _, _ = deepspeed_tpu_torch.initialize(
        model=_torch_model(npp, _PoisonLM), config=_ds_config("OneBitAdam", 0, freeze))
    out = []
    for step in range(STEPS):
        rows = _rank_rows(_global_batch(step), rank)
        rows["poison"] = np.full((GAS * MICRO, 1), float(step == poison_step and rank == 1),
                                 np.float32)
        loss = float(engine.train_batch(rows))
        out.append({"compressed": engine.onebit_compressed, "finite": bool(np.isfinite(loss)),
                    "err_w": [e.numpy().copy() for e in engine.onebit_err_w],
                    "err_s": [e.numpy().copy() for e in engine.onebit_err_s],
                    "step": int(engine.state["step"]),
                    "param_sum": float(sum(p.detach().double().sum()
                                           for p in engine.module.parameters()))})
    return out


def _worker(rank, store, out_dir):
    torch.set_num_threads(1)
    with open(os.path.join(out_dir, "npp.pkl"), "rb") as f:
        npp = pickle.load(f)
    deepspeed_tpu_torch.init_distributed(dist_backend="gloo", init_method=f"file://{store}",
                                         rank=rank, world_size=WORLD, verbose=False)
    from deepspeed_tpu_torch import comm

    results = {}
    try:
        for n in ALLREDUCE_SIZES:
            x, ew, es = (torch.from_numpy(a[rank].copy()) for a in _allreduce_inputs(n))
            results[f"allreduce{n}"] = [t.numpy() for t in tc.onebit_allreduce(x, ew, es, None,
                                                                               WORLD)]
        for name, (opt, stage) in CASES.items():
            engine, _, _, _ = deepspeed_tpu_torch.initialize(model=_torch_model(npp),
                                                             config=_ds_config(opt, stage))
            r = {"losses": [], "compressed": []}
            for step in range(STEPS):
                r["losses"].append(float(engine.train_batch(_rank_rows(_global_batch(step),
                                                                       rank))))
                r["compressed"].append(engine.onebit_compressed)
            r["params"] = {k: v.numpy().copy() for k, v in engine.module_state_dict().items()}
            r["err_w"] = [e.numpy().copy() for e in engine.onebit_err_w]
            r["err_s"] = [e.numpy().copy() for e in engine.onebit_err_s]
            r["fused"] = engine._pallas_adam is not None
            results[name] = r
        results["nan_compressed"] = _poison_run(rank, npp, 0, 1)
        results["nan_warmup"] = _poison_run(rank, npp, FREEZE, 1)
    finally:
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(results, f)
        comm.destroy_process_group()


def _jax_allreduce(n, world=WORLD):
    """The JAX ``onebit_allreduce`` in ``shard_map`` over ``world`` virtual
    devices: [per device: (out, err_w, err_s)] stacked."""
    import jax
    from jax.sharding import Mesh, PartitionSpec as P

    from deepspeed_tpu.runtime.comm.compressed import onebit_allreduce

    mesh = Mesh(np.asarray(jax.devices()[:world]), axis_names=("data", ))

    def f(xs, ew, es):
        out, new_ew, new_es = onebit_allreduce(xs[0], ew[0], es[0], "data", world)
        return out[None], new_ew[None], new_es[None]

    spec = (P("data"), P("data"), P("data"))
    g = jax.jit(jax.shard_map(f, mesh=mesh, in_specs=spec, out_specs=spec, check_vma=False))
    return [np.asarray(a) for a in g(*_allreduce_inputs(n, world))]


def _jax_engine(opt, stage):
    import jax
    import jax.numpy as jnp

    import deepspeed_tpu
    from deepspeed_tpu.models import TransformerLM as JaxLM
    from deepspeed_tpu.models import mistral_config as jax_mistral_config
    from deepspeed_tpu.parallel import groups as jax_groups
    from deepspeed_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
    from deepspeed_tpu.parallel.mesh import build_mesh

    jax_groups.reset()
    jcfg = jax_mistral_config("tiny", dtype=jnp.float32, attention_impl="reference", **TINY)
    mesh = build_mesh(JaxMeshConfig(data=WORLD), devices=jax.devices()[:WORLD])
    je, _, _, _ = deepspeed_tpu.initialize(model=JaxLM(jcfg), config=_ds_config(opt, stage),
                                           mesh=mesh)
    return je


def _jax_train(je):
    import jax

    losses = [float(je.train_batch(_global_batch(step))) for step in range(STEPS)]
    state = jax.tree.map(np.asarray, {k: je.state[k] for k in ("params", "onebit_err_w",
                                                                "onebit_err_s")})
    return losses, state


@pytest.fixture(scope="module")
def onebit_run(tmp_path_factory):
    """The ranks' results and the JAX references."""
    import jax
    from concurrent.futures import ThreadPoolExecutor

    tmp = tmp_path_factory.mktemp("onebit")
    # one at a time: initialize sets the JAX package's global mesh
    engines = {name: _jax_engine(*CASES[name]) for name in CASES}
    npp = jax.tree.map(np.asarray, engines["adam"].state["params"])
    with open(tmp / "npp.pkl", "wb") as f:  # read by the ranks, which then start together
        pickle.dump(npp, f)
    ctx = mp.start_processes(_worker, args=(str(tmp / "store"), str(tmp)), nprocs=WORLD,
                             join=False, start_method="spawn")
    try:  # the JAX engines train in threads, beside the ranks
        with ThreadPoolExecutor(len(engines)) as ex:
            futures = {name: ex.submit(_jax_train, je) for name, je in engines.items()}
            allreduce = {n: _jax_allreduce(n) for n in ALLREDUCE_SIZES}
            refs = {name: f.result() for name, f in futures.items()}
    finally:
        for p in ctx.processes:
            p.join(TIMEOUT_S)
        alive = [p.pid for p in ctx.processes if p.is_alive()]
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    assert not alive, f"ranks {alive} still running after {TIMEOUT_S} s"
    assert all(p.exitcode == 0 for p in ctx.processes), [p.exitcode for p in ctx.processes]
    ranks = []
    for r in range(WORLD):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return {"ranks": ranks, "refs": refs, "allreduce": allreduce, "npp": npp}


# ---------------------------------------------------------------------------
# in this process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(4, 64), (1, 8), (3, 2, 16)])
def test_pack_unpack_signs_bit_for_bit(shape):
    import jax.numpy as jnp

    from deepspeed_tpu.runtime.comm import compressed as jc

    bits = (np.random.default_rng(len(shape)).random(shape) > 0.5).astype(np.uint8)
    packed = tc.pack_signs(torch.from_numpy(bits))
    want = np.asarray(jc.pack_signs(jnp.asarray(bits)))
    assert packed.dtype == torch.uint8 and np.array_equal(packed.numpy(), want)
    assert np.array_equal(tc.unpack_signs(packed).numpy(),
                          np.asarray(jc.unpack_signs(jnp.asarray(want))))


@pytest.mark.parametrize("n,world", [(100, 8), (64, 8), (1, 8), (7, 2), (1000, 3), (0, 4)])
def test_onebit_chunk_len_matches_jax(n, world):
    from deepspeed_tpu.runtime.comm.compressed import onebit_chunk_len

    assert tc.onebit_chunk_len(n, world) == onebit_chunk_len(n, world)


def test_world_size_one_allreduce_and_the_collective_helpers():
    """At world size 1 ``onebit_allreduce`` runs no collective and is the
    JAX formula over one device; ``all_to_all_quant_reduce`` names A8."""
    x, ew, es = _allreduce_inputs(40, 1)
    got = tc.onebit_allreduce(*(torch.from_numpy(a[0]) for a in (x, ew, es)), None, 1)
    for g, w in zip(got, _jax_allreduce(40, 1)):
        np.testing.assert_allclose(g.numpy(), w[0], rtol=1e-6, atol=1e-6)
    with pytest.raises(NotImplementedError, match="A8"):
        tc.all_to_all_quant_reduce([torch.ones(4)])
    assert tc.onebit_wire_bytes(1000, 4) == 2 * 3 * (256 // 8 + 4)


def test_onebit_policies_copy_the_jax_defaults():
    from deepspeed_tpu.runtime.fp16 import onebit as jo

    from deepspeed_tpu_torch.runtime.fp16 import onebit as to

    for name in ("OnebitAdam", "OnebitLamb", "ZeroOneAdam"):
        for params in ({}, {"freeze_step": 5, "lr": 0.1}, {"var_freeze_step": 9, "betas": [0.8,
                                                                                        0.9]}):
            got = getattr(to, name).from_params(params)
            want = getattr(jo, name).from_params(params)
            assert got.__dict__ == want.__dict__, (name, params)
            assert got.base_optimizer == want.base_optimizer


@pytest.mark.parametrize("mesh,over,match", [
    ({"data": 1, "model": 2}, {}, "pure data parallelism"),
    ({}, {"zero_optimization": {"stage": 2}}, "ZeRO stage <= 1"),
    ({}, {"zero_optimization": {"stage": 0, "offload_optimizer": {"device": "cpu"}}},
     "offload_optimizer"),
    ({}, {"zero_optimization": {"stage": 1, "mics_shard_size": 2}}, "MiCS"),
    ({}, {}, "A6.7, left open"),
    (None, {}, "train_batch"),
])
def test_onebit_refusals(mesh, over, match):
    """The JAX package's envelope (ZeRO stage <= 1, data parallelism only,
    no offload; MiCS the config refuses), a MoE model (the port shards
    its experts over the data group), and the eager API
    (``engine.py:1609``): each raises, naming itself."""
    if mesh is None:  # initialize accepts it; forward, backward and step refuse
        engine, _, _, _ = deepspeed_tpu_torch.initialize(
            model=TransformerLM(mistral_config("tiny", dtype=torch.float32, **TINY),
                                device="cpu", trainable=True),
            config=dict(_ds_config("OneBitAdam", 0), train_batch_size=MICRO * GAS,
                        tpu={"mesh": {"data": 1}}))
        batch = {"input_ids": np.zeros((MICRO, 8), np.int32)}
        for call in (lambda: engine.forward(batch), lambda: engine.backward(None), engine.step):
            with pytest.raises(RuntimeError, match=match):
                call()
        return
    world = 2 if mesh else 1
    moe = dict(moe_num_experts=4, moe_top_k=2) if match.startswith("A6.7") else {}
    model = TransformerLM(mistral_config("tiny", dtype=torch.float32, **TINY, **moe),
                          device="cpu", trainable=True)
    config = dict(_ds_config("OneBitAdam", 0), train_batch_size=MICRO * GAS * world,
                  tpu={"mesh": mesh or {"data": 1}}, **over)
    if world == 1:
        with pytest.raises((ValueError, NotImplementedError), match=match):
            deepspeed_tpu_torch.initialize(model=model, config=config)
        return
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", rank=0, world_size=world, store=FakeStore())
    try:
        with pytest.raises(ValueError, match=match):
            deepspeed_tpu_torch.initialize(model=model, config=config)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# two gloo ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", ALLREDUCE_SIZES)
def test_onebit_allreduce_matches_jax_shard_map(onebit_run, n):
    want = onebit_run["allreduce"][n]
    for rank, r in enumerate(onebit_run["ranks"]):
        for got, ref in zip(r[f"allreduce{n}"], want):
            np.testing.assert_allclose(got, ref[rank], rtol=1e-6, atol=1e-6)
    # every rank gets the same mean
    assert np.array_equal(onebit_run["ranks"][0][f"allreduce{n}"][0],
                          onebit_run["ranks"][1][f"allreduce{n}"][0])


def _jax_leaf(name):
    """The port's state-dict name -> (group, leaf, layer or None)."""
    parts = name.split(".")[1:]
    return (parts[0], parts[2], int(parts[1])) if parts[0] == "blocks" else (parts[0], parts[1],
                                                                             None)


@pytest.mark.parametrize("name", list(CASES))
def test_onebit_train_batch_matches_the_jax_engine(onebit_run, name):
    import jax

    ref_losses, ref = onebit_run["refs"][name]
    for rank, r in enumerate(onebit_run["ranks"]):
        res = r[name]
        assert res["compressed"] == [False] * FREEZE + [True] * (STEPS - FREEZE)
        assert not res["fused"]
        np.testing.assert_allclose(res["losses"], ref_losses, rtol=2e-5)
        for key, v in res["params"].items():
            group, leaf, layer = _jax_leaf(key)
            want = ref["params"][group][leaf]
            np.testing.assert_allclose(v, want if layer is None else want[layer], rtol=2e-4,
                                       atol=2e-6, err_msg=f"{name}: {key}")
        # the error buffers, leaf by leaf in the JAX tree's order
        ew = jax.tree_util.tree_leaves(ref["onebit_err_w"])
        es = jax.tree_util.tree_leaves(ref["onebit_err_s"])
        assert len(ew) == len(res["err_w"]) == len(es)
        for got, want in zip(res["err_w"] + res["err_s"], ew + es):
            want = want[rank].reshape(-1)
            np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4 * np.abs(want).max())
        assert max(np.abs(e).max() for e in res["err_w"]) > 0


def test_a_non_finite_step_leaves_the_error_buffers_untouched(onebit_run):
    """``freeze_step`` 0: step 1 is poisoned on rank 1 only; both ranks take
    the exact path (the flag is reduced by MIN), the update is skipped and
    the error buffers are those of step 0; step 2 compresses again."""
    for r in onebit_run["ranks"]:
        s = r["nan_compressed"]
        assert [x["compressed"] for x in s] == [True, False, True, True]
        assert [x["finite"] for x in s] == [True, False, True, True]
        assert [x["step"] for x in s] == [1, 1, 2, 3]
        assert s[1]["param_sum"] == s[0]["param_sum"] and s[2]["param_sum"] != s[1]["param_sum"]
        for a, b in zip(s[0]["err_w"] + s[0]["err_s"], s[1]["err_w"] + s[1]["err_s"]):
            assert np.isfinite(b).all() and np.array_equal(a, b)


def test_a_skipped_step_before_freeze_step_does_not_advance_the_switch(onebit_run):
    """``freeze_step`` 2 with step 1 poisoned: the switch reads the count of
    finite steps (the JAX engine's ``state["step"]``), so the skipped step
    does not count: steps 0-2 are exact and only step 3 compresses."""
    for r in onebit_run["ranks"]:
        s = r["nan_warmup"]
        assert [x["step"] for x in s] == [1, 1, 2, 3]
        assert [x["compressed"] for x in s] == [False, False, False, True]
        assert all(not np.any(e) for e in s[2]["err_w"] + s[2]["err_s"])

"""PyTorch port, ZeRO stages 0-3 at data-parallel world size 2 against the
JAX engine on two virtual devices.

Two gloo ranks (spawned processes sharing a ``FileStore`` under
``tmp_path``, so test workers never race for a port) run every case in one
process group: the tiny dense Mistral of ``tests/test_torch_engine.py``
(2 layers, fp32, the JAX engine's initial weights through
``models/convert.py``) trains 3 steps with gas 2 and clipping 1.0 at each
stage with the fused AdamW path (its plain version on the CPU), at stage 3
with the optax-equivalent AdamW and a ``loss_mask`` whose counts differ
between the ranks, and the block-sparse Llama at stage 2.
The reference is the JAX engine on
``build_mesh(MeshConfig(data=2), devices=jax.devices()[:2])`` given the
same global batch; rank r takes rows ``[r * micro, (r + 1) * micro)`` of
each global microbatch. The JAX engine's stages are one computation under
different shardings (its ``tests/test_engine_zero.py::test_stage_parity``),
so one JAX run at stage 3 is the reference of the port's four stages with
the fused AdamW, and each other case has its own JAX run at its stage.
Losses agree at rtol 2e-5 and the final gathered parameters at rtol 2e-4 /
atol 2e-6, the tolerances of ``tests/test_torch_engine.py``. The JAX
references run while the ranks do.

Also, in the ranks: ``gather(scatter(x)) == x`` for every group over the
real collectives, stage 3's gathers (nothing gathered outlives the
forward; the backward gathers again), a second stage-2 engine over the
same model, each rank's resident bytes of parameters, gradients and
moments per stage, and ``deepspeed_io``'s shards; and, in this process,
the partition's layout arithmetic, ``MeshConfig.resolve`` and the
refusals at world size >= 2, each naming its ROADMAP item.
"""

import gc
import os
import pickle
import weakref

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import TransformerLM, llama2_config, mistral_config
from deepspeed_tpu_torch.models.convert import params_from_jax, params_to_numpy
from deepspeed_tpu_torch.parallel.mesh import MeshConfig
from deepspeed_tpu_torch.runtime.zero.partition import ALIGN, FlatGroup

WORLD, MICRO, GAS, STEPS = 2, 2, 2, 3
TINY = dict(num_layers=2, hidden_size=64, num_heads=4, num_kv_heads=2, intermediate_size=128,
            vocab_size=256, max_seq_len=256, sliding_window=16)
SPARSE_TINY = dict(num_layers=2, hidden_size=64, num_heads=4, num_kv_heads=4,
                   intermediate_size=128, vocab_size=256, max_seq_len=64)
SPARSE_SA = {"mode": "fixed", "block": 16, "different_layout_per_head": True,
             "num_local_blocks": 2, "num_global_blocks": 1, "horizontal_global_attention": False,
             "num_different_global_patterns": 2, "attention": "unidirectional"}
# name -> (model, ZeRO stage, pallas_fused_adam, batch kind); REFERENCE: the
# case whose stage the JAX run of each case takes
CASES = {
    "stage0": ("dense", 0, "always", "ids"),
    "stage1": ("dense", 1, "always", "ids"),
    "stage2": ("dense", 2, "always", "ids"),
    "stage3": ("dense", 3, "always", "ids"),
    "stage3_mask": ("dense", 3, "never", "mask"),
    "sparse_stage2": ("sparse", 2, "always", "ids"),
}
REFERENCE = {name: "stage3" if name.startswith("stage") and CASES[name][2:] == ("always", "ids")
             else name for name in CASES}
TIMEOUT_S = 180


def _ds_config(stage, mode, **over):
    cfg = {"train_batch_size": MICRO * GAS * WORLD, "train_micro_batch_size_per_gpu": MICRO,
           "gradient_accumulation_steps": GAS,
           "optimizer": {"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.1}},
           "scheduler": {"type": "WarmupLR", "params": {"warmup_num_steps": 2,
                                                        "warmup_max_lr": 1e-3,
                                                        "warmup_type": "linear"}},
           "gradient_clipping": 1.0, "steps_per_print": 100, "zero_optimization": {"stage": stage},
           "tpu": {"pallas_fused_adam": mode, "mesh": {"data": WORLD}}}
    cfg.update(over)
    return cfg


def _global_batch(kind, step, seq):
    """The global batch of one step: GAS microbatches of MICRO * WORLD rows."""
    rng = np.random.default_rng(100 + step)
    n = MICRO * GAS * WORLD
    batch = {"input_ids": rng.integers(0, 256, size=(n, seq)).astype(np.int32)}
    if kind == "mask":
        # rank 0's rows keep about 90% of their tokens, rank 1's about 30%
        keep = np.where((np.arange(n) // MICRO) % WORLD == 0, 0.9, 0.3)[:, None]
        batch["loss_mask"] = (rng.random((n, seq)) < keep).astype(np.float32)
    return batch


def _rank_rows(batch, rank):
    """Rank ``rank``'s rows: ``[rank * MICRO, (rank + 1) * MICRO)`` of each
    global microbatch, gas-major."""
    return {k: v.reshape(GAS, WORLD, MICRO, *v.shape[1:])[:, rank].reshape(GAS * MICRO,
                                                                            *v.shape[1:])
            for k, v in batch.items()}


def _torch_model(kind, npp):
    if kind == "dense":
        cfg = mistral_config("tiny", dtype=torch.float32, attention_impl="reference", **TINY)
    else:
        cfg = llama2_config("tiny", dtype=torch.float32, sparse_attention=SPARSE_SA, **SPARSE_TINY)
    return TransformerLM(cfg, params_from_jax(npp, cfg, device="cpu", dtype=torch.float32,
                                              per_layer=True), trainable=True)


def _seq(kind):
    return 24 if kind == "dense" else 64


def _partition_round_trip(engine, rank):
    """gather(scatter(x)) == x for every group of the engine's partition,
    over the real collectives; and each group's shard size."""
    from deepspeed_tpu_torch import comm

    z = engine._zero
    ok, shards = [], []
    for i, fg in enumerate(z.groups):
        x = torch.from_numpy(np.random.default_rng(i).normal(size=fg.padded).astype(np.float32))
        shard = fg.shard_of(x, rank).clone()  # scatter: this rank's part
        full = torch.empty(fg.padded)
        comm.all_gather_into_tensor(full, shard, group=z.group)
        ok.append(bool(torch.equal(full, x)))
        shards.append((fg.numel, fg.shard, shard.numel()))
    return ok, shards


def _second_stage2_engine(engine, rank):
    """A second stage-2 engine over the trained engine's model takes a step
    from the model's current weights, both engines alive; once both are
    dropped, the model's own backward gives every parameter its gradient."""
    from deepspeed_tpu_torch import comm

    model = engine.module
    batch = _rank_rows(_global_batch("ids", STEPS, _seq("dense")), rank)
    ids = torch.from_numpy(batch["input_ids"])
    with torch.no_grad():  # the global mean at the weights the second engine starts from
        local = torch.stack([model.loss({"input_ids": ids[i * MICRO:(i + 1) * MICRO]})
                             for i in range(GAS)]).mean()
    want = float(comm.all_reduce(local, group=engine._zero.group)) / WORLD
    second, _, _, _ = deepspeed_tpu_torch.initialize(model=model, config=_ds_config(2, "always"))
    got = float(second.train_batch(batch))
    norm = float(second.get_global_grad_norm())
    sums = [float(t.double().square().sum()) for t in second.module_state_dict().values()]
    del engine, second
    gc.collect()
    model.loss({"input_ids": ids[:MICRO]}).backward()
    return {"loss": got, "want": want, "grad_norm": norm, "param_sums": sums,
            "own_backward_grads": all(p.grad is not None for p in model.parameters())}


def _stage3_regathers(engine, rank):
    """One more stage-3 forward and backward, counting the gathers: no
    gathered buffer outlives the forward (what autograd saved of it is
    gathered again), and the backward gathers every group it saved from."""
    from deepspeed_tpu_torch.runtime.zero import partition

    bufs, calls, real = [], [0], partition._gathered

    def counted(*args):
        calls[0] += 1
        out = real(*args)
        bufs.extend(weakref.ref(b) for b in out)
        return out

    batch = _rank_rows(_global_batch("ids", STEPS, _seq("dense")), rank)
    partition._gathered = counted
    try:
        loss = engine._loss_fn({"input_ids": torch.from_numpy(batch["input_ids"][:MICRO])})
        forward = calls[0]
        alive = sum(ref() is not None for ref in bufs)
        loss.backward()
        engine._zero.finish_backward()
    finally:
        partition._gathered = real
    return {"forward_gathers": forward, "alive_after_forward": alive,
            "backward_gathers": calls[0] - forward}


def _bf16_stages(rank, npp):
    """The dense model computing in bf16 at stages 2 and 3 (stage 3 gathers
    each shard cast to bf16 and its fp32 region apart, and again in the
    backward): {stage: (losses, final parameters, stage 3's gathers)}."""
    out = {}
    for stage in (2, 3):
        cfg = mistral_config("tiny", dtype=torch.bfloat16, attention_impl="reference", **TINY)
        model = TransformerLM(cfg, params_from_jax(npp, cfg, device="cpu", dtype=torch.float32,
                                                   per_layer=True), trainable=True)
        engine, _, _, _ = deepspeed_tpu_torch.initialize(model=model,
                                                         config=_ds_config(stage, "always"))
        losses = [float(engine.train_batch(_rank_rows(_global_batch("ids", step, _seq("dense")),
                                                      rank))) for step in range(STEPS)]
        params = {k: v.numpy() for k, v in engine.module_state_dict().items()}
        out[stage] = (losses, params, _stage3_regathers(engine, rank) if stage == 3 else None)
    return out


def _low_dtype_gathers(rank):
    """``_gathered`` in bf16 over the real collectives for a group whose
    fp32 region lies in rank 0's shard, one whose fp32 region spans both
    shards and one with no fp32 leaf: the fp32 leaves exact, the rest their
    bf16 cast."""
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.runtime.zero.partition import _gathered, _leaf_views

    ok = []
    for shapes, low in ((((8, 8), (3, ), (40, )), (True, False, True)),
                        (((4, ), (100, ), (2, 3)), (False, False, True)),
                        (((5, 7), (9, )), (True, True))):
        fg = FlatGroup("g", [(i, s, l) for i, (s, l) in enumerate(zip(shapes, low))], WORLD)
        rng = np.random.default_rng(len(shapes))
        ts = [torch.from_numpy(rng.normal(size=l.shape).astype(np.float32)) for l in fg.leaves]
        shard = fg.shard_of(fg.flatten(ts), rank).clone()
        got = _leaf_views(fg, _gathered(shard, fg, torch.bfloat16, None))
        ok.append([bool(torch.equal(g, t.to(torch.bfloat16) if l.low else t))
                   for g, t, l in zip(got, ts, fg.leaves)])
    comm.barrier()
    return ok


def _worker(rank, store, npps, out_dir):
    torch.set_num_threads(2)
    deepspeed_tpu_torch.init_distributed(dist_backend="gloo", init_method=f"file://{store}",
                                         rank=rank, world_size=WORLD, verbose=False)
    from deepspeed_tpu_torch import comm

    results = {}
    try:
        for name, (kind, stage, mode, batch_kind) in CASES.items():
            over = {"sparse_attention": SPARSE_SA} if kind == "sparse" else {}
            engine, _, _, _ = deepspeed_tpu_torch.initialize(
                model=_torch_model(kind, npps[kind]), config=_ds_config(stage, mode, **over))
            r = {"bytes_at_init": engine.zero_resident_bytes()}
            r["losses"] = [float(engine.train_batch(_rank_rows(
                _global_batch(batch_kind, step, _seq(kind)), rank))) for step in range(STEPS)]
            r["bytes"] = engine.zero_resident_bytes()
            r["params"] = {k: v.numpy() for k, v in engine.module_state_dict().items()}
            r["fused"] = engine._pallas_adam is not None
            if name == "stage2":
                r["second_engine"] = _second_stage2_engine(engine, rank)
            if name == "stage3":
                r["regather"] = _stage3_regathers(engine, rank)
                r["round_trip"] = _partition_round_trip(engine, rank)
                data = [{"input_ids": np.full(4, i, np.int32)} for i in range(10)]
                r["loader"] = [int(mb["input_ids"][j, 0]) for mb in engine.deepspeed_io(data)
                               for j in range(len(mb["input_ids"]))]
            partition = weakref.ref(engine._zero)
            del engine
            gc.collect()
            r["partition_released"] = partition() is None
            results[name] = r
        results["bf16"] = _bf16_stages(rank, npps["dense"])
        results["low_gathers"] = _low_dtype_gathers(rank)
    finally:
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(results, f)
        comm.destroy_process_group()


def _jax_engine(kind, stage, mode, batch_kind):
    """The JAX engine of a case on two virtual devices, untrained."""
    import jax
    import jax.numpy as jnp

    import deepspeed_tpu
    from deepspeed_tpu.models import TransformerLM as JaxLM
    from deepspeed_tpu.models import llama2_config as jax_llama2_config
    from deepspeed_tpu.models import mistral_config as jax_mistral_config
    from deepspeed_tpu.parallel import groups as jax_groups
    from deepspeed_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
    from deepspeed_tpu.parallel.mesh import build_mesh

    jax_groups.reset()
    if kind == "dense":
        jcfg = jax_mistral_config("tiny", dtype=jnp.float32, attention_impl="reference", **TINY)
        over = {}
    else:
        jcfg = jax_llama2_config("tiny", dtype=jnp.float32, attention_impl="reference",
                                 sparse_attention=SPARSE_SA, **SPARSE_TINY)
        over = {"sparse_attention": SPARSE_SA}
    mesh = build_mesh(JaxMeshConfig(data=WORLD), devices=jax.devices()[:WORLD])
    je, _, _, _ = deepspeed_tpu.initialize(model=JaxLM(jcfg),
                                           config=_ds_config(stage, mode, **over), mesh=mesh)
    return je


def _jax_train(je, kind, batch_kind):
    """(losses, final parameters) of the JAX engine ``je`` over the case's
    batches."""
    import jax

    losses = [float(je.train_batch(_global_batch(batch_kind, step, _seq(kind))))
              for step in range(STEPS)]
    return losses, jax.tree.map(np.asarray, je.state["params"])


@pytest.fixture(scope="module")
def zero_run(tmp_path_factory):
    """The ranks' results and the JAX references: {case: (rank results,
    (reference losses, reference params))}."""
    import jax
    from concurrent.futures import ThreadPoolExecutor

    tmp = tmp_path_factory.mktemp("zero")
    engines = {name: _jax_engine(*CASES[name]) for name in sorted(set(REFERENCE.values()))}
    npps = {CASES[name][0]: jax.tree.map(np.asarray, engines[name].state["params"])  # initial
            for name in ("stage3", "sparse_stage2")}                                   # weights
    ctx = mp.start_processes(_worker, args=(str(tmp / "store"), npps, str(tmp)), nprocs=WORLD,
                             join=False, start_method="spawn")
    try:  # the JAX engines compile and train in threads, beside the ranks
        with ThreadPoolExecutor(len(engines)) as ex:
            futures = {name: ex.submit(_jax_train, je, CASES[name][0], CASES[name][3])
                       for name, je in engines.items()}
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
    out = {name: ([rk[name] for rk in ranks], refs[REFERENCE[name]]) for name in CASES}
    out.update({key: [rk[key] for rk in ranks] for key in ("bf16", "low_gathers")})
    return out


def _assert_params_close(ours, ref, kind):
    cfg = (mistral_config("tiny", dtype=torch.float32, **TINY) if kind == "dense" else
           llama2_config("tiny", dtype=torch.float32, sparse_attention=SPARSE_SA, **SPARSE_TINY))
    tree = {}
    for name, v in ours.items():  # "tree.<group>.<name>" / "tree.blocks.<l>.<name>"
        parts = name.split(".")[1:]
        if parts[0] == "blocks":
            tree.setdefault("blocks", [dict() for _ in range(cfg.num_layers)])
            tree["blocks"][int(parts[1])][parts[2]] = torch.from_numpy(v)
        else:
            tree.setdefault(parts[0], {})[parts[1]] = torch.from_numpy(v)
    got = params_to_numpy(tree)
    for group in ref:
        for leaf in ref[group]:
            np.testing.assert_allclose(got[group][leaf], ref[group][leaf], rtol=2e-4, atol=2e-6,
                                       err_msg=f"{group}/{leaf}")


@pytest.mark.parametrize("name", list(CASES))
def test_two_gloo_ranks_match_the_jax_engine_on_two_devices(zero_run, name):
    ranks, (ref_losses, ref_params) = zero_run[name]
    kind, stage, mode, _ = CASES[name]
    for r in ranks:
        assert r["fused"] == (mode == "always")
        np.testing.assert_allclose(r["losses"], ref_losses, rtol=2e-5)
        _assert_params_close(r["params"], ref_params, kind)
    assert ranks[0]["losses"] == ranks[1]["losses"]  # the global mean, on every rank


@pytest.mark.parametrize("name", list(CASES))
def test_a_dropped_engine_releases_its_partition(zero_run, name):
    """Nothing outside the engine (the stage-2 hooks on the model's
    parameters included) keeps its buffers alive once it is dropped."""
    assert all(r["partition_released"] for r in zero_run[name][0])


def test_a_second_stage2_engine_over_the_same_model_trains(zero_run):
    """The newest partition over a model owns its stage-2 hooks: a second
    engine's step starts from the model's weights and reduces real
    gradients (both ranks end equal), and once the engines are dropped the
    model's own backward runs through no hook of theirs."""
    ranks = zero_run["stage2"][0]
    for r in ranks:
        s = r["second_engine"]
        np.testing.assert_allclose(s["loss"], s["want"], rtol=2e-5)
        assert np.isfinite(s["grad_norm"]) and s["grad_norm"] > 0
        assert s["own_backward_grads"]
    assert ranks[0]["second_engine"]["param_sums"] == ranks[1]["second_engine"]["param_sums"]


def test_stage3_gathers_again_in_the_backward(zero_run):
    """No rank keeps a gathered group past the forward: autograd saves each
    gathered weight as its place in the group, and the backward gathers the
    head and every block again (the embedding's lookup saves only ids)."""
    for r in zero_run["stage3"][0]:
        g = r["regather"]
        assert g["forward_gathers"] == 2 + TINY["num_layers"]
        assert g["alive_after_forward"] == 0
        assert g["backward_gathers"] == 1 + TINY["num_layers"]


def test_stage3_in_bf16_matches_stage2(zero_run):
    """Computing in bf16, stage 3 (each shard cast, then gathered; the fp32
    leaves gathered apart; gathered again in the backward) takes the same
    steps as stage 2 (the full fp32 masters cast where they are used)."""
    for r in zero_run["bf16"]:
        (l2, p2, _), (l3, p3, gathers) = r[2], r[3]
        np.testing.assert_allclose(l3, l2, rtol=1e-6)
        for k in p2:
            np.testing.assert_allclose(p3[k], p2[k], rtol=1e-6, atol=1e-8, err_msg=k)
        assert gathers["alive_after_forward"] == 0
        assert gathers["backward_gathers"] == 1 + TINY["num_layers"]


def test_low_dtype_gathers_keep_the_fp32_leaves_exact(zero_run):
    for r in zero_run["low_gathers"]:
        assert [all(group) for group in r] == [True, True, True]


def test_unequal_mask_counts_take_the_global_mean(zero_run):
    """The reference's loss is the masked mean over the global microbatch;
    the mean of the ranks' masked means is another number here."""
    (r0, _), (ref_losses, _) = zero_run["stage3_mask"]
    batch = _global_batch("mask", 0, _seq("dense"))
    counts = [_rank_rows(batch, r)["loss_mask"][:, 1:].sum() for r in range(WORLD)]
    assert counts[0] > 2 * counts[1]
    np.testing.assert_allclose(r0["losses"][0], ref_losses[0], rtol=2e-5)


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_resident_bytes_follow_the_stage(zero_run, stage):
    """At world size 2, against stage 0: moments halve from stage 1, grads
    too from stage 2, params too at stage 3 (the shards of one padded layout,
    so exactly half; stage 0's buffers exceed the parameters by each group's
    padding only)."""
    base = zero_run["stage0"][0][0]["bytes"]
    n_params = sum(v.size for v in zero_run["stage0"][0][0]["params"].values())
    n_groups, n_leaves = 2 + TINY["num_layers"], len(zero_run["stage0"][0][0]["params"])
    assert 4 * n_params <= base["params"] <= 4 * (n_params + (n_leaves + n_groups * WORLD) * ALIGN)
    assert base["grads"] == base["params"] and base["moments"] == 2 * base["params"]
    for r in zero_run[f"stage{stage}"][0]:
        halved = {"moments": stage >= 1, "grads": stage >= 2, "params": stage >= 3}
        assert r["bytes"] == {k: base[k] // 2 if half else base[k] for k, half in halved.items()}


def test_gather_of_scatter_is_every_group_on_two_ranks(zero_run):
    for rank, r in enumerate(zero_run["stage3"][0]):
        ok, shards = r["round_trip"]
        assert len(ok) == 2 + TINY["num_layers"] and all(ok)
        for numel, shard, held in shards:
            assert held == shard == -(-(-(-numel // WORLD)) // ALIGN) * ALIGN


def test_deepspeed_io_shards_are_disjoint_and_cover(zero_run):
    seen = [r["loader"] for r in zero_run["stage3"][0]]
    assert not set(seen[0]) & set(seen[1])
    assert sorted(seen[0] + seen[1]) == list(range(10))


# ---------------------------------------------------------------------------
# in this process: layout, mesh, refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", [1, 2, 3, 8])
def test_flat_group_layout_round_trips(world):
    shapes = [(5, 7), (3, ), (64, 16), (1, ), (33, )]
    low = [True, False, True, False, True]
    entries = [(f"leaf{i}", s, l) for i, (s, l) in enumerate(zip(shapes, low))]
    fg = FlatGroup("g", entries, world)
    assert [l.low for l in fg.leaves] == sorted(low)  # the fp32 leaves first
    assert fg.n_keep == [l.offset for l in fg.leaves if l.low][0]
    assert all(l.offset % ALIGN == 0 for l in fg.leaves)
    assert fg.shard % ALIGN == 0 and fg.padded == world * fg.shard >= fg.numel
    assert fg.shard == -(-(-(-fg.numel // world)) // ALIGN) * ALIGN
    rng = np.random.default_rng(world)
    ts = [torch.from_numpy(rng.normal(size=l.shape).astype(np.float32)) for l in fg.leaves]
    flat = fg.flatten(ts)
    shards = [fg.shard_of(flat, r).clone() for r in range(world)]
    assert sum(s.numel() for s in shards) == fg.padded
    back = fg.views(torch.cat(shards))
    assert all(torch.equal(a, b) for a, b in zip(back, ts))


@pytest.mark.parametrize("mesh,n,want", [
    ({}, 4, {"data": 4}), ({"data": 2}, 2, {"data": 2}), ({"data": -1}, 8, {"data": 8}),
    ({"data": -1, "model": 2}, 8, {"data": 4, "model": 2}),
])
def test_mesh_config_resolve(mesh, n, want):
    sizes = MeshConfig(**mesh).resolve(n)
    assert {k: v for k, v in sizes.items() if v != 1} == want


@pytest.mark.parametrize("mesh,n", [({"data": 3}, 2), ({"data": -1, "seq": -1}, 4),
                                    ({"data": -1, "model": 3}, 8)])
def test_mesh_config_resolve_rejects_what_does_not_tile(mesh, n):
    with pytest.raises(ValueError):
        MeshConfig(**mesh).resolve(n)


@pytest.mark.parametrize("axis,item", [("model", "A3b"), ("pipe", "A6.8"), ("seq", "A8"),
                                       ("expert", "A3"), ("data_repl", "MiCS")])
def test_non_data_mesh_axes_are_refused_naming_their_item(axis, item):
    with pytest.raises(NotImplementedError, match=item):
        deepspeed_tpu_torch.DeepSpeedConfig({"train_batch_size": 2,
                                             "tpu": {"mesh": {"data": 2, axis: 2}}})
    cfg = deepspeed_tpu_torch.DeepSpeedConfig({"train_batch_size": 2,
                                               "tpu": {"mesh": {"data": -1}}})
    assert cfg.tpu_config.mesh_config().resolve(4)["data"] == 4


def test_mesh_axis_order_is_not_a_mesh_key():
    """The port builds a one-axis ``data`` mesh: a key it would not read is
    refused, not ignored."""
    with pytest.raises(deepspeed_tpu_torch.DeepSpeedConfigError,
                       match="axis_order"):
        deepspeed_tpu_torch.DeepSpeedConfig({"train_batch_size": 2, "tpu": {"mesh": {
            "data": 2, "axis_order": ["pipe", "data_repl", "data", "seq", "model"]}}})


def test_moe_and_hybrid_are_refused_at_world_size_two(monkeypatch):
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.parallel import groups

    monkeypatch.setattr(groups, "initialize_mesh", lambda *a, **k: None)
    monkeypatch.setattr(groups, "get_data_parallel_world_size", lambda: 2)
    moe = TransformerLM(mistral_config("tiny", dtype=torch.float32, moe_num_experts=4, **TINY),
                        device="cpu", trainable=True)
    with pytest.raises(NotImplementedError, match="A3"):
        deepspeed_tpu_torch.initialize(model=moe, config={"train_batch_size": 4})
    monkeypatch.setattr(comm, "get_world_size", lambda group=None: 2)
    dense = TransformerLM(mistral_config("tiny", dtype=torch.float32, **TINY), device="cpu",
                          trainable=True)
    with pytest.raises(NotImplementedError, match="hybrid engine at world size 2.*A1"):
        deepspeed_tpu_torch.initialize(model=dense, config={
            "train_batch_size": 4, "hybrid_engine": {"enabled": True}})


def test_world_size_one_builds_no_partition():
    """At world size 1 the engine adds no collective and no copy: no ZeRO
    partition, the optimizer on the model's own parameters."""
    model = TransformerLM(mistral_config("tiny", dtype=torch.float32, **TINY), device="cpu",
                          trainable=True)
    ptrs = [p.data_ptr() for p in model.parameters()]
    engine, _, _, _ = deepspeed_tpu_torch.initialize(model=model, config=_ds_config(
        3, "always", train_batch_size=MICRO * GAS, tpu={"pallas_fused_adam": "always"}))
    assert engine._zero is None and engine.dp_world_size == 1
    assert [p.data_ptr() for p in engine.optimizer.flat_params()] == ptrs

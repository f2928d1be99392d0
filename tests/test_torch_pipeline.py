"""PyTorch port: pipeline parallelism (``runtime/pipe``, ``parallel/topology.py``)
against the JAX package on the CPU.

In this process: ``TrainSchedule`` / ``InferenceSchedule`` /
``DataParallelSchedule`` yield the JAX package's instruction streams for
several (microbatches, stages, stage); the port's ``FillDrainSchedule``
(``pipeline.schedule: "gpipe"``) and ``TrainSchedule`` put every send in the
same step as its receive; ``partition_uniform`` / ``partition_balanced``,
``PipelineModule`` and the topology getters equal the JAX ones; and the
refusals (ZeRO stage 2, a model without stages, the noisy MoE gate, layers
the stages do not divide, pipe x model, ``pipeline.stages`` other than the
pipe axis), over a fake process group; a stage drawn alone from a seed
(``TransformerLM(pipe_stage=...)``) holds the whole model's values.

Two spawned gloo worlds train the tiny Mistral (4 layers, fp32, the JAX
engine's initial weights through ``models/convert.py``) 3 steps with gas 4,
clipping 1.0, ``tests/test_torch_zero.py``'s warmup schedule (the first,
sign-like AdamW update at lr 0) and the fused AdamW path (its plain
version on the CPU), each
case against the JAX engine at the same mesh on virtual devices given the
same global batch (rank r of a data group takes rows ``[r * micro, (r + 1)
* micro)`` of each global microbatch): losses at rtol 2e-5, the gathered
parameters (``module_state_dict()``, on every rank) at rtol 2e-4 / atol
2e-6, the tolerances of ``tests/test_torch_zero.py``.

- Two ranks, ``pipe`` 2: 1F1B and GPipe (both against one JAX run: the two
  schedules are one computation, ``tests/test_pipeline.py::
  test_1f1b_matches_gpipe``), a MoE model (4 experts, top-2, einsum; gating
  without draws, as the JAX stage function runs it), and a tied-embedding
  model (its embedding on both end stages, the gradients summed), held to
  the JAX engine and also to the port at world size 1 in this process on
  the same weights and batch. A case whose ranks each draw their stage
  alone from a seed is held to the whole model drawn from it at world size
  1. 1F1B keeps at most ``TrainSchedule.num_pipe_buffers()`` microbatches'
  boundary activations alive on a stage, GPipe all M; the eager ``forward``
  raises, naming ``train_batch``.
- Four ranks: ``pipe`` 2 x ``data`` 2 at ZeRO stage 1, 1F1B and GPipe, with
  a ``loss_mask`` whose counts differ between the data ranks (each
  microbatch's loss is the masked mean over the global microbatch); and the
  tied model at ``pipe`` 4, one layer a stage (the two stages between the
  ends do not hold the embedding).
"""

import os
import pickle

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import TransformerLM, mistral_config, params_from_jax
from deepspeed_tpu_torch.parallel import topology as tt
from deepspeed_tpu_torch.runtime import pipe as tp

MICRO, GAS, STEPS, SEQ = 2, 4, 3, 24
TINY = dict(num_layers=4, hidden_size=64, num_heads=4, num_kv_heads=2, intermediate_size=128,
            vocab_size=256, max_seq_len=256, sliding_window=16)
MOE = dict(moe_num_experts=4, moe_top_k=2)
# name -> (pipe, data, schedule, model kind, batch kind, the run it is held to: a JAX
# engine's, or SEEDED's, the port's at world size 1)
CASES = {
    "1f1b": (2, 1, "1f1b", "dense", "ids", "dense"),
    "gpipe": (2, 1, "gpipe", "dense", "ids", "dense"),
    "tied": (2, 1, "1f1b", "tied", "ids", "tied"),
    "moe": (2, 1, "gpipe", "moe", "ids", "moe"),
    "seeded": (2, 1, "1f1b", "dense", "ids", "seeded"),
    "dp_1f1b": (2, 2, "1f1b", "dense", "mask", "dp"),
    "dp_gpipe": (2, 2, "gpipe", "dense", "mask", "dp"),
    "tied4": (4, 1, "1f1b", "tied", "ids", "tied4"),
}
# the ranks build their stage alone from this seed (TransformerLM(pipe_stage=...)),
# held to the whole model built from it at world size 1 in this process
SEEDED = {"seeded": 7}
TIMEOUT_S = 180


def _model_over(kind):
    return {"tied": dict(tie_embeddings=True), "moe": MOE}.get(kind, {})


def _ds_config(pipe, data, schedule, **over):
    cfg = {"train_batch_size": MICRO * GAS * data, "train_micro_batch_size_per_gpu": MICRO,
           "gradient_accumulation_steps": GAS,
           "optimizer": {"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.1}},
           "scheduler": {"type": "WarmupLR", "params": {"warmup_num_steps": 2,
                                                        "warmup_max_lr": 1e-3,
                                                        "warmup_type": "linear"}},
           "gradient_clipping": 1.0, "steps_per_print": 100, "zero_optimization": {"stage": 1},
           "pipeline": {"schedule": schedule},
           "tpu": {"pallas_fused_adam": "always", "mesh": {"pipe": pipe, "data": data}}}
    cfg.update(over)
    return cfg


def _global_batch(kind, step, data):
    rng = np.random.default_rng(300 + step)
    n = MICRO * GAS * data
    batch = {"input_ids": rng.integers(0, 256, size=(n, SEQ)).astype(np.int32)}
    if kind == "mask":  # data rank 0's rows keep about 90% of their tokens, rank 1's 30%
        keep = np.where((np.arange(n) // MICRO) % data == 0, 0.9, 0.3)[:, None]
        batch["loss_mask"] = (rng.random((n, SEQ)) < keep).astype(np.float32)
    return batch


def _rank_rows(batch, rank, data):
    return {k: v.reshape(GAS, data, MICRO, *v.shape[1:])[:, rank].reshape(GAS * MICRO,
                                                                           *v.shape[1:])
            for k, v in batch.items()}


def _torch_cfg(kind):
    return mistral_config("tiny", dtype=torch.float32, attention_impl="reference", **TINY,
                          **_model_over(kind))


def _torch_model(kind, npp):
    cfg = _torch_cfg(kind)
    return TransformerLM(cfg, params_from_jax(npp, cfg, device="cpu", dtype=torch.float32,
                                              per_layer=True), trainable=True)


def _worker(rank, world, store, names, out_dir):
    torch.set_num_threads(1)
    with open(os.path.join(out_dir, "..", "npps.pkl"), "rb") as f:
        npps = pickle.load(f)
    deepspeed_tpu_torch.init_distributed(dist_backend="gloo", init_method=f"file://{store}",
                                         rank=rank, world_size=world, verbose=False)
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.parallel import groups
    from deepspeed_tpu_torch.parallel.mesh import MeshConfig

    results = {}
    try:
        for name in names:
            pipe, data, schedule, kind, batch_kind, ref = CASES[name]
            if name in SEEDED:  # this rank's stage alone, as a user builds it on the mesh
                groups.initialize_mesh(MeshConfig(pipe=pipe, data=data), "cpu")
                model = TransformerLM(_torch_cfg(kind), device="cpu", trainable=True,
                                      seed=SEEDED[name],
                                      pipe_stage=(groups.get_pipe_parallel_rank(), pipe))
            else:
                model = _torch_model(kind, npps[ref])
            held = sorted(n for n, p in model.named_parameters() if p.numel())
            engine, _, _, _ = deepspeed_tpu_torch.initialize(
                model=model, config=_ds_config(pipe, data, schedule))
            r = {"losses": [float(engine.train_batch(_rank_rows(
                _global_batch(batch_kind, step, data), engine.dp_rank, data)))
                for step in range(STEPS)]}
            r["params"] = {k: v.numpy().copy() for k, v in engine.module_state_dict().items()}
            ex = engine._pipe
            r.update(stage=ex.stage_id, max_live=ex.max_live, fused=engine._pallas_adam is not None,
                     buffers=tp.TrainSchedule(GAS, pipe, ex.stage_id).num_pipe_buffers(),
                     owned=sorted(n for n, p in engine.module.named_parameters()
                                  if p.requires_grad),
                     held=held,
                     norm=float(engine.get_global_grad_norm()))
            if name == "1f1b":
                try:
                    engine.forward({"input_ids": np.zeros((MICRO, SEQ), np.int32)})
                    r["eager"] = None
                except RuntimeError as e:
                    r["eager"] = str(e)
            results[name] = r
    finally:
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(results, f)
        comm.destroy_process_group()


def _jax_engine(ref):
    import jax
    import jax.numpy as jnp

    import deepspeed_tpu
    from deepspeed_tpu.models import TransformerLM as JaxLM
    from deepspeed_tpu.models import mistral_config as jax_mistral_config
    from deepspeed_tpu.parallel import groups as jax_groups
    from deepspeed_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
    from deepspeed_tpu.parallel.mesh import build_mesh

    name = next(n for n, c in CASES.items() if c[5] == ref)
    pipe, data, schedule, kind, _, _ = CASES[name]
    jax_groups.reset()
    jcfg = jax_mistral_config("tiny", dtype=jnp.float32, attention_impl="reference", **TINY,
                              **_model_over(kind))
    mesh = build_mesh(JaxMeshConfig(pipe=pipe, data=data), devices=jax.devices()[:pipe * data])
    je, _, _, _ = deepspeed_tpu.initialize(model=JaxLM(jcfg),
                                           config=_ds_config(pipe, data, "1f1b"), mesh=mesh)
    return je


def _jax_train(je, ref):
    import jax

    name = next(n for n, c in CASES.items() if c[5] == ref)
    _, data, _, _, batch_kind, _ = CASES[name]
    losses = [float(je.train_batch(_global_batch(batch_kind, step, data)))
              for step in range(STEPS)]
    return losses, jax.tree.map(np.asarray, je.state["params"])


def _spawn(world, names, tmp):
    out = tmp / f"world{world}"
    out.mkdir()
    return mp.start_processes(_worker, args=(world, str(out / "store"), names, str(out)),
                              nprocs=world, join=False, start_method="spawn"), out


def _world1(name, npp=None):
    """Case ``name`` at world size 1 in this process on the global batch
    (micro ``MICRO``, the same microbatches), on the JAX weights ``npp`` or,
    for a SEEDED case, the whole model drawn from its seed: (losses, final
    parameters)."""
    pipe, data, _, kind, batch_kind, _ = CASES[name]
    model = (TransformerLM(_torch_cfg(kind), device="cpu", trainable=True, seed=SEEDED[name])
             if npp is None else _torch_model(kind, npp))
    engine, _, _, _ = deepspeed_tpu_torch.initialize(
        model=model, config=_ds_config(pipe, data, "1f1b", tpu={"pallas_fused_adam": "always"}))
    losses = [float(engine.train_batch(_global_batch(batch_kind, step, data)))
              for step in range(STEPS)]
    return losses, {k: v.detach().numpy().copy() for k, v in engine.module_state_dict().items()}


@pytest.fixture(scope="module")
def pipe_run(tmp_path_factory):
    """{case: ([each rank's results], (reference losses, reference params))},
    and under ``"tied@1"`` the tied case's world-size-1 run of the port."""
    import jax
    from concurrent.futures import ThreadPoolExecutor

    tmp = tmp_path_factory.mktemp("pipe")
    refs = sorted({c[5] for c in CASES.values()} - set(SEEDED))
    # one at a time: initialize sets the JAX package's global mesh
    engines = {ref: _jax_engine(ref) for ref in refs}
    npps = {ref: jax.tree.map(np.asarray, je.state["params"]) for ref, je in engines.items()}
    with open(tmp / "npps.pkl", "wb") as f:  # read by the ranks, which then start together
        pickle.dump(npps, f)
    worlds = [_spawn(2, [n for n, c in CASES.items() if c[0] * c[1] == 2], tmp),
              _spawn(4, [n for n, c in CASES.items() if c[0] * c[1] == 4], tmp)]
    try:  # the JAX engines train in threads, beside the ranks
        with ThreadPoolExecutor(len(engines)) as ex:
            futures = {ref: ex.submit(_jax_train, je, ref) for ref, je in engines.items()}
            results = {name: _world1(name) for name in SEEDED}
            results["tied@1"] = _world1("tied", npps["tied"])
            results.update({ref: f.result() for ref, f in futures.items()})
    finally:
        alive = []
        for ctx, _ in worlds:
            for p in ctx.processes:
                p.join(TIMEOUT_S)
            alive += [p.pid for p in ctx.processes if p.is_alive()]
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
    assert not alive, f"ranks {alive} still running after {TIMEOUT_S} s"
    for ctx, _ in worlds:
        assert all(p.exitcode == 0 for p in ctx.processes), [p.exitcode for p in ctx.processes]
    ranks = {}
    for ctx, out in worlds:
        for r in range(len(ctx.processes)):
            with open(out / f"rank{r}.pkl", "rb") as f:
                for name, res in pickle.load(f).items():
                    ranks.setdefault(name, []).append(res)
    out = {name: (ranks[name], results[c[5]]) for name, c in CASES.items()}
    out["tied@1"] = (ranks["tied"], results["tied@1"])
    return out


# ---------------------------------------------------------------------------
# in this process
# ---------------------------------------------------------------------------

def _stream(sched):
    return [[repr(c) for c in cmds] for cmds in sched]


@pytest.mark.parametrize("cls", ["TrainSchedule", "InferenceSchedule", "DataParallelSchedule"])
@pytest.mark.parametrize("micro_batches,stages", [(1, 2), (4, 2), (3, 3), (8, 4), (2, 4)])
def test_schedules_yield_the_jax_instruction_streams(cls, micro_batches, stages):
    from deepspeed_tpu.runtime.pipe import schedule as js

    for stage in range(stages):
        want = getattr(js, cls)(micro_batches, stages, stage)
        got = getattr(tp, cls)(micro_batches, stages, stage)
        assert _stream(got) == _stream(want), (cls, micro_batches, stages, stage)
        assert got.num_pipe_buffers() == want.num_pipe_buffers()


@pytest.mark.parametrize("cls", ["TrainSchedule", "FillDrainSchedule"])
@pytest.mark.parametrize("micro_batches,stages", [(1, 2), (4, 2), (3, 3), (8, 4), (2, 4)])
def test_every_send_falls_in_its_receive_step(cls, micro_batches, stages):
    """The executor issues a step's sends and receives together, so a
    schedule must put each send in the step of its receive; every stage
    runs each microbatch's forward and backward once, GPipe all forwards
    first."""
    streams = [_stream(getattr(tp, cls)(micro_batches, stages, s)) for s in range(stages)]

    def steps(stage, kind):
        return [t for t, cmds in enumerate(streams[stage]) for c in cmds if c.startswith(kind)]

    for s in range(stages - 1):
        assert steps(s, "SendActivation") == steps(s + 1, "RecvActivation")
        assert steps(s + 1, "SendGrad") == steps(s, "RecvGrad")
    for s in range(stages):
        fwd, bwd = steps(s, "ForwardPass"), steps(s, "BackwardPass")
        assert len(fwd) == len(bwd) == micro_batches
        if cls == "FillDrainSchedule":
            assert max(fwd) < min(bwd)
        assert streams[s][-1][-3:] == ["ReduceTiedGrads", "ReduceGrads", "OptimizerStep"]


@pytest.mark.parametrize("n,parts", [(8, 4), (10, 4), (4, 4), (3, 5), (32, 3)])
def test_partition_uniform_matches_jax(n, parts):
    from deepspeed_tpu.runtime.pipe.module import partition_uniform

    assert tp.partition_uniform(n, parts) == partition_uniform(n, parts)


@pytest.mark.parametrize("weights,parts", [([1, 1, 1, 1], 2), ([10, 1, 1, 1], 2),
                                           ([3, 1, 4, 1, 5, 9, 2, 6], 3), ([1, 2], 4),
                                           ([5, 5, 5, 1, 1, 1, 1, 1], 4)])
def test_partition_balanced_matches_jax(weights, parts):
    from deepspeed_tpu.runtime.pipe.module import partition_balanced

    assert tp.partition_balanced(weights, parts) == partition_balanced(weights, parts)


def test_pipeline_module_and_topology_match_jax():
    """``PipelineModule`` over torch layers (its parameter counts from the
    built ``nn.Module``s) and the topology classes' getters equal the JAX
    package's."""
    from deepspeed_tpu.parallel import topology as jt
    from deepspeed_tpu.runtime.pipe import PipelineModule as JaxPipelineModule

    sizes = [4, 4, 16, 16, 2, 8, 8, 32]
    specs = [tp.LayerSpec(torch.nn.Linear, n, 3) for n in sizes]
    pm = tp.PipelineModule(specs, num_stages=3, partition_method="parameters")
    counts = [4 * n + 3 for n in sizes]

    class _Counted:
        def __init__(self, n):
            self.param_count = n

    jpm = JaxPipelineModule([_Counted(c) for c in counts], num_stages=3)
    assert pm.parts == jpm.parts and pm.num_layers_per_stage() == jpm.num_layers_per_stage()
    assert all(isinstance(m, torch.nn.Linear) for m in pm.stage_layers(1))
    assert tp.PipelineModule(specs, num_stages=4, partition_method="uniform").parts == \
        [0, 2, 4, 6, 8]
    from deepspeed_tpu_torch import pipe as pipe_ns

    assert pipe_ns.PipelineModule is tp.PipelineModule and deepspeed_tpu_torch.PipelineModule \
        is tp.PipelineModule and deepspeed_tpu_torch.pipe is pipe_ns
    for ours, theirs in ((tt.PipeDataParallelTopology(2, 3), jt.PipeDataParallelTopology(2, 3)),
                         (tt.PipeModelDataParallelTopology(2, 2, 2),
                          jt.PipeModelDataParallelTopology(2, 2, 2))):
        assert ours.mapping == theirs.mapping and ours.get_axis_names() == theirs.get_axis_names()
        for axis in ours.get_axis_names():
            assert ours.get_axis_comm_lists(axis) == theirs.get_axis_comm_lists(axis)
            assert ours.get_dim(axis) == theirs.get_dim(axis)
        for rank in range(ours.world_size()):
            assert ours.get_coord(rank) == theirs.get_coord(rank)
            assert ours.get_rank_repr(rank) == theirs.get_rank_repr(rank)
            g, h = tt.PipelineParallelGrid(ours, rank), jt.PipelineParallelGrid(theirs, rank)
            assert (g.get_stage_id(), g.get_data_parallel_id(), g.is_first_stage(),
                    g.is_last_stage(), g.stage_to_global(1)) == (
                h.get_stage_id(), h.get_data_parallel_id(), h.is_first_stage(),
                h.is_last_stage(), h.stage_to_global(1))
        assert ours.filter_match(pipe=1) == theirs.filter_match(pipe=1)


@pytest.mark.parametrize("kind,stages", [("dense", 2), ("tied", 4), ("moe", 2)])
def test_a_stage_drawn_from_a_seed_holds_the_whole_models_values(kind, stages):
    """``TransformerLM(..., pipe_stage=(s, P))`` holds stage s's parameters
    with the values of the whole model drawn from the same seed, and every
    other parameter empty; ``whole_shapes`` gives the whole model's shapes."""
    cfg = _torch_cfg(kind)
    whole = dict(TransformerLM(cfg, device="cpu", trainable=True, seed=5).named_parameters())
    for s in range(stages):
        model = TransformerLM(cfg, device="cpu", trainable=True, seed=5, pipe_stage=(s, stages))
        stage = model.pipeline_stage(s, stages)
        mine = {n for n, _ in stage.named_parameters()}
        assert mine == {n for n, _ in TransformerLM(
            cfg, device="cpu", trainable=True, seed=5).pipeline_stage(s, stages).named_parameters()}
        for n, p in model.named_parameters():
            if n in mine:
                assert torch.equal(p, whole[n]), (s, n)
            else:
                assert p.numel() == 0, (s, n)
        assert stage.whole_shapes() == {n: tuple(p.shape) for n, p in whole.items()}
        assert list(stage.whole_shapes()) == list(whole)
    with pytest.raises(ValueError, match=f"not a stage of {stages + 1}"):
        model.pipeline_stage(0, stages + 1)


@pytest.mark.parametrize("over,model_over,match", [
    ({"zero_optimization": {"stage": 2}}, {}, "ZeRO stage <= 1"),
    ({}, {"moe_num_experts": 4, "moe_noisy_gate_policy": "Jitter"}, "moe_noisy_gate_policy"),
    ({}, {"num_layers": 3}, "must divide evenly into 2 pipeline stages"),
    ({}, "loss_fn", "pipeline_stage"),
    ({"tpu": {"mesh": {"pipe": 2, "model": 2}}}, {}, "A6.8, left open: pipe × model"),
    ({"pipeline": {"stages": 4}}, {}, "pipeline.stages=4: the stages are the mesh's pipe axis"),
])
def test_pipeline_refusals(over, model_over, match):
    """What the JAX engine asserts under a pipe (``engine.py:176-198``,
    ``transformer.py:967-972,1057``), pipe x model (3D, ROADMAP A6.8, left
    open), and ``pipeline.stages`` other than the mesh's pipe size, each raising before any collective (a fake process group
    of the mesh's size)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    config = dict(_ds_config(2, 1, "1f1b"), **over)
    if model_over == "loss_fn":
        model = lambda params, batch: params["w"].sum()  # noqa: E731
        kw = {"model_parameters": {"w": torch.ones(2)}}
    else:
        model = TransformerLM(mistral_config("tiny", dtype=torch.float32,
                                             **dict(TINY, **model_over)),
                              device="cpu", trainable=True)
        kw = {}
    world = 4 if "model" in config["tpu"]["mesh"] else 2
    dist.init_process_group("fake", rank=0, world_size=world, store=FakeStore())
    try:
        with pytest.raises((ValueError, NotImplementedError), match=match):
            deepspeed_tpu_torch.initialize(model=model, config=config, **kw)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the gloo worlds
# ---------------------------------------------------------------------------

def _assert_params_close(ours, ref, name):
    if name in SEEDED or name == "tied@1":  # the world-size-1 port's state dict
        assert set(ours) == set(ref)
        for key, v in ours.items():
            np.testing.assert_allclose(v, ref[key], rtol=2e-4, atol=2e-6, err_msg=f"{name}: {key}")
        return
    for key, v in ours.items():
        parts = key.split(".")[1:]
        if parts[0] == "blocks":
            want = ref["blocks"][parts[2]][int(parts[1])]
        else:
            want = ref[parts[0]][parts[1]]
        np.testing.assert_allclose(v, want, rtol=2e-4, atol=2e-6, err_msg=f"{name}: {key}")


@pytest.mark.parametrize("name", [n for n in CASES if n not in SEEDED])
def test_pipeline_train_batch_matches_the_jax_engine(pipe_run, name):
    ranks, (ref_losses, ref_params) = pipe_run[name]
    pipe, data, schedule, kind, _, _ = CASES[name]
    assert len(ranks) == pipe * data
    for r in ranks:
        assert r["fused"]
        np.testing.assert_allclose(r["losses"], ref_losses, rtol=2e-5)
        _assert_params_close(r["params"], ref_params, name)
    # one loss and one gradient norm on every rank
    assert len({tuple(r["losses"]) for r in ranks}) == 1 and len({r["norm"] for r in ranks}) == 1


@pytest.mark.parametrize("name", list(CASES))
def test_each_stage_holds_its_layers_and_bounded_activations(pipe_run, name):
    """Each stage trains its own layers (stage 0 the embedding, the last
    the final norm and the head; the tied embedding on both ends), and
    keeps at most ``num_pipe_buffers()`` microbatches' activations under
    1F1B (2 here: S - s, at least 2), all M under GPipe."""
    ranks, _ = pipe_run[name]
    pipe, data, schedule, kind, _, _ = CASES[name]
    per = TINY["num_layers"] // pipe
    for r in ranks:
        s = r["stage"]
        blocks = {int(n.split(".")[2]) for n in r["owned"] if n.startswith("tree.blocks.")}
        assert blocks == set(range(s * per, (s + 1) * per))
        ends = sorted(n for n in r["owned"] if not n.startswith("tree.blocks."))
        want = ((["tree.embed.embedding"] if s == 0 or (kind == "tied" and s == pipe - 1)
                 else [])
                + (["tree.final_norm.scale"] + ([] if kind == "tied" else
                                                ["tree.lm_head.kernel"]) if s == pipe - 1 else []))
        assert ends == sorted(want)
        if schedule == "1f1b":
            assert r["max_live"] <= r["buffers"] and r["buffers"] == max(2, min(pipe - s, GAS))
        else:
            assert r["max_live"] == GAS


@pytest.mark.parametrize("name", ["tied@1"] + list(SEEDED))
def test_pipeline_matches_the_port_at_world_size_one(pipe_run, name):
    """The tied case held, besides the JAX engine, to the port's own
    world-size-1 run on the same weights and batch; a case whose ranks drew
    their stages alone from a seed, to the whole model drawn from it."""
    ranks, (ref_losses, ref_params) = pipe_run[name]
    for r in ranks:
        np.testing.assert_allclose(r["losses"], ref_losses, rtol=2e-5)
        _assert_params_close(r["params"], ref_params, name)
    if name in SEEDED:  # each rank built its stage's parameters alone
        assert all(r["held"] == r["owned"] for r in ranks)


def test_eager_forward_under_a_pipe_names_train_batch(pipe_run):
    for r in pipe_run["1f1b"][0]:
        assert r["eager"] is not None and "train_batch" in r["eager"]

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

MoE (the tiny Mistral with 4 experts, top-2): the experts shard over the
two ranks (rank r owns experts ``[2r, 2r + 2)``) at every stage; the einsum
path exchanges its capacity slots with the owners (an all-to-all), the
grouped path gathers the experts and reduce-scatters their gradients. Three
engine cases against the JAX engine on the same two devices, the gating's
rng dropped on both sides: the einsum path at stage 1, the grouped path at
stage 3 (the JAX grouped path under GSPMD is the reference: its Pallas
kernels run in interpret mode on the two virtual devices), and the einsum
path at stage 2 with ``loss_mask`` counts that differ between the ranks,
where the aux term must weigh 1 and the cross entropy its share of the
global count. Also ``MOELayer(ep_size=2)`` over the two ranks against the
JAX package's single-device layer (a capacity factor where nothing drops,
so per-rank capacities change nothing), sampled gating (jitter with random
token priority, top-2 Gumbel) at world size 2 against world size 1 in this
process on one seed, each rank's experts and resident bytes, and a model
whose expert count the world does not divide (its experts stay in the
blocks' flat groups).

The eager API at stages 2 and 3 (the latter with the unequal masks) and
``remat`` at stages 2 and 3 and on the einsum MoE path train bit-equal to their
cases' ``train_batch`` runs; under remat stage 3 gathers as often and the
einsum path exchanges its slots again in each layer's recompute.

Also, in the ranks: ``gather(scatter(x)) == x`` for every group over the
real collectives, stage 3's gathers (nothing gathered outlives the
forward; the backward gathers again), a second stage-2 engine over the
same model, each rank's resident bytes of parameters, gradients and
moments per stage, and ``deepspeed_io``'s shards; and, in this process,
the partition's layout arithmetic, ``MeshConfig.resolve`` (the ``expert``
axis dividing ``data * seq``) and the refusals at world size >= 2, each
naming its ROADMAP item.
"""

import gc
import os
import pickle
import time
import weakref

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import TransformerLM, llama2_config, mistral_config
from deepspeed_tpu_torch.models.convert import params_from_jax, params_to_numpy
from deepspeed_tpu_torch.parallel.mesh import MeshConfig
from deepspeed_tpu_torch.runtime.zero.partition import ALIGN, FlatGroup, is_expert

WORLD, MICRO, GAS, STEPS = 2, 2, 2, 3
TINY = dict(num_layers=2, hidden_size=64, num_heads=4, num_kv_heads=2, intermediate_size=128,
            vocab_size=256, max_seq_len=256, sliding_window=16)
SPARSE_TINY = dict(num_layers=2, hidden_size=64, num_heads=4, num_kv_heads=4,
                   intermediate_size=128, vocab_size=256, max_seq_len=64)
MOE = dict(moe_num_experts=4, moe_top_k=2)
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
    "moe_einsum_stage1": ("moe_einsum", 1, "always", "ids"),
    "moe_grouped_stage3": ("moe_grouped", 3, "always", "ids"),
    "moe_mask_stage2": ("moe_einsum", 2, "never", "mask"),
}
# sampled gating at world size 2 against world size 1: name -> (top-k, noisy
# gate policy, moe_impl, ZeRO stage)
SAMPLED = {"jitter_top1": (1, "Jitter", "einsum", 0), "gumbel_top2": (2, None, "grouped", 3)}
# MOELayer(ep_size=2) against the JAX single-device layer: tokens, width,
# FFN width, experts; a capacity factor where nothing drops
EP_LAYER = dict(S=24, M=16, F=32, E=4, cf=8.0)
REFERENCE = {name: "stage3" if name.startswith("stage") and CASES[name][2:] == ("always", "ids")
             else name for name in CASES}
# cases trained again through forward / backward / step, and with remat:
# each bit-equal to the case's own train_batch run
EAGER_CASES = ("stage2", "stage3_mask")
REMAT_CASES = ("stage2", "stage3", "moe_einsum_stage1")
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


class _NoGeneratorLM(TransformerLM):
    """The port's model with no generator passed to the gating (the JAX
    engine's rng is dropped alike): deterministic routing on both sides."""

    def loss(self, batch, params=None):
        return super().loss(batch, None, params)

    def _loss_terms(self, batch, params=None):
        return super()._loss_terms(batch, None, params)


def _torch_cfg(kind, **over):
    if kind == "sparse":
        return llama2_config("tiny", dtype=torch.float32, sparse_attention=SPARSE_SA,
                             **SPARSE_TINY)
    moe = dict(MOE, moe_impl=kind[4:]) if kind.startswith("moe_") else {}
    return mistral_config("tiny", dtype=torch.float32, attention_impl="reference",
                          **{**TINY, **moe, **over})


def _torch_model(kind, npp, cls=None, **over):
    cfg = _torch_cfg(kind, **over)
    cls = cls or (_NoGeneratorLM if kind.startswith("moe_") else TransformerLM)
    return cls(cfg, params_from_jax(npp, cfg, device="cpu", dtype=torch.float32, per_layer=True),
               trainable=True)


def _seq(kind):
    return 64 if kind == "sparse" else 24


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


def _stage3_regathers(engine, rank, name="_gathered"):
    """One more forward and backward, counting the calls of the partition's
    ``name`` (a group's gather, or ``_gathered_expert``, one expert leaf's):
    no gathered buffer outlives the forward (what autograd saved of it is
    gathered again), and the backward gathers every group it saved from.
    gloo's worker thread drops its own reference to a collective's output
    just after the caller's wait returns (under load, a third of all-gathers
    are still held then), so the count waits up to 2 s for that; a buffer
    this process keeps stays alive through the wait."""
    from deepspeed_tpu_torch.runtime.zero import partition

    bufs, calls, real = [], [0], getattr(partition, name)

    def counted(*args):
        calls[0] += 1
        out = real(*args)
        bufs.extend(weakref.ref(b) for b in (out if isinstance(out, list) else [out]))
        return out

    batch = _rank_rows(_global_batch("ids", STEPS, _seq("dense")), rank)
    setattr(partition, name, counted)
    try:
        loss = sum(engine._loss_terms({"input_ids": torch.from_numpy(batch["input_ids"][:MICRO])},
                                      0))
        forward = calls[0]
        for _ in range(200):
            alive = sum(ref() is not None for ref in bufs)
            if not alive:
                break
            time.sleep(0.01)
        loss.backward()
        engine._zero.finish_backward()
    finally:
        setattr(partition, name, real)
    return {"forward_gathers": forward, "alive_after_forward": alive,
            "backward_gathers": calls[0] - forward}


def _eager_case(name, rank, npps):
    """Case ``name`` trained again on the same rows through the eager API,
    one microbatch a ``forward`` / ``backward`` / ``step``: (losses, final
    parameters)."""
    kind, stage, mode, batch_kind = CASES[name]
    engine, _, _, _ = deepspeed_tpu_torch.initialize(model=_torch_model(kind, npps[kind]),
                                                     config=_ds_config(stage, mode))
    losses = []
    for step in range(STEPS):
        rows = _rank_rows(_global_batch(batch_kind, step, _seq(kind)), rank)
        for i in range(GAS):
            engine.backward(engine({k: v[i * MICRO:(i + 1) * MICRO] for k, v in rows.items()}))
            engine.step()
        losses.append(float(engine._step_metrics["loss"]))
    return {"losses": losses,
            "params": {k: v.numpy() for k, v in engine.module_state_dict().items()}}


def _remat_case(name, rank, npps):
    """Case ``name`` trained again with ``remat`` (``nothing_saveable``):
    losses, final parameters, the all-to-all exchanges of its steps and, at
    stage 3, the gathers of one more forward and backward."""
    from deepspeed_tpu_torch.moe import sharded_moe

    kind, stage, mode, batch_kind = CASES[name]
    engine, _, _, _ = deepspeed_tpu_torch.initialize(
        model=_torch_model(kind, npps[kind], remat=True), config=_ds_config(stage, mode))
    sharded_moe.reset_launch_counts()
    r = {"losses": [float(engine.train_batch(_rank_rows(
        _global_batch(batch_kind, step, _seq(kind)), rank))) for step in range(STEPS)]}
    r["exchanges"] = sharded_moe.launch_counts["all_to_all"]
    r["params"] = {k: v.numpy() for k, v in engine.module_state_dict().items()}
    if stage == 3:
        r["regather"] = _stage3_regathers(engine, rank)
    return r


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


def _owned_experts(engine):
    """{parameter name: this rank's experts} of the engine's model."""
    return {n: p.detach().numpy().copy() for n, p in engine.module.named_parameters()
            if is_expert(p)}


def _ep_layer(rank, lp, x, dy):
    """``MOELayer(ep_size=2)`` over the two ranks on rank ``rank``'s tokens
    and experts: (y, dx, d wi, d wo) of this rank."""
    from deepspeed_tpu_torch.moe import sharded_moe as tsm

    S, M, F, E, cf = (EP_LAYER[k] for k in ("S", "M", "F", "E", "cf"))
    n, e = S // WORLD, E // WORLD
    gate = tsm.TopKGate(M, E, k=2, capacity_factor=cf, eval_capacity_factor=cf, min_capacity=8)
    layer = tsm.MOELayer(gate, M, F, num_local_experts=e, ep_size=WORLD)
    experts = {k: torch.from_numpy(v[rank * e:(rank + 1) * e].copy()).requires_grad_()
               for k, v in lp["experts"].items()}
    xs = torch.from_numpy(x[rank * n:(rank + 1) * n].copy()).requires_grad_()
    tsm.reset_launch_counts()
    y, _ = layer({"gate": {"wg": torch.from_numpy(lp["gate"]["wg"])}, "experts": experts}, xs,
                 train=False)
    (y * torch.from_numpy(dy[rank * n:(rank + 1) * n])).sum().backward()
    return {"y": y.detach().numpy(), "dx": xs.grad.numpy(), "dwi": experts["wi"].grad.numpy(),
            "dwo": experts["wo"].grad.numpy(), "exchanges": tsm.launch_counts["all_to_all"]}


def _ep_layer_engine(rank, ep):
    """``moe.MoE(ep_size=ep)``'s parameters (each rank draws its own
    ``4 / ep`` experts) trained through ``initialize`` with a loss function
    at stage 1, two steps: at ep 2 the partition keeps each rank's experts
    as they are, out of the flat group (the gate's weights broadcast from
    rank 0); at ep 1 they are replicated leaves of the flat group, rank
    0's."""
    from deepspeed_tpu_torch.moe import MoE, sharded_moe
    from deepspeed_tpu_torch.parallel import groups

    groups.initialize_mesh(MeshConfig(data=WORLD), "cpu")
    S, M, F, E, cf = (EP_LAYER[k] for k in ("S", "M", "F", "E", "cf"))
    moe = MoE(M, num_experts=E, ep_size=ep, k=2, capacity_factor=cf, eval_capacity_factor=cf,
              min_capacity=8, ffn_dim=F)
    init = moe.init(torch.Generator().manual_seed(10 + rank))["moe"]
    own = {k: v.clone() for k, v in init["experts"].items()}

    def loss_fn(p, batch):
        x = batch["x"].reshape(-1, M)
        y, aux = moe({"moe": {"gate": {"wg": p["wg"]}, "experts": {"wi": p["wi"], "wo": p["wo"]}}},
                     x)
        return (y - x).square().mean() + 0.01 * aux

    engine, _, _, _ = deepspeed_tpu_torch.initialize(
        model=loss_fn, model_parameters={"wg": init["gate"]["wg"], **init["experts"]},
        config=_ds_config(1, "always"))
    z = engine._zero
    kept = all(torch.equal(engine.module.params[k].detach(), own[k]) for k in own)
    sharded_moe.reset_launch_counts()
    x = np.random.default_rng(90 + rank).normal(size=(GAS * MICRO, S // WORLD, M))
    losses = [float(engine.train_batch({"x": x.astype(np.float32)})) for _ in range(2)]
    return {"kept": kept, "owned": len(z.experts),
            "flat": [l.key for fg in z.groups for l in fg.leaves], "losses": losses,
            "exchanges": sharded_moe.launch_counts["all_to_all"],
            "moved": not torch.equal(engine.module.params["wi"].detach(), own["wi"])}


def _sampled(rank, npp):
    """Each SAMPLED case at world size 2 on rank ``rank``'s rows: (losses,
    final parameters)."""
    out = {}
    for name, (k, policy, impl, stage) in SAMPLED.items():
        model = _torch_model(f"moe_{impl}", npp, cls=TransformerLM, moe_top_k=k,
                             moe_noisy_gate_policy=policy)
        engine, _, _, _ = deepspeed_tpu_torch.initialize(model=model,
                                                         config=_ds_config(stage, "always"))
        losses = [float(engine.train_batch(_rank_rows(_global_batch("ids", step, 24), rank)))
                  for step in range(STEPS)]
        out[name] = (losses, {k: v.numpy() for k, v in engine.module_state_dict().items()})
    return out


def _indivisible(rank, npp):
    """A MoE model with 3 experts at world size 2 (stage 1): the world does
    not divide them, so they stay in their blocks' flat groups, replicated
    as the reference replicates the expert dim; one step."""
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.parallel import groups

    cfg = mistral_config("tiny", dtype=torch.float32, attention_impl="reference",
                         **dict(TINY, moe_num_experts=3, moe_top_k=2))
    model = TransformerLM(cfg, device="cpu", trainable=True, seed=3)
    engine, _, _, _ = deepspeed_tpu_torch.initialize(model=model, config=_ds_config(1, "always"))
    z = engine._zero
    in_flat = sorted(l.key[2] for fg in z.groups for l in fg.leaves
                     if l.key[0] == "blocks" and l.key[2].startswith("moe_"))
    loss = float(engine.train_batch(_rank_rows(_global_batch("ids", 0, 24), rank)))
    return {"owned": len(z.experts), "in_flat": in_flat, "loss": loss,
            "wi_shape": tuple(model.tree["blocks"][0]["moe_wi"].shape),
            "ep_group_size": comm.get_world_size(groups.get_expert_parallel_group()),
            "ep_sizes": (groups.get_expert_parallel_world_size(),
                         groups.get_expert_data_parallel_world_size(),
                         groups.get_expert_parallel_rank(), groups.get_expert_data_parallel_rank(),
                         groups.get_expert_data_parallel_group() is groups.get_data_parallel_group()
                         )}


def _worker(rank, store, npps, out_dir):
    torch.set_num_threads(2)
    deepspeed_tpu_torch.init_distributed(dist_backend="gloo", init_method=f"file://{store}",
                                         rank=rank, world_size=WORLD, verbose=False)
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.moe import sharded_moe

    results = {}
    try:
        for name, (kind, stage, mode, batch_kind) in CASES.items():
            over = {"sparse_attention": SPARSE_SA} if kind == "sparse" else {}
            engine, _, _, _ = deepspeed_tpu_torch.initialize(
                model=_torch_model(kind, npps[kind]), config=_ds_config(stage, mode, **over))
            r = {"bytes_at_init": engine.zero_resident_bytes(), "owned": _owned_experts(engine),
                 "flat_moe": [l.key for fg in engine._zero.groups for l in fg.leaves
                              if l.key[-1].startswith("moe_w")]}
            sharded_moe.reset_launch_counts()
            r["losses"] = [float(engine.train_batch(_rank_rows(
                _global_batch(batch_kind, step, _seq(kind)), rank))) for step in range(STEPS)]
            r["exchanges"] = sharded_moe.launch_counts["all_to_all"]
            r["bytes"] = engine.zero_resident_bytes()
            r["params"] = {k: v.numpy() for k, v in engine.module_state_dict().items()}
            r["fused"] = engine._pallas_adam is not None
            r["gathers"] = engine._zero.gathers(engine.module.gathers_experts)
            if name == "stage2":
                r["second_engine"] = _second_stage2_engine(engine, rank)
            if name == "moe_grouped_stage3":
                r["regather_experts"] = _stage3_regathers(engine, rank, "_gathered_expert")
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
        for name in EAGER_CASES:
            results[f"eager_{name}"] = _eager_case(name, rank, npps)
        for name in REMAT_CASES:
            results[f"remat_{name}"] = _remat_case(name, rank, npps)
        results["bf16"] = _bf16_stages(rank, npps["dense"])
        results["low_gathers"] = _low_dtype_gathers(rank)
        results["ep_layer"] = _ep_layer(rank, *npps["ep_layer"])
        results["ep_layer_engine"] = {ep: _ep_layer_engine(rank, ep) for ep in (1, WORLD)}
        results["sampled"] = _sampled(rank, npps["moe_einsum"])
        results["indivisible"] = _indivisible(rank, npps["moe_einsum"])
    finally:
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(results, f)
        comm.destroy_process_group()


class _NoRngJax:
    """The JAX model with its gating's rng dropped (deterministic routing)."""

    def __init__(self, cfg):
        from deepspeed_tpu.models import TransformerLM as JaxLM

        self.model = JaxLM(cfg)

    def init(self, rng, example_batch=None):
        return self.model.init(rng, example_batch)

    def loss(self, params, batch, rng=None):
        from deepspeed_tpu.models import transformer as jt

        return jt.loss_fn(self.model.config, params, batch, None)


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
    over, wrap = {}, JaxLM
    if kind == "sparse":
        jcfg = jax_llama2_config("tiny", dtype=jnp.float32, attention_impl="reference",
                                 sparse_attention=SPARSE_SA, **SPARSE_TINY)
        over = {"sparse_attention": SPARSE_SA}
    else:
        moe = dict(MOE, moe_impl=kind[4:]) if kind.startswith("moe_") else {}
        jcfg = jax_mistral_config("tiny", dtype=jnp.float32, attention_impl="reference",
                                  **TINY, **moe)
        wrap = _NoRngJax if moe else JaxLM
    mesh = build_mesh(JaxMeshConfig(data=WORLD), devices=jax.devices()[:WORLD])
    je, _, _, _ = deepspeed_tpu.initialize(model=wrap(jcfg),
                                           config=_ds_config(stage, mode, **over), mesh=mesh)
    return je


def _jax_ep_layer():
    """The JAX package's single-device ``MOELayer`` (einsum, top-2) of
    EP_LAYER: ((weights, x, dy), (y, dx, d wi, d wo)) in numpy."""
    import jax
    import jax.numpy as jnp

    from deepspeed_tpu.moe import sharded_moe as jsm

    S, M, F, E, cf = (EP_LAYER[k] for k in ("S", "M", "F", "E", "cf"))
    gate = jsm.TopKGate(M, E, k=2, capacity_factor=cf, eval_capacity_factor=cf, min_capacity=8)
    layer = jsm.MOELayer(gate, M, F, num_local_experts=E)
    lp = jax.tree.map(np.asarray, layer.init(jax.random.PRNGKey(3)))
    rng = np.random.default_rng(80)
    x = rng.normal(size=(S, M)).astype(np.float32)
    dy = rng.normal(size=(S, M)).astype(np.float32)

    def f(x_, wi, wo):
        return layer({"gate": lp["gate"], "experts": {"wi": wi, "wo": wo}}, x_, train=False)[0]

    y, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(lp["experts"]["wi"]),
                     jnp.asarray(lp["experts"]["wo"]))
    return (lp, x, dy), tuple(np.asarray(a) for a in (y, *vjp(jnp.asarray(dy))))


def _sampled_world1(npp):
    """Each SAMPLED case at world size 1 in this process on the global
    batch (micro = MICRO * WORLD, so the rows and their generators are the
    ranks' in order): (losses, final parameters)."""
    out = {}
    for name, (k, policy, impl, stage) in SAMPLED.items():
        model = _torch_model(f"moe_{impl}", npp, cls=TransformerLM, moe_top_k=k,
                             moe_noisy_gate_policy=policy)
        engine, _, _, _ = deepspeed_tpu_torch.initialize(model=model, config=_ds_config(
            stage, "always", train_batch_size=MICRO * GAS * WORLD,
            train_micro_batch_size_per_gpu=MICRO * WORLD, tpu={"pallas_fused_adam": "always"}))
        losses = [float(engine.train_batch(_global_batch("ids", step, 24)))
                  for step in range(STEPS)]
        out[name] = (losses, {k: v.numpy().copy() for k, v in engine.module_state_dict().items()})
    return out


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
            for name in ("stage3", "sparse_stage2", "moe_einsum_stage1",          # weights
                         "moe_grouped_stage3")}
    ep_inputs, ep_ref = _jax_ep_layer()
    npps["ep_layer"] = ep_inputs
    ctx = mp.start_processes(_worker, args=(str(tmp / "store"), npps, str(tmp)), nprocs=WORLD,
                             join=False, start_method="spawn")
    try:  # the JAX engines compile and train in threads, beside the ranks
        with ThreadPoolExecutor(len(engines)) as ex:
            futures = {name: ex.submit(_jax_train, je, CASES[name][0], CASES[name][3])
                       for name, je in engines.items()}
            sampled = _sampled_world1(npps["moe_einsum"])
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
    out.update({key: [rk[key] for rk in ranks] for key in (
        "bf16", "low_gathers", "ep_layer", "ep_layer_engine", "sampled", "indivisible",
        *[f"eager_{name}" for name in EAGER_CASES], *[f"remat_{name}" for name in REMAT_CASES])})
    out.update(ep_ref=ep_ref, sampled_world1=sampled, npps=npps)
    return out


def _assert_params_close(ours, ref, kind):
    cfg = _torch_cfg(kind)
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


def _assert_bit_equal(got, want):
    assert got["losses"] == want["losses"]
    assert set(got["params"]) == set(want["params"])
    for k, v in want["params"].items():
        assert np.array_equal(got["params"][k], v), k


@pytest.mark.parametrize("name", EAGER_CASES)
def test_eager_api_at_world_size_two_is_bit_equal_to_train_batch(zero_run, name):
    """``forward`` / ``backward`` / ``step`` at stages 2 and 3 (the latter
    with ``loss_mask`` counts that differ between the ranks, so each
    microbatch's loss weight is the global mean's) train as ``train_batch``
    does, to the bit."""
    for got, want in zip(zero_run[f"eager_{name}"], zero_run[name][0]):
        _assert_bit_equal(got, want)


@pytest.mark.parametrize("name", REMAT_CASES)
def test_remat_at_world_size_two_is_bit_equal_and_gathers_as_often(zero_run, name):
    """``remat`` trains bit-equal to no remat: at stage 2 each leaf's hook
    fires once a microbatch (the recompute's graph is dropped unrun); at
    stage 3 it gathers as often: the forward gathers the two ends and every
    block once, nothing
    gathered outlives it, and the backward gathers the head (its saved
    weights) and each block (its recompute) once. On the einsum MoE path
    each layer's recompute exchanges its slots again: 6 all-to-alls a layer
    a microbatch, not 4."""
    for got, want in zip(zero_run[f"remat_{name}"], zero_run[name][0]):
        _assert_bit_equal(got, want)
        assert got["exchanges"] * 4 == want["exchanges"] * 6
        if "regather" in got:
            assert got["regather"] == {"forward_gathers": 2 + TINY["num_layers"],
                                       "alive_after_forward": 0,
                                       "backward_gathers": 1 + TINY["num_layers"]}


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


MOE_CASES = [name for name in CASES if name.startswith("moe_")]


@pytest.mark.parametrize("name", MOE_CASES)
def test_each_rank_holds_its_experts_only(zero_run, name):
    """Rank r holds experts ``[2r, 2r + 2)`` of every block's ``moe_wi`` /
    ``moe_wg`` / ``moe_wo`` (its slice of the initial weights) at every
    stage, outside the flat groups, and its expert parameters, gradients
    and moments are half of the whole."""
    ranks, _ = zero_run[name]
    blocks = zero_run["npps"][CASES[name][0]]["blocks"]
    leaves = ("moe_wi", "moe_wg", "moe_wo")
    half = sum(blocks[n].size for n in leaves) // WORLD
    e = MOE["moe_num_experts"] // WORLD
    for rank, r in enumerate(ranks):
        assert sorted(r["owned"]) == sorted(f"tree.blocks.{l}.{n}" for l in range(2)
                                            for n in leaves)
        for key, got in r["owned"].items():
            l, n = int(key.split(".")[2]), key.split(".")[3]
            np.testing.assert_array_equal(got, blocks[n][l][rank * e:(rank + 1) * e])
        assert r["flat_moe"] == []
        assert r["bytes"]["expert_params"] == r["bytes"]["expert_grads"] == 4 * half
        assert r["bytes"]["expert_moments"] == 2 * 4 * half


@pytest.mark.parametrize("name", MOE_CASES)
def test_the_einsum_path_exchanges_and_the_grouped_path_gathers(zero_run, name):
    """The einsum path sends its slots to the experts' owners and back, two
    all-to-alls a layer in the forward and two in the backward, and below
    stage 3 gathers nothing (the model's own tree holds this rank's
    experts); the grouped path exchanges none: it gathers each block's
    experts (3 leaves) where the forward reaches the block, keeps none of
    them past the forward, and gathers them again in the backward."""
    layers = TINY["num_layers"]
    for r in zero_run[name][0]:
        if CASES[name][0] == "moe_einsum":
            # the forward reads the model's own tree: this rank's experts
            assert r["exchanges"] == 4 * layers * GAS * STEPS and not r["gathers"]
        else:
            assert r["gathers"]
            assert r["exchanges"] == 0
            g = r["regather_experts"]
            assert g == {"forward_gathers": 3 * layers, "alive_after_forward": 0,
                         "backward_gathers": 3 * layers}


def test_moe_aux_term_weighs_one_where_mask_counts_differ(zero_run):
    """The reference's MoE loss is the global microbatch's masked-mean CE
    plus coef x the mean of l_aux over its rows: with ``loss_mask`` counts
    that differ between the ranks, each rank's CE takes its share of the
    global count while its aux term (a mean over as many rows as any
    rank's) weighs 1."""
    ranks, (ref_losses, _) = zero_run["moe_mask_stage2"]
    batch = _global_batch("mask", 0, 24)
    counts = [_rank_rows(batch, r)["loss_mask"][:, 1:].sum() for r in range(WORLD)]
    assert counts[0] > 2 * counts[1]
    for r in ranks:
        np.testing.assert_allclose(r["losses"], ref_losses, rtol=2e-5)


def test_moelayer_ep2_matches_the_jax_single_device_layer(zero_run):
    """``MOELayer(ep_size=2)``: each rank routes its own tokens, its slots go
    to the experts' owner and back (two all-to-alls, two more in the
    backward), against the JAX package's single-device layer over every
    token and expert (``tests/test_moe.py::test_moe_ep_shard_map_matches_
    single``): outputs, token gradients and the owners' expert gradients,
    rtol / atol 1e-5 (``tests/test_torch_moe.py``'s layer tolerance)."""
    y, dx, dwi, dwo = zero_run["ep_ref"]
    n, e = EP_LAYER["S"] // WORLD, EP_LAYER["E"] // WORLD
    for rank, r in enumerate(zero_run["ep_layer"]):
        rows, owned = slice(rank * n, (rank + 1) * n), slice(rank * e, (rank + 1) * e)
        for got, want, what in ((r["y"], y[rows], "y"), (r["dx"], dx[rows], "dx"),
                                (r["dwi"], dwi[owned], "dwi"), (r["dwo"], dwo[owned], "dwo")):
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5, err_msg=what)
        assert r["exchanges"] == 4


@pytest.mark.parametrize("ep", [1, WORLD])
def test_moe_layer_experts_stay_on_their_rank_through_the_engine(zero_run, ep):
    """``MoE`` marks its experts as upstream DeepSpeed does (``allreduce =
    False``, ``group_name``). Through ``initialize`` with a loss function:
    at ep_size 2 each rank keeps its own experts (no broadcast of rank
    0's), the flat group holds the gate alone, and the steps exchange the
    slots (two all-to-alls a microbatch forward; one backward, the return
    exchange's: the tokens here take no gradient); at ep_size 1 the
    experts are replicated leaves of the flat group, rank 0's, and nothing
    is exchanged. Both train the experts."""
    runs = [r[ep] for r in zero_run["ep_layer_engine"]]
    for rank, r in enumerate(runs):
        if ep == WORLD:
            assert r["kept"] and r["owned"] == 2 and r["flat"] == ["params.wg"]
            assert r["exchanges"] == 3 * GAS * 2
        else:
            assert r["kept"] == (rank == 0) and r["owned"] == 0 and r["exchanges"] == 0
            assert r["flat"] == ["params.wg", "params.wi", "params.wo"]
        assert r["moved"] and np.all(np.isfinite(r["losses"]))
    assert runs[0]["losses"] == runs[1]["losses"]


@pytest.mark.parametrize("name", list(SAMPLED))
def test_sampled_gating_trains_alike_at_world_sizes_one_and_two(zero_run, name):
    """Sampled routing (jitter with random token priority at top-1, the
    Gumbel second expert at top-2) from one seed: each row of the step's
    global batch draws from its own generator, so two ranks train as one
    process does on the same global batch (losses rtol 2e-5, parameters
    rtol 2e-4 / atol 2e-6)."""
    w1_losses, w1_params = zero_run["sampled_world1"][name]
    for r in zero_run["sampled"]:
        losses, params = r[name]
        np.testing.assert_allclose(losses, w1_losses, rtol=2e-5)
        for k, v in params.items():
            np.testing.assert_allclose(v, w1_params[k], rtol=2e-4, atol=2e-6, err_msg=k)


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
                                       ("data_repl", "MiCS")])
def test_non_data_mesh_axes_are_refused_naming_their_item(axis, item):
    """Every axis but ``data``, ``model`` and ``pipe`` is refused, naming its
    ROADMAP item. ``model`` (A3b, tensor parallelism) and ``pipe`` (A6.8,
    pipeline parallelism) are ported: each config resolves to ``data 2 x
    <axis> 2`` over 4 ranks and builds the two-axis mesh (a fake process
    group of 4 in this process), ``model`` innermost and ``pipe``
    outermost; ``pipe`` with ``model`` is refused, naming A6.8."""
    config = {"train_batch_size": 2, "tpu": {"mesh": {"data": 2, axis: 2}}}
    if axis in ("model", "pipe"):
        import torch.distributed as dist
        from torch.testing._internal.distributed.fake_pg import FakeStore

        from deepspeed_tpu_torch.parallel.mesh import build_mesh

        mesh_config = deepspeed_tpu_torch.DeepSpeedConfig(config).tpu_config.mesh_config()
        sizes = mesh_config.resolve(4)
        assert {k: v for k, v in sizes.items() if v != 1} == {"data": 2, axis: 2}
        dist.init_process_group("fake", rank=1, world_size=4, store=FakeStore())
        try:
            mesh = build_mesh(mesh_config, 4, "cpu")
            names = ("data", "model") if axis == "model" else ("pipe", "data")
            assert mesh.mesh_dim_names == names and mesh.mesh.tolist() == [[0, 1], [2, 3]]
        finally:
            dist.destroy_process_group()
        if axis == "pipe":
            with pytest.raises(NotImplementedError, match="A6.8, left open: pipe × model"):
                deepspeed_tpu_torch.DeepSpeedConfig(
                    {"train_batch_size": 2, "tpu": {"mesh": {"pipe": 2, "model": 2}}})
    else:
        with pytest.raises(NotImplementedError, match=item):
            deepspeed_tpu_torch.DeepSpeedConfig(config)
    cfg = deepspeed_tpu_torch.DeepSpeedConfig({"train_batch_size": 2,
                                               "tpu": {"mesh": {"data": -1}}})
    assert cfg.tpu_config.mesh_config().resolve(4)["data"] == 4


@pytest.mark.parametrize("expert,ok", [(1, True), (2, True), (3, False)])
def test_expert_axis_must_divide_data_times_seq(expert, ok):
    """``expert`` is accepted where it divides ``data * seq``, as the
    reference's ``resolve`` accepts it; another value raises there."""
    cfg = deepspeed_tpu_torch.DeepSpeedConfig({"train_batch_size": 2, "tpu": {"mesh": {
        "data": 2, "expert": expert}}})
    mesh = cfg.tpu_config.mesh_config()
    if ok:
        assert mesh.resolve(2)["data"] == 2 and mesh.expert == expert
    else:
        with pytest.raises(ValueError, match=r"expert parallel size 3 must divide data\*seq"):
            mesh.resolve(2)


def test_expert_data_replicas_are_refused():
    """``expert`` 2 over ``data`` 4 divides, but it asks for experts
    replicated over two expert-data ranks, which the partition does not
    build (it shards them over the whole data group): the mesh refuses it,
    naming A3, before any group is made; ``expert`` 4 builds that layout."""
    from deepspeed_tpu_torch.parallel.mesh import build_mesh, refuse_expert_data_replicas

    assert MeshConfig(data=4, expert=2).resolve(4)["data"] == 4
    with pytest.raises(NotImplementedError, match="expert-data replicas.*A3"):
        build_mesh(MeshConfig(data=4, expert=2), 4, "cpu")
    with pytest.raises(NotImplementedError, match="expert-data replicas.*A3"):
        build_mesh(MeshConfig(data=-1, expert=2), 8, "cpu")
    for expert in (1, 4):
        refuse_expert_data_replicas(expert, 4)


def test_mesh_axis_order_is_not_a_mesh_key():
    """The port builds its mesh in one order, ``model`` innermost: a key it
    would not read is refused, not ignored."""
    with pytest.raises(deepspeed_tpu_torch.DeepSpeedConfigError,
                       match="axis_order"):
        deepspeed_tpu_torch.DeepSpeedConfig({"train_batch_size": 2, "tpu": {"mesh": {
            "data": 2, "axis_order": ["pipe", "data_repl", "data", "seq", "model"]}}})


def test_moe_and_hybrid_are_refused_at_world_size_two(zero_run, monkeypatch):
    """A MoE model whose expert count the world does not divide (3 experts,
    2 ranks) builds and trains with its experts in the blocks' flat groups,
    replicated (the reference's ``sanitize_spec`` replicates the dim); the
    hybrid engine is refused at world size 2, naming A1, for a MoE model
    too."""
    from deepspeed_tpu_torch import comm

    for rank, r in enumerate(zero_run["indivisible"]):
        assert r["owned"] == 0 and r["wi_shape"] == (3, 64, 128) and np.isfinite(r["loss"])
        assert r["in_flat"] == ["moe_wg"] * 2 + ["moe_wi"] * 2 + ["moe_wo"] * 2
        # the reference's getters: the data group, the mesh's expert size 1
        assert r["ep_group_size"] == WORLD and r["ep_sizes"] == (1, WORLD, rank, rank, True)
    monkeypatch.setattr(comm, "get_world_size", lambda group=None: 2)
    for moe in ({}, MOE):
        model = TransformerLM(mistral_config("tiny", dtype=torch.float32, **TINY, **moe),
                              device="cpu", trainable=True)
        with pytest.raises(NotImplementedError, match="hybrid engine at world size 2.*A1"):
            deepspeed_tpu_torch.initialize(model=model, config={
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

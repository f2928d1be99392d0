"""PyTorch port, tensor parallelism (the ``model`` mesh axis) against the
JAX package and against the port at world size 1.

Four gloo ranks (spawned processes sharing a ``FileStore`` under
``tmp_path``) run every distributed case, spawned once for the module:

- world 4, ``data 2 x model 2``: the tiny dense Mistral of
  ``tests/test_torch_zero.py`` (TINY: 4/2 heads, FFN 128, vocab 256, fp32,
  the JAX engine's initial weights through ``models/convert.py``) trains 3
  steps with gas 2, clipping 1.0 (gradient norms near 10, so the clip acts)
  and that file's AdamW and WarmupLR schedule at ZeRO stages 1 and 3 with
  the fused AdamW path (its plain version on the CPU); stage 1 from a whole model that the engine splits (rank 0's
  weights broadcast), stage 3 from each rank's shards
  (``convert.tensor_parallel_shards``). The reference is the JAX engine on
  ``MeshConfig(data=2, model=2)`` over four virtual devices with the same
  global batch (its stages are one computation under other shardings, so
  one JAX run at stage 3 serves both). Losses and gradient norms at rtol
  2e-5, the final whole parameters (gathered on every rank) at rtol 2e-4 /
  atol 2e-6, ``tests/test_torch_zero.py``'s tolerances; the replicated
  leaves equal on every rank after every step.
- world 4, ``model 4``: TINY's 2 kv heads do not divide by 4, so attention
  runs replicated (with a warning) while the MLP and the vocabulary split;
  its logits, loss and every gradient equal world size 1's (rtol 1e-5).
- world 2 (ranks 0 and 1 again, a new process group), ``model 2``:
  ``linear_layer`` -> ``linear_allreduce`` and the vocab-parallel
  embedding and cross entropy (unchunked and chunked, a ``loss_mask``,
  labels on both ranks' halves of the vocabulary) against the unsplit
  products (rtol 1e-5); the model's forward and loss against world size 1;
  ``data 1 x model 2`` at stage 0 against the JAX engine at ``model 2``,
  and the same with ``remat``, bit-equal; ``init_inference(tp_size=2)``
  (the paged and the dense cache routes) whose greedy streams equal the
  port's ``tp_size 1`` streams and the JAX package's
  ``init_inference(tp_size=2)`` streams.

In this process: AutoTP's specs and slicing, ``ReplaceWithTensorSlicing``,
``tp_shard``'s uneven sizes, ``replace_transformer_layer`` / revert, the
partition rules and the slicing helper, the mesh of two axes, and the
refusals (MoE, block-sparse attention and ``sequence_parallel`` under
tensor parallelism).
"""

import os
import pickle
import warnings

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import deepspeed_tpu_torch
from deepspeed_tpu_torch import DeepSpeedInferenceConfig, InferenceEngine
from deepspeed_tpu_torch.models import TransformerLM, llama2_config, mistral_config
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.models.convert import (params_from_jax, params_to_numpy,
                                                tensor_parallel_shards)
from deepspeed_tpu_torch.parallel.mesh import MeshConfig

MICRO, GAS, STEPS = 2, 2, 3
TINY = dict(num_layers=2, hidden_size=64, num_heads=4, num_kv_heads=2, intermediate_size=128,
            vocab_size=256, max_seq_len=256, sliding_window=16)
SEQ = 24
# name -> (data, model, ZeRO stage, how the rank gets its weights)
CASES = {"dp2_mp2_stage1": (2, 2, 1, "whole"), "dp2_mp2_stage3": (2, 2, 3, "shards"),
         "mp2_stage0": (1, 2, 0, "shards")}
# the JAX run each case is held to: (data, model)
REFERENCE = {"dp2_mp2_stage1": (2, 2), "dp2_mp2_stage3": (2, 2), "mp2_stage0": (1, 2)}
PROMPT, NEW = (2, 8), 8
TIMEOUT_S = 240


def _cfg(**over):
    return mistral_config("tiny", dtype=torch.float32, **{"attention_impl": "reference", **TINY,
                                                          **over})


def _ds_config(stage, data, model):
    return {"train_batch_size": MICRO * GAS * data, "train_micro_batch_size_per_gpu": MICRO,
            "gradient_accumulation_steps": GAS,
            "optimizer": {"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.1}},
            "scheduler": {"type": "WarmupLR", "params": {"warmup_num_steps": 2,
                                                         "warmup_max_lr": 1e-3,
                                                         "warmup_type": "linear"}},
            "gradient_clipping": 1.0, "steps_per_print": 100, "zero_optimization": {"stage": stage},
            "tpu": {"pallas_fused_adam": "always", "mesh": {"data": data, "model": model}}}


def _global_batch(step, data):
    rng = np.random.default_rng(200 + step)
    return {"input_ids": rng.integers(0, 256, size=(MICRO * GAS * data, SEQ)).astype(np.int32)}


def _rank_rows(batch, d, data):
    """Data rank ``d``'s rows: ``[d * MICRO, (d + 1) * MICRO)`` of each global
    microbatch, gas-major (every model rank of a data index takes them)."""
    return {k: v.reshape(GAS, data, MICRO, *v.shape[1:])[:, d].reshape(GAS * MICRO, *v.shape[1:])
            for k, v in batch.items()}


def _ids(seed, shape=(2, SEQ)):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, 256, shape))


# ---------------------------------------------------------------------------
# in the ranks
# ---------------------------------------------------------------------------

def _init(store, rank, world):
    deepspeed_tpu_torch.init_distributed(dist_backend="gloo", init_method=f"file://{store}",
                                         rank=rank, world_size=world, verbose=False)


def _mesh(data, model):
    from deepspeed_tpu_torch.parallel import groups

    return groups.initialize_mesh(MeshConfig(data=data, model=model), "cpu")


def _engine_case(name, npp, remat=False):
    """Case ``name``: (losses, gradient norms, the replicated leaves after
    each step, the final whole parameters)."""
    from deepspeed_tpu_torch.runtime.zero.partition import is_model_parallel

    data, model, stage, how = CASES[name]
    _mesh(data, model)
    cfg = _cfg(remat=remat)
    full = params_from_jax(npp, cfg, device="cpu", dtype=torch.float32, per_layer=True)
    if how == "shards":
        tp = tt.tensor_parallel(cfg)
        net = TransformerLM(cfg, tensor_parallel_shards(full, tp), trainable=True, tp=tp)
    else:
        net = TransformerLM(cfg, full, trainable=True)
    engine, _, _, _ = deepspeed_tpu_torch.initialize(model=net,
                                                     config=_ds_config(stage, data, model))
    replicated = [n for n, p in net.named_parameters() if not is_model_parallel(p)]
    r = {"losses": [], "norms": [], "replicated": [], "dp_mp": (engine.dp_world_size,
                                                                engine.mp_world_size)}
    for step in range(STEPS):
        rows = _rank_rows(_global_batch(step, data), engine.dp_rank, data)
        r["losses"].append(float(engine.train_batch(rows)))
        r["norms"].append(float(engine.get_global_grad_norm()))
        sd = engine.module_state_dict()
        r["replicated"].append({n: sd[n].numpy().copy() for n in replicated})
    r["params"] = {k: v.numpy().copy() for k, v in engine.module_state_dict().items()}
    r["local_shapes"] = {n: tuple(p.shape) for n, p in net.named_parameters()
                         if p.numel()}  # stage 3 frees the full masters
    return r


def _model_check(npp, model, over=None):
    """The model's logits, loss and local gradients at model size
    ``model`` (data 1), with its plan's flags and warnings."""
    _mesh(1, model)
    cfg = _cfg(**(over or {}))
    full = params_from_jax(npp, cfg, device="cpu", dtype=torch.float32, per_layer=True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        tp = tt.tensor_parallel(cfg)
    net = TransformerLM(cfg, tensor_parallel_shards(full, tp), trainable=True, tp=tp)
    ids = _ids(7)
    mask = torch.from_numpy((np.random.default_rng(8).random((2, SEQ)) < 0.6).astype(np.float32))
    logits = net(ids)
    loss = net.loss({"input_ids": ids, "loss_mask": mask})
    loss.backward()
    return {"flags": (tp.attn, tp.mlp, tp.vocab), "warned": [str(w.message) for w in caught],
            "logits": logits.detach().numpy(), "loss": float(loss),
            "grads": {n: p.grad.numpy().copy() for n, p in net.named_parameters()},
            "dims": {n: p.partition_dim for n, p in net.named_parameters()}}


def _regions(rank):
    """``linear_layer`` -> gelu -> ``linear_allreduce``, the vocab-parallel
    embedding and the vocab-parallel cross entropy at model size 2."""
    from deepspeed_tpu_torch.module_inject.layers import (embedding_layer, linear_allreduce,
                                                          linear_layer)
    from deepspeed_tpu_torch.parallel import groups

    _mesh(1, 2)
    group = groups.get_model_parallel_group()
    a = _region_inputs()
    n = a["w1"].shape[1] // 2
    x = torch.from_numpy(a["x"]).requires_grad_()
    w1 = torch.from_numpy(a["w1"][:, rank * n:(rank + 1) * n].copy()).requires_grad_()
    b1 = torch.from_numpy(a["b1"][rank * n:(rank + 1) * n].copy()).requires_grad_()
    w2 = torch.from_numpy(a["w2"][rank * n:(rank + 1) * n].copy()).requires_grad_()
    b2 = torch.from_numpy(a["b2"]).requires_grad_()
    y = linear_allreduce(torch.nn.functional.gelu(linear_layer(x, w1, b1, group)), w2, b2, group)
    (y * torch.from_numpy(a["dy"])).sum().backward()
    out = {"y": y.detach().numpy(), **{k: t.grad.numpy() for k, t in
                                       (("dx", x), ("dw1", w1), ("db1", b1), ("dw2", w2),
                                        ("db2", b2))}}
    v = a["emb"].shape[0] // 2
    emb = torch.from_numpy(a["emb"][rank * v:(rank + 1) * v].copy()).requires_grad_()
    rows = embedding_layer(torch.from_numpy(a["ids"]), emb, group)
    (rows * torch.from_numpy(a["drows"])).sum().backward()
    out.update(rows=rows.detach().numpy(), demb=emb.grad.numpy())
    out["ce"] = _ce_case(rank, a)
    return out


def _region_inputs():
    rng = np.random.default_rng(30)
    f32 = np.float32
    return {"x": rng.normal(size=(3, 5, 16)).astype(f32),
            "w1": rng.normal(size=(16, 32)).astype(f32), "b1": rng.normal(size=(32, )).astype(f32),
            "w2": rng.normal(size=(32, 16)).astype(f32), "b2": rng.normal(size=(16, )).astype(f32),
            "dy": rng.normal(size=(3, 5, 16)).astype(f32),
            "emb": rng.normal(size=(256, 16)).astype(f32),
            "ids": rng.integers(0, 256, (3, 5)), "drows": rng.normal(size=(3, 5, 16)).astype(f32),
            "logits": (3 * rng.normal(size=(2, 10, 256))).astype(f32),
            "labels": np.concatenate([rng.integers(0, 128, (2, 5)), rng.integers(128, 256, (2, 5))],
                                     axis=1),
            "mask": (rng.random((2, 10)) < 0.7).astype(f32),
            "h": rng.normal(size=(2, 10, 64)).astype(f32),
            "head": (rng.normal(size=(64, 256)) / 8).astype(f32)}


def _ce_losses(a, tp=None, rank=0):
    """(the CE of ``a``'s logits, its gradient; the chunked CE over ``a``'s
    hidden states and head, the gradients of both) with ``tp`` on this
    rank's vocabulary slice, or whole."""
    v = 256 // (tp.size if tp is not None else 1)
    sl = slice(rank * v, (rank + 1) * v)
    aux = {"labels": torch.from_numpy(a["labels"]), "loss_mask": torch.from_numpy(a["mask"])}
    logits = torch.from_numpy(a["logits"][..., sl].copy()).requires_grad_()
    ce = tt._ce_loss(logits, aux, tp)
    ce.backward()
    cfg = _cfg(vocab_size=256)
    h = torch.from_numpy(a["h"]).requires_grad_()
    head = torch.from_numpy(a["head"][:, sl].copy()).requires_grad_()
    chunked = tt._chunked_ce_loss(cfg, {"lm_head": {"kernel": head}}, h, aux, 4, tp)
    chunked.backward()
    return {"ce": float(ce), "dlogits": logits.grad.numpy(), "chunked": float(chunked),
            "dh": h.grad.numpy(), "dhead": head.grad.numpy()}


def _ce_case(rank, a):
    return _ce_losses(a, tt.tensor_parallel(_cfg()), rank)


def _serving(npp):
    """``init_inference(tp_size=2)`` greedy streams (the paged route through
    ``attention_impl='flash'``, the dense one through 'reference'), the
    prefill logits and this rank's cache heads."""
    out = {}
    prompt = np.random.default_rng(40).integers(0, 256, PROMPT).astype(np.int32)
    for impl in ("flash", "reference"):
        cfg = _cfg(attention_impl=impl)
        model = TransformerLM(cfg, params_from_jax(npp, cfg, device="cpu", dtype=torch.float32))
        engine = deepspeed_tpu_torch.init_inference(
            model, {"dtype": "float32", "tensor_parallel": {"tp_size": 2}}, device="cpu")
        out[impl] = {"stream": engine.generate(prompt, max_new_tokens=NEW),
                     "logits": engine.forward(prompt).numpy(),
                     "cache_heads": tt.init_kv_cache(engine.model_config, 1, 128, device="cpu",
                                                     tp=engine.tp)["k"].shape[3],
                     "wq": tuple(engine.params["blocks"][0]["wq"].shape)}
    # a whole tree given as params: this rank's slices of it are served
    cfg = _cfg(attention_impl="flash")
    whole = params_from_jax(npp, cfg, device="cpu", dtype=torch.float32)
    engine = InferenceEngine(TransformerLM(cfg, whole), DeepSpeedInferenceConfig(
        dtype="float32", tensor_parallel={"tp_size": 2}), params=whole, device="cpu")
    out["params"] = {"stream": engine.generate(prompt, max_new_tokens=NEW),
                     "wq": tuple(engine.params["blocks"][0]["wq"].shape)}
    return out


def _worker(rank, store, npps, out_dir):
    torch.set_num_threads(1)
    from deepspeed_tpu_torch import comm

    results = {}
    try:
        _init(f"{store}4", rank, 4)
        for name in ("dp2_mp2_stage1", "dp2_mp2_stage3"):
            results[name] = _engine_case(name, npps[REFERENCE[name]])
        results["tp4"] = _model_check(npps[(2, 2)], 4)
        comm.destroy_process_group()
        if rank < 2:
            _init(f"{store}2", rank, 2)
            results["regions"] = _regions(rank)
            results["tp2"] = _model_check(npps[(2, 2)], 2, {"loss_chunk": 8})
            results["mp2_stage0"] = _engine_case("mp2_stage0", npps[(1, 2)])
            results["mp2_stage0_remat"] = _engine_case("mp2_stage0", npps[(1, 2)], remat=True)
            results["serving"] = _serving(npps[(2, 2)])
    finally:
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(results, f)
        comm.destroy_process_group()


# ---------------------------------------------------------------------------
# the references, in this process
# ---------------------------------------------------------------------------

def _jax_engine(data, model):
    """The JAX engine on ``MeshConfig(data, model)`` over ``data * model``
    virtual devices at stage 3 (stage 0 at data 1), untrained."""
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
    mesh = build_mesh(JaxMeshConfig(data=data, model=model), devices=jax.devices()[:data * model])
    je, _, _, _ = deepspeed_tpu.initialize(model=JaxLM(jcfg), config=_ds_config(
        3 if data > 1 else 0, data, model), mesh=mesh)
    return je


def _jax_train(je, data):
    import jax

    losses, norms = [], []
    for step in range(STEPS):
        losses.append(float(je.train_batch(_global_batch(step, data))))
        norms.append(float(je.get_global_grad_norm()))
    return losses, norms, jax.tree.map(np.asarray, je.state["params"])


def _jax_streams(npp):
    """The JAX package's ``init_inference(tp_size=2)`` greedy stream."""
    import jax.numpy as jnp

    from deepspeed_tpu.inference.config import DeepSpeedInferenceConfig as JaxInferenceConfig
    from deepspeed_tpu.inference.engine import InferenceEngine as JaxInferenceEngine
    from deepspeed_tpu.models import TransformerLM as JaxLM
    from deepspeed_tpu.models import mistral_config as jax_mistral_config
    from deepspeed_tpu.parallel import groups as jax_groups

    jax_groups.reset()
    jcfg = jax_mistral_config("tiny", dtype=jnp.float32, attention_impl="reference", **TINY)
    engine = JaxInferenceEngine(JaxLM(jcfg), JaxInferenceConfig(
        dtype="float32", tensor_parallel={"tp_size": 2}), params=npp)
    prompt = np.random.default_rng(40).integers(0, 256, PROMPT).astype(np.int32)
    out = np.asarray(engine.generate(prompt, max_new_tokens=NEW))
    jax_groups.reset()
    return out, dict(engine.mesh.shape)


def _world1_model(npp, over=None):
    cfg = _cfg(**(over or {}))
    net = TransformerLM(cfg, params_from_jax(npp, cfg, device="cpu", dtype=torch.float32,
                                             per_layer=True), trainable=True)
    ids = _ids(7)
    mask = torch.from_numpy((np.random.default_rng(8).random((2, SEQ)) < 0.6).astype(np.float32))
    logits = net(ids)
    loss = net.loss({"input_ids": ids, "loss_mask": mask})
    loss.backward()
    return {"logits": logits.detach().numpy(), "loss": float(loss),
            "grads": {n: p.grad.numpy().copy() for n, p in net.named_parameters()}}


def _world1_streams(npp):
    prompt = np.random.default_rng(40).integers(0, 256, PROMPT).astype(np.int32)
    out = {}
    for impl in ("flash", "reference"):
        cfg = _cfg(attention_impl=impl)
        model = TransformerLM(cfg, params_from_jax(npp, cfg, device="cpu", dtype=torch.float32))
        engine = deepspeed_tpu_torch.init_inference(model, {"dtype": "float32"}, device="cpu")
        out[impl] = {"stream": engine.generate(prompt, max_new_tokens=NEW),
                     "logits": engine.forward(prompt).numpy()}
    return out


@pytest.fixture(scope="module")
def tp_run(tmp_path_factory):
    """The ranks' results and the references."""
    import jax
    from concurrent.futures import ThreadPoolExecutor

    tmp = tmp_path_factory.mktemp("tp")
    engines = {dm: _jax_engine(*dm) for dm in sorted(set(REFERENCE.values()))}
    npps = {dm: jax.tree.map(np.asarray, je.state["params"]) for dm, je in engines.items()}
    ctx = mp.start_processes(_worker, args=(str(tmp / "store"), npps, str(tmp)), nprocs=4,
                             join=False, start_method="spawn")
    try:
        jax_streams = _jax_streams(npps[(2, 2)])
        with ThreadPoolExecutor(len(engines)) as ex:
            futures = {dm: ex.submit(_jax_train, je, dm[0]) for dm, je in engines.items()}
            world1 = {"tp4": _world1_model(npps[(2, 2)]),
                      "tp2": _world1_model(npps[(2, 2)], {"loss_chunk": 8}),
                      "streams": _world1_streams(npps[(2, 2)]), "ce": _ce_losses(_region_inputs())}
            refs = {dm: f.result() for dm, f in futures.items()}
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
    for r in range(4):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return {"ranks": ranks, "refs": refs, "world1": world1, "jax_streams": jax_streams}


def _assert_params_close(ours, ref):
    tree = {}
    for name, v in ours.items():  # "tree.<group>.<name>" / "tree.blocks.<l>.<name>"
        parts = name.split(".")[1:]
        if parts[0] == "blocks":
            tree.setdefault("blocks", [dict() for _ in range(TINY["num_layers"])])
            tree["blocks"][int(parts[1])][parts[2]] = torch.from_numpy(v)
        else:
            tree.setdefault(parts[0], {})[parts[1]] = torch.from_numpy(v)
    got = params_to_numpy(tree)
    for group in ref:
        for leaf in ref[group]:
            np.testing.assert_allclose(got[group][leaf], ref[group][leaf], rtol=2e-4, atol=2e-6,
                                       err_msg=f"{group}/{leaf}")


def _case_ranks(tp_run, name):
    return [r[name] for r in tp_run["ranks"] if name in r]


# ---------------------------------------------------------------------------
# the engine against the JAX engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(CASES))
def test_tensor_parallel_engine_matches_the_jax_engine(tp_run, name):
    """Losses and gradient norms (rtol 2e-5; the norms near 10, so the
    clip at 1.0 acts) and the final whole parameters (rtol 2e-4 / atol
    2e-6) on every rank against the JAX engine on the same mesh and global
    batch; the ranks agree on the loss."""
    data, model, _, _ = CASES[name]
    ref_losses, ref_norms, ref_params = tp_run["refs"][REFERENCE[name]]
    ranks = _case_ranks(tp_run, name)
    assert len(ranks) == data * model
    for r in ranks:
        assert r["dp_mp"] == (data, model)
        np.testing.assert_allclose(r["losses"], ref_losses, rtol=2e-5)
        np.testing.assert_allclose(r["norms"], ref_norms, rtol=2e-5)
        _assert_params_close(r["params"], ref_params)
        assert r["losses"] == ranks[0]["losses"]
    assert min(ref_norms) > 1.0  # clipping is active


@pytest.mark.parametrize("name", list(CASES))
def test_replicated_leaves_are_equal_on_every_rank_after_every_step(tp_run, name):
    """Norm scales (and any leaf the plan replicates) are updated alike on
    every model rank: bit-equal after each step; the split leaves hold half
    the whole width."""
    ranks = _case_ranks(tp_run, name)
    for step in range(STEPS):
        want = ranks[0]["replicated"][step]
        assert want and all(n.endswith(("ln1_scale", "ln2_scale", "final_norm.scale"))
                            for n in want)
        for r in ranks[1:]:
            for n, v in want.items():
                assert np.array_equal(r["replicated"][step][n], v), (step, n)
    if CASES[name][2] != 3:
        shapes = ranks[0]["local_shapes"]
        assert shapes["tree.blocks.0.wq"] == (64, 32) and shapes["tree.blocks.0.wo"] == (32, 64)
        assert shapes["tree.embed.embedding"] == (128, 64)
        assert shapes["tree.lm_head.kernel"] == (64, 128)
        assert shapes["tree.blocks.0.ln1_scale"] == (64, )


def test_remat_at_model_size_two_is_bit_equal(tp_run):
    """``remat`` at model 2: the recompute runs the block's all-reduces
    again, in the same order on every rank, to the same numbers."""
    for plain, remat in zip(_case_ranks(tp_run, "mp2_stage0"),
                            _case_ranks(tp_run, "mp2_stage0_remat")):
        assert remat["losses"] == plain["losses"] and remat["norms"] == plain["norms"]
        for k, v in plain["params"].items():
            assert np.array_equal(remat["params"][k], v), k


# ---------------------------------------------------------------------------
# the model against world size 1
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size", [2, 4])
def test_model_at_model_size_n_equals_world_size_one(tp_run, size):
    """Logits (gathered whole), the masked loss and every gradient (this
    rank's slice of the whole gradient) against world size 1, rtol 1e-5.
    At 2 every branch splits (and the loss is the chunked CE); at 4 TINY's
    2 kv heads do not divide, so attention runs replicated, with a
    warning."""
    name = f"tp{size}"
    want = tp_run["world1"][name]
    ranks = _case_ranks(tp_run, name)
    assert len(ranks) == size
    for rank, r in enumerate(ranks):
        if size == 4:
            assert r["flags"] == (False, True, True)
            assert any("attention runs replicated" in w for w in r["warned"])
        else:
            assert r["flags"] == (True, True, True) and not r["warned"]
        np.testing.assert_allclose(r["logits"], want["logits"], rtol=1e-5,
                                   atol=1e-5 * np.abs(want["logits"]).max())
        np.testing.assert_allclose(r["loss"], want["loss"], rtol=1e-5)
        for n, g in want["grads"].items():
            d = r["dims"][n]
            part = g if d is None else np.split(g, size, axis=d)[rank]
            np.testing.assert_allclose(r["grads"][n], part, rtol=1e-5,
                                       atol=1e-5 * np.abs(g).max(), err_msg=n)


def test_column_then_row_linear_equals_the_unsplit_product(tp_run):
    """``linear_layer`` -> gelu -> ``linear_allreduce`` at model 2: the output
    and the gradients of the input (summed in the column region's
    backward), both weights and both biases equal the unsplit product's."""
    a = _region_inputs()
    ts = {k: torch.from_numpy(a[k]).requires_grad_() for k in ("x", "w1", "b1", "w2", "b2")}
    y = torch.nn.functional.gelu(ts["x"] @ ts["w1"] + ts["b1"]) @ ts["w2"] + ts["b2"]
    (y * torch.from_numpy(a["dy"])).sum().backward()
    for rank, r in enumerate(_case_ranks(tp_run, "regions")):
        n = 16
        np.testing.assert_allclose(r["y"], y.detach().numpy(), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(r["dx"], ts["x"].grad.numpy(), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(r["dw1"], ts["w1"].grad.numpy()[:, rank * n:(rank + 1) * n],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(r["db1"], ts["b1"].grad.numpy()[rank * n:(rank + 1) * n],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(r["dw2"], ts["w2"].grad.numpy()[rank * n:(rank + 1) * n],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(r["db2"], ts["b2"].grad.numpy(), rtol=1e-5)


def test_vocab_parallel_embedding_equals_the_lookup(tp_run):
    a = _region_inputs()
    emb = torch.from_numpy(a["emb"]).requires_grad_()
    rows = emb[torch.from_numpy(a["ids"])]
    (rows * torch.from_numpy(a["drows"])).sum().backward()
    for rank, r in enumerate(_case_ranks(tp_run, "regions")):
        np.testing.assert_array_equal(r["rows"], rows.detach().numpy())
        np.testing.assert_allclose(r["demb"], emb.grad.numpy()[rank * 128:(rank + 1) * 128],
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kind", ["ce", "chunked"])
def test_vocab_parallel_cross_entropy_equals_the_whole_row(tp_run, kind):
    """The masked CE with labels on both ranks' halves of the vocabulary,
    unchunked (``_ce_loss`` on this rank's logits) and chunked (each chunk's
    logits this rank's slice): the loss and the gradients (logits / hidden
    states and head) equal ``_ce_loss`` on the whole logits, rtol 1e-5."""
    want = tp_run["world1"]["ce"]
    for rank, r in enumerate(_case_ranks(tp_run, "regions")):
        got = r["ce"]
        np.testing.assert_allclose(got[kind], want[kind], rtol=1e-5)
        sl = slice(rank * 128, (rank + 1) * 128)
        if kind == "ce":
            np.testing.assert_allclose(got["dlogits"], want["dlogits"][..., sl], rtol=1e-5,
                                       atol=1e-7)
        else:
            np.testing.assert_allclose(got["dh"], want["dh"], rtol=1e-5, atol=1e-7)
            np.testing.assert_allclose(got["dhead"], want["dhead"][:, sl], rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["flash", "reference"])
def test_init_inference_tp2_streams_equal_tp1_and_the_jax_engine(tp_run, impl):
    """Greedy streams of ``init_inference(tp_size=2)`` on both ranks equal
    the port's ``tp_size 1`` streams and the JAX package's
    ``init_inference(tp_size=2)``; the prefill logits (gathered) equal
    ``tp_size 1``'s; each rank's cache holds 1 of the 2 kv heads and its
    ``wq`` 2 of the 4 query heads."""
    want = tp_run["world1"]["streams"][impl]
    jax_stream, jax_mesh = tp_run["jax_streams"]
    assert jax_mesh["model"] == 2
    for r in _case_ranks(tp_run, "serving"):
        got = r[impl]
        np.testing.assert_array_equal(got["stream"], want["stream"])
        np.testing.assert_array_equal(got["stream"], jax_stream)
        np.testing.assert_allclose(got["logits"], want["logits"], rtol=1e-5, atol=1e-5)
        assert got["cache_heads"] == 1 and got["wq"] == (64, 32)
        if impl == "flash":  # the engine given the whole tree as params
            np.testing.assert_array_equal(r["params"]["stream"], want["stream"])
            assert r["params"]["wq"] == (64, 32)


# ---------------------------------------------------------------------------
# in this process: the surface, the rules, the refusals
# ---------------------------------------------------------------------------

def test_auto_tp_specs_on_the_port_trees():
    """AutoTP's policies (``tests/test_module_inject.py:20``): q/k/v and the
    MLP input column-split, attention output and MLP output row-split, on
    the stacked serving tree and the per-layer tree; norms and embeddings
    replicated."""
    from deepspeed_tpu_torch.module_inject import AutoTP
    from deepspeed_tpu_torch.module_inject.policies import COL, COL3, ROW, ROW3

    cfg = _cfg()
    stacked = TransformerLM(cfg, device="cpu").params()
    specs = AutoTP(model_type="llama").tree_specs(stacked)
    assert specs["blocks"]["wq"] == COL3 == (None, None, "model")
    assert specs["blocks"]["w_up"] == COL3 and specs["blocks"]["w_gate"] == COL3
    assert specs["blocks"]["wo"] == ROW3 == (None, "model", None)
    assert specs["blocks"]["w_down"] == ROW3
    assert specs["blocks"]["ln1_scale"] == (None, None)
    assert specs["embed"]["embedding"] == (None, None)
    layered = AutoTP(model_type="mistral").tree_specs(
        TransformerLM(cfg, device="cpu", trainable=True).params())
    assert layered["blocks"][1]["wk"] == COL and layered["blocks"][1]["w_down"] == ROW
    assert AutoTP.kernel_supported([]) and AutoTP().partition_rules().spec_for(
        "blocks/wq", 3) == COL3


def test_auto_tp_shard_slices_the_policy_dims():
    from deepspeed_tpu_torch.module_inject import AutoTP

    params = TransformerLM(_cfg(), device="cpu").params()
    for rank in (0, 1):
        got = AutoTP(model_type="llama").shard(params, rank, 2)
        cols = slice(rank * 32, (rank + 1) * 32)
        assert torch.equal(got["blocks"]["wq"], params["blocks"]["wq"][:, :, cols])
        assert torch.equal(got["blocks"]["wo"], params["blocks"]["wo"][:, cols])
        assert got["embed"]["embedding"] is params["embed"]["embedding"]
    with pytest.warns(UserWarning, match="not divisible by mesh axis 'model'"):
        three = AutoTP(model_type="llama").shard(params, 0, 3)
    assert three["blocks"]["wq"] is params["blocks"]["wq"]  # 32 columns over 3: left whole


def test_tensor_slicing_copy_and_qkv_copy():
    """``ReplaceWithTensorSlicing`` (``tests/test_module_inject.py:55-87``)."""
    from deepspeed_tpu_torch.module_inject import ReplaceWithTensorSlicing

    mp4 = ReplaceWithTensorSlicing(mp_size=4)
    w = torch.arange(32 * 16, dtype=torch.float32).reshape(32, 16)
    assert torch.equal(mp4.copy((32, 4), w, rank=1), w[:, 4:8])  # column split
    assert torch.equal(mp4.copy((8, 16), w, rank=2), w[16:24])  # row split
    assert torch.equal(mp4.copy((32, 16), w, rank=0), w)  # replicated
    with pytest.raises(ValueError):
        mp4.copy((32, 5), w)
    h = 8
    fused = torch.cat([torch.full((h, h), float(i)) for i in (1, 2, 3)], dim=1)
    rank0 = ReplaceWithTensorSlicing(mp_size=2).qkv_copy((h, 3 * h // 2), fused, rank=0)
    assert rank0.shape == (h, 12)
    for i, value in enumerate((1.0, 2.0, 3.0)):  # each of q, k, v gives its own half
        assert torch.equal(rank0[:, 4 * i:4 * (i + 1)], torch.full((h, 4), value))


def test_tp_shard_sizes():
    """``tp_shard`` (``tests/test_module_inject.py:235-251``): even sizes
    without a kv-head count; kv-head-aware uneven sizes that always sum to
    the total."""
    from deepspeed_tpu_torch.module_inject.tp_shard import (get_shard_size, get_shard_size_list,
                                                            set_num_kv_heads)

    try:
        set_num_kv_heads(None)
        assert get_shard_size(64, 4) == 16
        with pytest.raises(AssertionError):
            get_shard_size(10, 4)
        set_num_kv_heads(6)  # over 4 ranks: the first two take 2 heads
        assert get_shard_size_list(96, 4) == [32, 32, 16, 16]
        set_num_kv_heads(3)
        assert sum(get_shard_size_list(10, 2)) == 10
    finally:
        set_num_kv_heads(None)


class _FakeMesh:
    """A ``DeviceMesh``'s surface at rank ``rank`` of a model axis of 2."""
    mesh_dim_names = ("data", "model")

    def __init__(self, rank):
        self.rank = rank

    def size(self, dim):
        return (1, 2)[dim]

    def get_local_rank(self, name):
        return self.rank

    def get_group(self, name):
        return None


def test_replace_transformer_layer_flips_kernels_and_slices():
    """Kernel injection flips ``attention_impl`` and back; at a model size
    above 1 a parameter tree is cut by AutoTP."""
    from deepspeed_tpu_torch.module_inject import revert_transformer_layer

    model = TransformerLM(_cfg(), device="cpu")
    out, none = deepspeed_tpu_torch.replace_transformer_layer(model=model, model_type="llama")
    assert out is model and none is None and model.config.attention_impl == "auto"
    revert_transformer_layer(model=model)
    assert model.config.attention_impl == "reference"
    params = model.params()
    _, cut = deepspeed_tpu_torch.replace_transformer_layer(model=model, params=params,
                                                           mesh=_FakeMesh(1), model_type="llama")
    assert torch.equal(cut["blocks"]["wv"], params["blocks"]["wv"][:, :, 16:])
    assert cut["final_norm"]["scale"] is params["final_norm"]["scale"]
    with pytest.raises(NotImplementedError, match="A7"):
        deepspeed_tpu_torch.replace_transformer_layer(model=model, quantize=True)


def test_partition_rules_and_the_slicing_helper():
    """The port's table (the reference's in per-layer form): every split
    leaf of a whole tree sliced along its rule's dim, the rest kept; the
    stacked serving tree sliced one dim further; the rank's head counts."""
    from deepspeed_tpu_torch.runtime.zero.partition import sanitize_spec

    cfg = _cfg(use_bias=True, qkv_bias=True)
    rules = tt.partition_rules(cfg)
    assert rules.spec_for("blocks/wq", 2) == (None, "model")
    assert rules.spec_for("blocks/bo", 1) == (None, )
    assert rules.spec_for("embed/embedding", 2) == ("model", None)
    stacked_specs = rules.tree_specs(TransformerLM(cfg, device="cpu").params())
    assert stacked_specs["blocks"]["wo"] == (None, "model", None)
    assert stacked_specs["blocks"]["b_up"] == (None, "model")
    assert sanitize_spec(("model", None), (6, 4), {"model": 4}) == (None, None)
    full = TransformerLM(cfg, device="cpu", trainable=True).params()
    for rank in (0, 1):
        tp = tt.tensor_parallel(cfg, size=2, rank=rank)
        assert tp.heads(cfg) == (2, 1, 2 * rank)
        got = tensor_parallel_shards(full, tp)
        for name, d in (("wq", 1), ("bq", 0), ("wo", 0), ("w_down", 0), ("b_up", 0)):
            w = full["blocks"][1][name]
            n = w.shape[d] // 2
            assert torch.equal(got["blocks"][1][name], w.narrow(d, rank * n, n)), name
        for name in ("bo", "b_down", "ln2_scale"):
            assert got["blocks"][0][name] is full["blocks"][0][name]
        assert got["embed"]["embedding"].shape == (128, 64)
        stacked = tensor_parallel_shards(TransformerLM(cfg, device="cpu").params(), tp)
        assert stacked["blocks"]["wk"].shape == (2, 64, 16)


def test_unported_features_under_tensor_parallelism_are_refused():
    """MoE blocks and block-sparse attention name A3b's open items;
    ``sequence_parallel`` names A8; a TP model is not served at tp_size 1;
    a tp_size that does not divide the world raises."""
    with pytest.raises(NotImplementedError, match="MoE blocks at model size 2.*A3b, left open"):
        tt.tensor_parallel(_cfg(moe_num_experts=4, moe_top_k=2), size=2)
    sparse = llama2_config("tiny", num_heads=4, num_kv_heads=4, hidden_size=64, num_layers=1,
                           intermediate_size=128, vocab_size=256, max_seq_len=64,
                           sparse_attention={"mode": "fixed", "block": 16})
    with pytest.raises(NotImplementedError, match="sparse_attention at model size 2.*A3b, left "
                                                  "open"):
        tt.tensor_parallel(sparse, size=2)
    seq_cfg = _cfg()
    seq_cfg.sequence_parallel = True
    with pytest.raises(NotImplementedError, match="A8"):
        tt.tensor_parallel(seq_cfg, size=2)
    model = TransformerLM(_cfg(), device="cpu")
    with pytest.raises(ValueError, match="does not divide the world size 1"):
        deepspeed_tpu_torch.init_inference(model, {"tensor_parallel": {"tp_size": 2}},
                                           device="cpu")
    model.tp = tt.tensor_parallel(_cfg(), size=2)
    with pytest.raises(ValueError, match="serve it at tp_size 2"):
        deepspeed_tpu_torch.init_inference(model, {}, device="cpu")


def test_mesh_of_two_axes_puts_model_innermost():
    """``build_mesh`` at ``data 2 x model 2`` (a fake process group of 4 in
    this process): rank ``d * 2 + m`` is data index d, model index m; the
    groups' getters read it."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from deepspeed_tpu_torch.parallel import groups
    from deepspeed_tpu_torch.parallel.mesh import build_mesh

    dist.init_process_group("fake", rank=3, world_size=4, store=FakeStore())
    try:
        mesh = build_mesh(MeshConfig(data=2, model=2), 4, "cpu")
        assert mesh.mesh_dim_names == ("data", "model")
        assert mesh.mesh.tolist() == [[0, 1], [2, 3]]
        assert (mesh.get_local_rank("data"), mesh.get_local_rank("model")) == (1, 1)
        kept = groups.initialize_mesh(MeshConfig(data=-1, model=2), "cpu")
        assert groups.initialize_mesh(MeshConfig(data=2, model=2), "cpu") is kept  # not rebuilt
        assert (groups.get_data_parallel_world_size(), groups.get_model_parallel_world_size(),
                groups.get_data_parallel_rank(), groups.get_model_parallel_rank()) == (2, 2, 1, 1)
        assert dist.get_process_group_ranks(groups.get_model_parallel_group()) == [2, 3]
        assert dist.get_process_group_ranks(groups.get_data_parallel_group()) == [1, 3]
        assert groups.get_expert_parallel_group() is groups.get_data_parallel_group()
    finally:
        dist.destroy_process_group()
        groups.initialize_mesh(MeshConfig(), "cpu")  # world size 1: no mesh
    assert groups.get_model_parallel_world_size() == 1 and groups.get_mesh() is None

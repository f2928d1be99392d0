"""PyTorch port: ZeRO-Offload (``runtime/zero/offload.py``), its host ops
(``ops/adam/cpu_adam.py``, ``ops/aio``) and the NVMe tier
(``runtime/swap_tensor/``) against the JAX package on the CPU.

The host Adam is the same C++ source built with the same flags in both
packages, so its updates, and the host optimizer's over them, agree bit for
bit (with the overflow skip and the clip folded into the gradient scale).
The twin-flow split picks the JAX function's tensors. Three offloaded
``train_batch`` steps (``cpu``, ``nvme``, ratio 0.5) of a tiny Mistral
follow the JAX engine with the same ``offload_optimizer`` block at the
tolerances of ``tests/test_torch_engine.py`` (losses rtol 2e-5, parameters
rtol 2e-4 / atol 2e-6), and the eager API equals ``train_batch`` bit for
bit. Checkpointing under offload is A9 and not tested here.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import TransformerLM as JaxLM
from deepspeed_tpu.models import mistral_config as jax_mistral_config
from deepspeed_tpu.parallel.mesh import single_device_mesh
from deepspeed_tpu_torch.models import (TransformerLM, mistral_config, params_from_jax,
                                        params_to_numpy)

TINY = dict(num_layers=2, hidden_size=64, num_heads=4, num_kv_heads=2, intermediate_size=128,
            vocab_size=256, max_seq_len=256, sliding_window=16)


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# the host ops
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("adamw,wd,scale", [(True, 0.1, 1.0), (False, 0.1, 0.5), (True, 0.0, 0.25)])
def test_cpu_adam_bit_equal_to_jax(adamw, wd, scale):
    from deepspeed_tpu.ops.adam.cpu_adam import DeepSpeedCPUAdam as JaxCPUAdam
    from deepspeed_tpu_torch.ops.adam.cpu_adam import DeepSpeedCPUAdam

    n = 100_003  # two threads' chunks and a ragged end
    ref = [_rand(0, n), np.zeros(n, np.float32), np.zeros(n, np.float32)]
    ours = [torch.from_numpy(a.copy()) for a in ref]
    jopt = JaxCPUAdam(lr=1e-3, weight_decay=wd, adamw_mode=adamw)
    topt = DeepSpeedCPUAdam(lr=1e-3, weight_decay=wd, adamw_mode=adamw)
    bf_ref, bf_ours = np.empty(n, np.uint16), torch.empty(n, dtype=torch.bfloat16)
    for step in (1, 2, 3):
        g = _rand(10 + step, n)
        lr = 1e-3 * step
        jopt.step(step, ref[0], g, ref[1], ref[2], lr=lr, grad_scale=scale, bf16_out=bf_ref)
        topt.step(step, ours[0], torch.from_numpy(g), ours[1], ours[2], lr=lr,
                  grad_scale=scale, bf16_out=bf_ours)
    for a, t in zip(ref, ours):
        assert np.array_equal(a, t.numpy())
    assert np.array_equal(bf_ref, bf_ours.view(torch.int16).numpy().view(np.uint16))
    jopt.fp32_to_bf16(ref[0], bf_ref)
    topt.fp32_to_bf16(ours[0], bf_ours)
    assert np.array_equal(bf_ref, bf_ours.view(torch.int16).numpy().view(np.uint16))
    with pytest.raises(ValueError, match="contiguous"):
        topt.step(4, ours[0][::2], ours[1][::2], ours[1][::2], ours[2][::2])


def test_aio_round_trip_offset_and_error(tmp_path):
    from deepspeed_tpu_torch.ops.aio import AsyncIOHandle

    h = AsyncIOHandle(thread_count=4)
    tensors = [torch.from_numpy(_rand(i, 10_000)) for i in range(4)]
    for i, t in enumerate(tensors):
        h.async_pwrite(t, str(tmp_path / f"f{i}.bin"))
    h.async_pwrite(np.arange(1000, dtype=np.float32), str(tmp_path / "x.bin"))
    h.wait()
    outs = [torch.empty_like(t) for t in tensors]
    for i, o in enumerate(outs):
        h.async_pread(o, str(tmp_path / f"f{i}.bin"))
    assert h.pending() >= 0
    h.wait()
    assert all(torch.equal(a, b) for a, b in zip(tensors, outs))
    part = torch.empty(500, dtype=torch.float32)
    h.sync_pread(part, str(tmp_path / "x.bin"), file_offset=500 * 4)
    assert np.array_equal(part.numpy(), np.arange(500, 1000, dtype=np.float32))
    h.sync_pwrite(part, str(tmp_path / "y.bin"), file_offset=4)
    assert os.path.getsize(tmp_path / "y.bin") == 4 + 2000
    with pytest.raises(OSError):
        h.async_pread(part, str(tmp_path / "missing.bin"))
        h.wait()
    h.close()


def test_the_three_swappers(tmp_path):
    from deepspeed_tpu_torch.runtime.swap_tensor import (AsyncPartitionedParameterSwapper,
                                                         AsyncTensorSwapper,
                                                         OptimizerStateSwapper)

    sw = AsyncTensorSwapper(max_inflight=2)
    pairs = [(torch.from_numpy(_rand(i, 256)), str(tmp_path / "out" / f"t{i}.bin"))
             for i in range(5)]
    sw.swap_out_tensors(pairs)
    sw.shutdown()
    assert sw.swap_bytes == 5 * 256 * 4
    for t, path in pairs:
        assert np.array_equal(np.fromfile(path, np.float32), t.numpy())

    ps = AsyncPartitionedParameterSwapper(str(tmp_path))
    w = torch.from_numpy(_rand(7, 8, 16))
    ps.swap_out("blocks/0.wq", w, async_op=False)
    assert ps.available_params() == {"blocks/0.wq"}
    assert torch.equal(ps.swap_in("blocks/0.wq", async_op=False), w)
    assert ps.swap_in("blocks/0.wq") is None
    ps.synchronize_reads()
    assert torch.equal(ps.retrieve("blocks/0.wq"), w)
    ps.remove("blocks/0.wq")
    assert not ps.available_params()
    with pytest.raises(KeyError):
        ps.swap_in("blocks/0.wq")

    for pipelined in (True, False):
        st = OptimizerStateSwapper(str(tmp_path / f"p{pipelined}"), pipeline_read=pipelined,
                                   pipeline_write=pipelined)
        st.initialize("w1", (128,))
        st.initialize("w2", (64,))
        st.flush_writes()
        st.prefetch("w1")
        got = st.fetch("w1")
        assert set(got) == {"exp_avg", "exp_avg_sq"} and not got["exp_avg"].any()
        got["exp_avg"] += 1.5
        st.writeback("w1", got)
        st.flush()
        assert torch.equal(st.fetch("w1")["exp_avg"], torch.full((128,), 1.5))
        sd = st.state_dict()
        st2 = OptimizerStateSwapper(str(tmp_path / f"q{pipelined}"))
        st2.load_state_dict(sd)
        assert st2.has("w2") and torch.equal(st2.fetch("w1")["exp_avg"], sd["w1"]["exp_avg"])


# ---------------------------------------------------------------------------
# the host optimizer and the twin-flow split
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("nvme", [False, True])
def test_host_offload_optimizer_bit_equal_to_jax(tmp_path, nvme):
    from deepspeed_tpu.runtime.zero.offload import HostOffloadOptimizer as JaxHost
    from deepspeed_tpu_torch.runtime.zero.offload import HostOffloadOptimizer

    tree = {"a": _rand(1, 33, 7), "b": _rand(2, 70_000), "c": _rand(3, 5)}
    kw = dict(lr=1e-3, weight_decay=0.01, grad_clip=1.0)
    ref = JaxHost(tree, nvme_path=str(tmp_path / "jax") if nvme else None, **kw)
    params = [torch.from_numpy(tree[k].copy()) for k in sorted(tree)]
    ours = HostOffloadOptimizer(params, nvme_path=str(tmp_path / "torch") if nvme else None,
                                keys=sorted(tree), **kw)
    assert all(m.data_ptr() != p.data_ptr() for m, p in zip(ours.masters.values(), params))
    for step, gscale in ((1, 4.0), (2, 4.0), (3, 0.1), (4, 4.0)):
        grads = {k: _rand(100 + step + i, *v.shape) * gscale
                 for i, (k, v) in enumerate(tree.items())}
        if step == 3:
            grads["b"][17] = np.inf  # overflow: the step is skipped
        out, jnorm, jover = ref.step(step if step < 3 else step - 1, grads, lr=1e-3 * step,
                                     loss_scale=2.0)
        norm, over = ours.step(step if step < 3 else step - 1,
                               [torch.from_numpy(grads[k]) for k in sorted(tree)],
                               lr=1e-3 * step, loss_scale=2.0)
        assert over == jover == (step == 3)
        assert norm == jnorm or not np.isfinite(norm)
        for k, p in zip(sorted(tree), params):  # the upload: params hold the masters
            assert np.array_equal(p.numpy(), ref.masters[k].reshape(p.shape)), (step, k)
    for got, want in zip(ours.rebuild_params(), jax.tree_util.tree_leaves(ref.rebuild_params())):
        assert np.array_equal(got.numpy(), want)
    sd, jsd = ours.state_dict(), ref.state_dict()
    for part in ("masters", "exp_avg", "exp_avg_sq"):
        for k in tree:
            assert np.array_equal(sd[part][k].numpy(), jsd[part][k]), (part, k)
    ours.load_state_dict(sd)
    assert all(torch.equal(a, b) for a, b in zip(ours.rebuild_params(), params))


def _jax_shapes(over=None):
    cfg = jax_mistral_config("tiny", dtype=jnp.float32, **dict(TINY, **(over or {})))
    model = JaxLM(cfg)
    ids = jnp.zeros((1, 8), jnp.int32)
    return jax.eval_shape(lambda r: model.init(r, {"input_ids": ids}), jax.random.PRNGKey(0))


@pytest.mark.parametrize("ratio", [0.1, 0.5, 0.9])
def test_partition_leaves_by_ratio_picks_the_jax_tensors(ratio):
    from deepspeed_tpu.runtime.zero.offload import partition_leaves_by_ratio as jax_split
    from deepspeed_tpu_torch.runtime.zero.offload import partition_leaves_by_ratio

    shapes = _jax_shapes({"num_layers": 3, "vocab_size": 1000})
    want = jax.tree_util.tree_leaves(jax_split(shapes, ratio))
    leaves = jax.tree_util.tree_leaves(shapes)
    sizes = [int(np.prod(l.shape)) * 4 for l in leaves]
    assert partition_leaves_by_ratio(sizes, ratio) == want
    tensors = [torch.empty(l.shape) for l in leaves]
    assert partition_leaves_by_ratio(tensors, ratio) == want
    # a dominant leaf does not take the whole host share, and ratio > 0 is never empty
    assert partition_leaves_by_ratio([1000, 1, 1], 0.1) == [False, True, True]
    assert partition_leaves_by_ratio([1000], 0.1) == [True]


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
def _ds_config(offload, optimizer="AdamW", **over):
    cfg = {"train_batch_size": 8, "train_micro_batch_size_per_gpu": 2,
           "gradient_accumulation_steps": 4,
           "optimizer": {"type": optimizer, "params": {"lr": 1e-4, "weight_decay": 0.1}},
           "scheduler": {"type": "WarmupLR", "params": {"warmup_num_steps": 2,
                                                        "warmup_max_lr": 1e-4,
                                                        "warmup_type": "linear"}},
           "gradient_clipping": 1.0, "steps_per_print": 100,
           "tpu": {"pallas_fused_adam": "never"},
           "zero_optimization": {"stage": 0, "offload_optimizer": offload}}
    cfg.update(over)
    return cfg


def _port_model(params=None, seed=5):
    tcfg = mistral_config("tiny", dtype=torch.float32, attention_impl="reference", **TINY)
    if params is None:
        return TransformerLM(tcfg, device="cpu", trainable=True, seed=seed)
    return TransformerLM(tcfg, params_from_jax(params, tcfg, device="cpu", dtype=torch.float32,
                                               per_layer=True), trainable=True)


def _batch(seed):
    return {"input_ids": np.random.default_rng(seed).integers(0, 256, (8, 24)).astype(np.int32)}


@pytest.mark.parametrize("device,ratio", [("cpu", 1.0), ("nvme", 1.0), ("cpu", 0.5)])
def test_offloaded_train_batch_matches_jax_engine(tmp_path, device, ratio):
    def block(side):
        b = {"device": device, "ratio": ratio}
        if device == "nvme":
            b.update(nvme_path=str(tmp_path / side), pipeline_read=True, pipeline_write=True)
        return b

    jcfg = jax_mistral_config("tiny", dtype=jnp.float32, attention_impl="reference", **TINY)
    je, _, _, _ = deepspeed_tpu.initialize(model=JaxLM(jcfg), config=_ds_config(block("jax")),
                                           mesh=single_device_mesh())
    te, opt, _, _ = deepspeed_tpu_torch.initialize(
        model=_port_model(jax.tree.map(np.asarray, je.state["params"])),
        config=_ds_config(block("torch")))
    assert te.host_optimizer is not None and opt is te.host_optimizer
    assert te._pallas_adam is None and (te.host_optimizer.swapper is not None) == (device == "nvme")
    if ratio < 1.0:  # the host takes the JAX engine's leaves
        names = {id(p): n for n, p in te.module.named_parameters()}
        for p, on_host in zip(te._params, te._twin_host):
            parts = names[id(p)].split(".")
            assert on_host == je._twin_mask[parts[1]][parts[-1]], names[id(p)]
        assert 0 < sum(te._twin_host) < len(te._params)
    for step in range(3):
        b = _batch(step)
        lj = float(je.train_batch(b))
        lt = float(te.train_batch(b))
        np.testing.assert_allclose(lt, lj, rtol=2e-5)
    ours = params_to_numpy(te.module.params())
    ref = jax.tree.map(np.asarray, je.state["params"])
    for group in ref:
        for name in ref[group]:
            np.testing.assert_allclose(ours[group][name], ref[group][name], rtol=2e-4, atol=2e-6,
                                       err_msg=f"{group}/{name}")
    assert te.global_steps == 3 and int(te.state["step"]) == int(je.state["step"]) == 3
    assert set(te.offload_times) >= {"to_norm_ms", "host_adam_ms", "d2h_wait_ms", "upload_ms"}


def test_offload_eager_api_equals_train_batch_and_skips_overflow(tmp_path):
    engines = [deepspeed_tpu_torch.initialize(
        model=_port_model(), config=_ds_config({"device": "cpu", "ratio": 0.5}))[0]
        for _ in range(2)]
    eager, tb = engines
    gas = eager.gradient_accumulation_steps()
    for step in range(2):
        b = _batch(20 + step)
        tb.train_batch(b)
        for i in range(gas):
            eager.backward(eager.forward({"input_ids": b["input_ids"][2 * i:2 * i + 2]}))
            eager.step()
    for p, q in zip(eager._params, tb._params):
        assert torch.equal(p, q)
    assert eager.global_steps == tb.global_steps == 2
    # a non-finite gradient skips the update on both halves and counts the skip
    before = [p.detach().clone() for p in tb._params]
    with torch.no_grad():
        tb._params[0].mul_(float("nan"))
    tb.train_batch(_batch(30))
    assert tb.skipped_steps == 1 and int(tb.state["step"]) == 2
    assert all(torch.equal(p, q) for p, q in zip(tb._params[1:], before[1:]))


def test_offload_refusals(monkeypatch, tmp_path):
    from deepspeed_tpu_torch.runtime import engine as engine_mod

    with pytest.raises(NotImplementedError, match="offload_param.*ROADMAP A6.6, left open"):
        deepspeed_tpu_torch.DeepSpeedConfig({"train_batch_size": 2, "zero_optimization": {
            "stage": 3, "offload_param": {"device": "cpu"}}})
    with pytest.raises(NotImplementedError, match="offload_param"):
        deepspeed_tpu_torch.DeepSpeedConfig({"train_batch_size": 2, "zero_optimization": {
            "cpu_offload_param": True}})
    with pytest.raises(ValueError, match="twin-flow"):
        deepspeed_tpu_torch.initialize(model=_port_model(), config=_ds_config(
            {"device": "cpu", "ratio": 0.5}, optimizer="Lamb"))
    monkeypatch.setattr(engine_mod.groups, "get_data_parallel_world_size", lambda: 2)
    with pytest.raises(NotImplementedError, match="ROADMAP A6.6, left open: per-rank shards"):
        deepspeed_tpu_torch.initialize(model=_port_model(),
                                       config=_ds_config({"device": "cpu"}, train_batch_size=16))


def test_offload_config_aliases_and_fallbacks(caplog):
    cfg = deepspeed_tpu_torch.DeepSpeedConfig({"train_batch_size": 2, "zero_optimization": {
        "stage": 2, "cpu_offload": True}})
    assert cfg.zero_config.offload_optimizer_device == "cpu"
    with pytest.raises(deepspeed_tpu_torch.DeepSpeedConfigError, match="nvme_path"):
        deepspeed_tpu_torch.DeepSpeedConfig({"train_batch_size": 2, "zero_optimization": {
            "offload_optimizer": {"device": "nvme"}}})
    with pytest.raises(deepspeed_tpu_torch.DeepSpeedConfigError, match="ratio"):
        deepspeed_tpu_torch.DeepSpeedConfig({"train_batch_size": 2, "zero_optimization": {
            "offload_optimizer": {"device": "cpu", "ratio": 1.5}}})
    # ratio 0 offloads nothing; a non-Adam name runs as the host AdamW
    e0 = deepspeed_tpu_torch.initialize(model=_port_model(), config=_ds_config(
        {"device": "cpu", "ratio": 0.0}))[0]
    assert e0.host_optimizer is None
    with caplog.at_level("WARNING", logger="deepspeed_tpu_torch"):
        e1 = deepspeed_tpu_torch.initialize(model=_port_model(), config=_ds_config(
            {"device": "cpu"}, optimizer="Lion"))[0]
    assert e1.host_optimizer is not None and "using fused CPU AdamW" in caplog.text
    assert e1.zero_resident_bytes()["moments"] == 0

"""PyTorch port: training the model families through ``initialize`` ->
``train_batch`` against the JAX engine.

Both engines start from the JAX engine's initial parameters (moved with
``params_from_jax(per_layer=True)``) on the tiny presets of phi, GPT-J,
GPT-NeoX and Falcon (2 layers, vocabulary 256; between them parallel
residual with a shared or two pre-norms, partial rotary, LayerNorm, biases,
GELU, an untied or tied head and Falcon's multi-query attention), fp32,
reference attention, and take three ``train_batch`` steps on the same numpy
batches (gas 4, WarmupLR, clipping, AdamW). Losses agree at rtol 2e-5 and
final parameters at rtol 2e-4 / atol 2e-6, the tolerances of
``tests/test_torch_engine.py``.

AdamW's ``eps`` is 1e-3 here, not 1e-8. Both frameworks' gradients agree
to ~1e-6 of each tensor's largest element (fp32 sums in another order),
but a parameter whose true gradient is ~0 gets a gradient that is only that
rounding noise, different on the two sides; with eps 1e-8 Adam divides it
by its own root mean square and moves that element by up to lr in a
direction the noise picks (phi's and GPT-NeoX's embeddings each had one
such element 4e-6 to 1.4e-5 apart after three steps). An eps well above
the noise keeps those elements' updates below ~lr * 1e-3 while every
gradient above ~1e-3 is still normalised as before.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu.models as jax_models
import deepspeed_tpu_torch
import deepspeed_tpu_torch.models as models
from deepspeed_tpu.models import TransformerLM as JaxLM
from deepspeed_tpu.parallel.mesh import single_device_mesh
from deepspeed_tpu_torch.models import TransformerLM, params_from_jax, params_to_numpy

OVER = dict(num_layers=2, vocab_size=256, max_seq_len=64)
DS_CONFIG = {"train_batch_size": 8, "train_micro_batch_size_per_gpu": 2,
             "gradient_accumulation_steps": 4,
             "optimizer": {"type": "AdamW",
                           "params": {"lr": 1e-4, "weight_decay": 0.1, "eps": 1e-3}},
             "scheduler": {"type": "WarmupLR",
                           "params": {"warmup_num_steps": 2, "warmup_max_lr": 1e-4,
                                      "warmup_type": "linear"}},
             "gradient_clipping": 1.0, "steps_per_print": 100,
             "tpu": {"pallas_fused_adam": "never"}}


@pytest.mark.parametrize("family", ["phi", "gptj", "gpt_neox", "falcon"])
def test_family_train_batch_matches_jax_engine(family):
    jcfg = getattr(jax_models, f"{family}_config")("tiny", dtype=jnp.float32,
                                                   attention_impl="reference", **OVER)
    je, _, _, _ = deepspeed_tpu.initialize(model=JaxLM(jcfg), config=DS_CONFIG,
                                           mesh=single_device_mesh())
    npp = jax.tree.map(np.asarray, je.state["params"])
    tcfg = getattr(models, f"{family}_config")("tiny", dtype=torch.float32,
                                               attention_impl="reference", **OVER)
    assert tcfg.parallel_residual and tcfg.norm == "layernorm" and tcfg.mlp == "gelu"
    model = TransformerLM(tcfg, params_from_jax(npp, tcfg, device="cpu", dtype=torch.float32,
                                                per_layer=True), trainable=True)
    te, _, _, _ = deepspeed_tpu_torch.initialize(model=model, config=DS_CONFIG)
    for step in range(3):
        ids = np.random.default_rng(step).integers(0, 256, size=(8, 24)).astype(np.int32)
        lj = float(je.train_batch({"input_ids": ids}))
        lt = float(te.train_batch({"input_ids": ids}))
        np.testing.assert_allclose(lt, lj, rtol=2e-5, err_msg=f"{family} step {step}")
    ours = params_to_numpy(te.module.params())
    ref = jax.tree.map(np.asarray, je.state["params"])
    assert set(ours) == set(ref)
    for group in ref:
        for name in ref[group]:
            np.testing.assert_allclose(ours[group][name], ref[group][name], rtol=2e-4, atol=2e-6,
                                       err_msg=f"{family}: {group}/{name}")
    assert te.global_steps == 3

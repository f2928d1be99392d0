"""PyTorch port: ``runtime/bf16_optimizer.py`` against the JAX package's
``BF16_Optimizer`` over ``optax.adamw`` on the CPU.

The same seeded numpy tensors and gradients go through both, three steps,
with the clip off and at 1.0 (the gradients' norm is above it): the bf16
compute tensors equal, the fp32 masters within rtol 1e-6. The masters are
copies, never the caller's tensors; a ``state_dict`` round trip into a
fresh optimizer continues the same trajectory.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deepspeed_tpu.runtime.bf16_optimizer import BF16_Optimizer as JaxBF16
from deepspeed_tpu_torch.runtime.bf16_optimizer import BF16_Optimizer
from deepspeed_tpu_torch.runtime.optimizers import Adam

SHAPES = {"a": (32, 16), "b": (100,), "c": (4, 4, 4)}


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (scale * rng.standard_normal(s)).astype(np.float32) for k, s in SHAPES.items()}


def _port(clip):
    return BF16_Optimizer(lambda ps: Adam(ps, 1e-2, weight_decay=0.1), clip_grad=clip)


def _bf16_bits(x):
    return np.asarray(jnp.asarray(x).view(jnp.uint16))


@pytest.mark.parametrize("clip", [0.0, 1.0])
def test_bf16_optimizer_matches_jax(clip):
    init = _tree(0)
    ref = JaxBF16(optax.adamw(1e-2, weight_decay=0.1), clip_grad=clip)
    jp = ref.init({k: jnp.asarray(v) for k, v in init.items()})
    ours = _port(clip)
    caller = [torch.from_numpy(init[k].copy()) for k in sorted(init)]
    tp = ours.init(caller)
    assert all(t.dtype == torch.bfloat16 for t in tp)
    assert all(m.data_ptr() != c.data_ptr() for m, c in zip(ours.fp32_params(), caller))
    for step in range(3):
        g = _tree(10 + step, scale=3.0)  # global norm ~30: the clip at 1.0 acts
        jp = ref.step({k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in g.items()})
        tp = ours.step([torch.from_numpy(g[k]).to(torch.bfloat16) for k in sorted(g)])
        for k, t in zip(sorted(g), tp):
            assert np.array_equal(_bf16_bits(jp[k]), t.view(torch.int16).numpy().view(np.uint16)), \
                (step, k)
        for k, m in zip(sorted(g), ours.fp32_params()):
            np.testing.assert_allclose(m.numpy(), np.asarray(ref.fp32_params()[k]), rtol=1e-6,
                                       atol=1e-7)
    # the caller's tensors are untouched
    assert all(np.array_equal(c.numpy(), init[k]) for k, c in zip(sorted(init), caller))
    assert ours.param_groups[0]["params"] is tp


def test_bf16_optimizer_state_dict_round_trip():
    init = _tree(1)
    grads = [_tree(20 + i) for i in range(3)]
    a = _port(1.0)
    a.init([torch.from_numpy(init[k]) for k in sorted(init)])
    for g in grads[:2]:
        a.step([torch.from_numpy(g[k]) for k in sorted(g)])
    sd = a.state_dict()
    b = _port(1.0)
    b.init([torch.zeros(SHAPES[k]) for k in sorted(SHAPES)])
    b.load_state_dict(sd)
    assert int(b.optimizer.count) == 2
    last = [torch.from_numpy(grads[2][k]) for k in sorted(SHAPES)]
    out_a, out_b = a.step(last), b.step([g.clone() for g in last])
    assert all(torch.equal(x, y) for x, y in zip(out_a, out_b))
    assert all(torch.equal(x, y) for x, y in zip(a.fp32_params(), b.fp32_params()))

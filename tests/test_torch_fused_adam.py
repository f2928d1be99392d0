"""PyTorch port: the fused, gated AdamW against the JAX package.

The port's plain version (the CPU path of ``fused_adam_apply`` and the
oracle the CUDA kernel is held to on the card) takes the same numpy inputs
as the JAX package's ``fused_adam_apply(..., interpret=True)``: leaves of
128 * k elements (the Pallas kernel's) and of 1000003 (the jnp chain the JAX
package sends unaligned leaves to), several steps, a folded gradient scale,
and a gate of 0 that leaves everything untouched. Tolerance rtol 1e-6, with
the absolute floors of ``tests/test_fused_adam.py`` where a value is a
difference: the same fp32 formulas, but XLA may contract a product and a sum
into one rounding (a fused multiply-add) where PyTorch rounds twice, so a
first moment that cancels to near zero keeps an error of ~1e-8 (its terms'
rounding), and a parameter moves by lr * update with the update's own
~1e-6 relative error. One more exception is named in its test: the jnp
chain rounds ``1 - b2`` in double precision where the Pallas kernel
subtracts in fp32, and the port follows the kernel.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas.fused_adam import fused_adam_apply as jax_fused_adam_apply
from deepspeed_tpu_torch.ops import fused_adam as tfa
from deepspeed_tpu_torch.ops.adam.fused_adam import FusedAdam

SIZES = [128 * 3, 128 * 1000, 1000003]
ALIGNED = [True, True, False]  # the JAX package's Pallas kernel takes 128 * k leaves


def _state(seed, sizes=SIZES):
    rng = np.random.default_rng(seed)
    p = [rng.normal(size=n).astype(np.float32) for n in sizes]
    m = [np.zeros(n, np.float32) for n in sizes]
    v = [np.zeros(n, np.float32) for n in sizes]
    return rng, p, m, v


def _jax_step(p, m, v, g, **kw):
    out = jax_fused_adam_apply([jnp.asarray(x) for x in p], [jnp.asarray(x) for x in m],
                               [jnp.asarray(x) for x in v], [jnp.asarray(x) for x in g],
                               interpret=True, **kw)
    return [[np.asarray(x) for x in leaves] for leaves in out]


@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_plain_version_matches_jax_interpret(weight_decay):
    rng, p, m, v = _state(0)
    tp, tm, tv = ([torch.from_numpy(x.copy()) for x in xs] for xs in (p, m, v))
    for step in range(1, 4):
        g = [(rng.normal(size=x.shape) * 3).astype(np.float32) for x in p]
        kw = dict(lr_t=2e-3 * step, b1=0.9, b2=0.999, eps=1e-8, weight_decay=weight_decay,
                  step=step, grad_scale=0.5, gate=1.0)
        p, m, v = _jax_step(p, m, v, g, **kw)
        tfa.fused_adam_apply(tp, tm, tv, [torch.from_numpy(x) for x in g], **kw)
    for i, aligned in enumerate(ALIGNED):
        np.testing.assert_allclose(tp[i].numpy(), p[i], rtol=1e-6, atol=2e-7,
                                   err_msg=f"param {i}")
        np.testing.assert_allclose(tm[i].numpy(), m[i], rtol=1e-6, atol=1e-7, err_msg=f"mu {i}")
        # the jnp chain's 1 - b2 is fp32(0.001); the Pallas kernel's (and the
        # port's) is 1 - fp32(0.999) = 0.00099998713: 1.3e-5 apart
        np.testing.assert_allclose(tv[i].numpy(), v[i], rtol=1e-6 if aligned else 2e-5,
                                   err_msg=f"nu {i}")


def test_gate_zero_leaves_everything_untouched():
    rng, p, m, v = _state(1)
    m = [rng.normal(size=x.shape).astype(np.float32) for x in m]
    v = [rng.random(size=x.shape).astype(np.float32) for x in v]
    nan = [np.full(x.shape, np.nan, np.float32) for x in p]
    kw = dict(lr_t=1e-3, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.1, step=1, grad_scale=1.0,
              gate=0.0)
    jp, jm, jv = _jax_step(p, m, v, nan, **kw)
    tp, tm, tv = ([torch.from_numpy(x.copy()) for x in xs] for xs in (p, m, v))
    tfa.fused_adam_apply(tp, tm, tv, [torch.from_numpy(x) for x in nan],
                         **dict(kw, gate=torch.tensor(False)))
    for ours, jax_out, before in ((tp, jp, p), (tm, jm, m), (tv, jv, v)):
        for a, b, c in zip(ours, jax_out, before):
            np.testing.assert_array_equal(a.numpy(), c)
            np.testing.assert_array_equal(b, c)


def test_grad_scale_folds_unscaling_and_clip():
    """grad_scale * g equals feeding the scaled gradient, bf16 gradients
    read as their fp32 values."""
    rng, p, m, v = _state(2, [128 * 5, 77])
    g = [rng.normal(size=x.shape).astype(np.float32) * 4 for x in p]
    kw = dict(lr_t=1e-3, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0, step=1, gate=1.0)
    a = [torch.from_numpy(x.copy()) for x in p]
    b = [torch.from_numpy(x.copy()) for x in p]
    z = lambda: [torch.zeros(x.shape) for x in p]  # noqa: E731
    tfa.fused_adam_apply(a, z(), z(), [torch.from_numpy(x) for x in g], grad_scale=0.25, **kw)
    tfa.fused_adam_apply(b, z(), z(), [torch.from_numpy(x * 0.25) for x in g], grad_scale=1.0,
                         **kw)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-6)
    g16 = [torch.from_numpy(x).to(torch.bfloat16) for x in g]
    c = [torch.from_numpy(x.copy()) for x in p]
    d = [torch.from_numpy(x.copy()) for x in p]
    tfa.fused_adam_apply(c, z(), z(), g16, grad_scale=1.0, **kw)
    tfa.fused_adam_apply(d, z(), z(), [x.float() for x in g16], grad_scale=1.0, **kw)
    for x, y in zip(c, d):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


def test_cpu_tensors_take_the_plain_version_without_a_launch():
    tfa.reset_launch_counts()
    _, p, m, v = _state(3, [10])
    tp = [torch.from_numpy(p[0].copy())]
    ref = [torch.from_numpy(p[0].copy())]
    g = [torch.ones(10)]
    kw = dict(lr_t=1e-2, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0, step=1, grad_scale=1.0,
              gate=1.0)
    tfa.fused_adam_apply(tp, [torch.zeros(10)], [torch.zeros(10)], g, **kw)
    tfa.fused_adam_reference(ref, [torch.zeros(10)], [torch.zeros(10)], g, **kw)
    assert torch.equal(tp[0], ref[0]) and not torch.equal(tp[0], torch.from_numpy(p[0]))
    assert tfa.launch_counts["fused_adam"] == 0
    with pytest.raises(ValueError, match="non-empty"):
        tfa.fused_adam_apply([], [], [], [], **kw)


def test_fused_adam_optimizer_matches_jax_over_steps():
    """``FusedAdam`` (the state holder the engine drives): ``step()`` with a
    schedule evaluated on its device counter, and ``apply`` with a gate that
    holds the counter on an overflow."""
    rng, p, m, v = _state(4, [128 * 2, 33])
    params = [torch.nn.Parameter(torch.from_numpy(x.copy())) for x in p]
    sched = lambda count: 1e-3 * (count.float() + 1.0)  # noqa: E731
    opt = FusedAdam(params, lr=sched, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01)
    for step in range(1, 4):
        g = [rng.normal(size=x.shape).astype(np.float32) for x in p]
        p, m, v = _jax_step(p, m, v, g, lr_t=1e-3 * step, b1=0.9, b2=0.999, eps=1e-8,
                            weight_decay=0.01, step=step, grad_scale=1.0, gate=1.0)
        for t, x in zip(params, g):
            t.grad = torch.from_numpy(x)
        opt.step()
    assert int(opt.fused_state.step) == 3
    for t, x in zip(params, p):
        np.testing.assert_allclose(t.detach().numpy(), x, rtol=1e-6, atol=2e-7)
    before = [t.detach().clone() for t in params]
    opt.apply([torch.full_like(t, float("inf")) for t in params], lr_t=1e-3,
              gate=torch.tensor(0.0))
    assert int(opt.fused_state.step) == 3
    assert all(torch.equal(a, b) for a, b in zip(params, before))


@pytest.mark.gpu
def test_cuda_kernel_matches_plain_version_on_card():
    """On the card: one launch over leaves of odd sizes (one at an unaligned
    address), fp32 and bf16 gradients, against the plain version at rtol
    1e-6 (the same IEEE-rounded fp32 operations in the same order); gate 0
    writes nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    sizes = [1, 5, 128, 4099, 65536 * 3 + 17]
    for gdt in (torch.float32, torch.bfloat16):
        a = {k: [torch.randn(n + 1, generator=gen, device=dev)[1 if i == 3 else 0:][:n]
                 for i, n in enumerate(sizes)] for k in "pmg"}
        a["v"] = [torch.rand(n, generator=gen, device=dev) for n in sizes]
        a["g"] = [g.to(gdt) for g in a["g"]]
        b = {k: [t.clone() for t in ts] for k, ts in a.items()}
        kw = dict(lr_t=torch.full((), 1e-3, device=dev), b1=0.9, b2=0.999, eps=1e-8,
                  weight_decay=0.1, step=torch.full((), 2, dtype=torch.int32, device=dev),
                  grad_scale=0.5)
        tfa.reset_launch_counts()
        tfa.fused_adam_apply(a["p"], a["m"], a["v"], a["g"], gate=1.0, **kw)
        tfa.fused_adam_reference(b["p"], b["m"], b["v"], b["g"], gate=1.0, **kw)
        torch.cuda.synchronize()
        assert tfa.launch_counts["fused_adam"] == 1
        for k in "pmv":
            for x, y in zip(a[k], b[k]):
                torch.testing.assert_close(x, y, rtol=1e-6, atol=0)
        before = {k: [t.clone() for t in a[k]] for k in "pmv"}
        tfa.fused_adam_apply(a["p"], a["m"], a["v"], a["g"], gate=0.0, **kw)
        torch.cuda.synchronize()
        for k in "pmv":
            assert all(torch.equal(x, y) for x, y in zip(a[k], before[k]))

"""PyTorch port: the grouped matmul (MoE expert products) against the JAX
package.

The same numpy inputs (from a seed) go through the port's plain versions
(``gmm``/``tgmm`` on CPU tensors) and its ``grouped_matmul`` autograd
Function, and through the JAX package's Pallas kernels in interpret mode
(``_gmm``/``_tgmm(..., interpret=True)``) and ``jax.vjp`` of its
``grouped_matmul``, as ``tests/test_grouped_moe.py`` runs them: block
tables with repeated experts, an expert that owns only one block, the dx
product against the transposed weights (``trans_b``, read through the
strides here, materialised on the JAX side). Tolerance fp32: rtol 1e-5 /
atol 1e-5 (the same products summed in another order); bf16: 2 bf16 ulps
of the reference (both round one fp32 sum once). The kernel route is a
pure function of the widths (checked here); the CUDA kernels run only on a
card (``gpu`` marker).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas import grouped_matmul as jgm
from deepspeed_tpu_torch.ops import grouped_matmul as tgm

TOL32 = dict(rtol=1e-5, atol=1e-5)


def _table(rng, n_blocks, E, cover=True):
    """A non-decreasing block table; ``cover``: every expert owns a block."""
    be = rng.integers(0, E, size=n_blocks)
    if cover:
        be[:E] = np.arange(E)
    return np.sort(be).astype(np.int32)


def _case(seed, T=64, K=32, N=48, E=3, bt=8):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(T, K)).astype(np.float32), rng.normal(size=(E, K, N)).astype(np.float32),
            rng.normal(size=(T, N)).astype(np.float32), _table(rng, T // bt, E))


@pytest.mark.parametrize("trans_b", [False, True])
def test_gmm_plain_matches_pallas_interpret(trans_b):
    lhs, rhs, _, be = _case(0)
    bt = 8
    if trans_b:  # rhs is [E, N, K]: multiply by its per-expert transpose
        rhs = np.ascontiguousarray(rhs.transpose(0, 2, 1))
        jrhs = jnp.asarray(rhs).transpose(0, 2, 1)
    else:
        jrhs = jnp.asarray(rhs)
    ref = jgm._gmm(jnp.asarray(lhs), jrhs, jnp.asarray(be), bt, 16, 16, True)
    out = tgm.gmm(torch.from_numpy(lhs), torch.from_numpy(rhs), torch.from_numpy(be), bt,
                  trans_b=trans_b)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL32)


def test_tgmm_plain_matches_pallas_interpret():
    lhs, _, dy, be = _case(1, N=16, E=4)
    ref = jgm._tgmm(jnp.asarray(lhs), jnp.asarray(dy), jnp.asarray(be), 4, 8, 16, 16, True)
    out = tgm.tgmm(torch.from_numpy(lhs), torch.from_numpy(dy), torch.from_numpy(be), 4, 8)
    assert out.dtype == torch.float32 and out.shape == (4, 32, 16)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL32)


def test_tgmm_expert_without_blocks_is_zero():
    """The port writes zeros for an expert that owns no row block (the TPU
    kernel leaves it unwritten; the dispatcher never makes one)."""
    rng = np.random.default_rng(2)
    lhs, dy = rng.normal(size=(32, 8)).astype(np.float32), rng.normal(size=(32, 4)).astype(np.float32)
    be = np.asarray([0, 0, 2, 2], np.int32)
    out = tgm.tgmm_plain(torch.from_numpy(lhs), torch.from_numpy(dy), torch.from_numpy(be), 3, 8)
    assert torch.count_nonzero(out[1]) == 0
    np.testing.assert_allclose(out[0].numpy(), lhs[:16].T @ dy[:16], **TOL32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_autograd_function_matches_jax_vjp(dtype):
    """Forward, dx and dw of ``grouped_matmul`` against ``jax.vjp`` of the
    JAX package's custom VJP in interpret mode; dw comes back in rhs's
    dtype (the reference's bf16 rounding of dw)."""
    lhs, rhs, dy, be = _case(3, T=48, K=16, N=24, E=2)
    bt = 8
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    fn = lambda a, b: jgm.grouped_matmul(a, b, jnp.asarray(be), block_t=bt, block_k=8, block_n=8,
                                         interpret=True)
    out_ref, vjp = jax.vjp(fn, jnp.asarray(lhs, jdt), jnp.asarray(rhs, jdt))
    dx_ref, dw_ref = vjp(jnp.asarray(dy, jdt))
    a = torch.from_numpy(lhs).to(tdt).requires_grad_()
    b = torch.from_numpy(rhs).to(tdt).requires_grad_()
    out = tgm.grouped_matmul(a, b, torch.from_numpy(be), bt)
    out.backward(torch.from_numpy(dy).to(tdt))
    assert out.dtype == tdt and a.grad.dtype == tdt and b.grad.dtype == tdt
    for name, got, ref in (("out", out, out_ref), ("dx", a.grad, dx_ref), ("dw", b.grad, dw_ref)):
        ref = np.asarray(ref.astype(jnp.float32))
        got = got.detach().float().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(got, ref, err_msg=name, **TOL32)
        else:
            ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(ref), 2.0**-126))) - 7)
            assert (np.abs(got - ref) <= 2 * ulp + 2.0**-14).all(), name


def test_cpu_tensors_take_the_plain_version_without_a_launch():
    """On CPU tensors the wrappers are the plain versions, and the
    Function's backward is the plain dx / dw; no launch is counted."""
    tgm.reset_launch_counts()
    lhs, rhs, dy, be = (torch.from_numpy(x) for x in _case(4))
    assert torch.equal(tgm.gmm(lhs, rhs, be, 8), tgm.gmm_plain(lhs, rhs, be, 8))
    assert torch.equal(tgm.tgmm(lhs, dy, be, 3, 8), tgm.tgmm_plain(lhs, dy, be, 3, 8))
    a, b = lhs.clone().requires_grad_(), rhs.clone().requires_grad_()
    tgm.grouped_matmul(a, b, be, 8).backward(dy)
    assert torch.equal(a.grad, tgm.gmm_plain(dy, rhs, be, 8, trans_b=True))
    assert torch.equal(b.grad, tgm.tgmm_plain(lhs, dy, be, 3, 8))
    assert tgm.launch_counts == {"gmm": 0, "tgmm": 0, "gmm_wmma": 0, "tgmm_wmma": 0}


@pytest.mark.parametrize("K,N,expected", [
    (4096, 14336, "wgmma"), (14336, 4096, "wgmma"), (200, 136, "wgmma"), (8, 8, "wgmma"),
    (96, 256, "wgmma"), (37, 45, "wmma"), (4096, 14330, "wmma"), (4100, 4096, "wmma"),
    (1, 8, "wmma")])
def test_route_is_chosen_by_the_widths_alone(K, N, expected):
    """Widths that are multiples of 8 (every operand row 16-byte aligned, so
    TMA can describe it) go to the wgmma kernels, any other to the wmma
    kernels; the rule is symmetric (gmm's dx swaps K and N), and each route
    has its own launch counts."""
    assert tgm.route(K, N) == expected == tgm.route(N, K)
    for name in ("gmm", "tgmm"):
        assert name + tgm._SUFFIX[expected] in tgm.launch_counts
    assert set(tgm.launch_counts) == {k + tgm._SUFFIX[r] for k in ("gmm", "tgmm")
                                      for r in ("wgmma", "wmma")}


def _bf16_tol(ref):
    ulp = torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(2.0**-126))) - 7)
    return 2 * ulp + max(2.0**-14, 2.0**-12 * float(ref.pow(2).mean().sqrt()))


@pytest.mark.gpu
def test_cuda_kernels_match_plain_version_on_card():
    """On the card: gmm (both layouts) and tgmm against the plain versions
    on the same bf16 / fp16 inputs: K and N off the 64 / 128 tiles (and one
    width that is not a multiple of 8, the wmma route), an expert owning
    only one block, a single expert, Mixtral's expert widths (4096 / 14336).
    Each case launches only its route's kernels. Tolerance as
    ``chip_smoke.py`` states it: gmm 2 bf16 ulps of |plain| + max(2^-14,
    2^-12 rms(plain)); tgmm (fp32), per expert, 2^-16 * sqrt(rows summed
    into out[e]) * rms(plain[e]). The autograd Function launches gmm twice
    (forward, dx) and tgmm once, on the wgmma route."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = [(512, 200, 136, 3, [0, 0, 1, 2], torch.bfloat16),
             (384, 64, 96, 4, [0, 2, 3], torch.bfloat16),
             (256, 37, 45, 1, [0, 0], torch.float16),
             (512, 256, 384, 2, [0, 1, 1, 1], torch.float16),
             (256, 4096, 14336, 2, [0, 1], torch.bfloat16)]
    for T, K, N, E, be_list, dt in cases:
        be = torch.tensor(be_list, dtype=torch.int32, device=dev)
        lhs = torch.randn(T, K, generator=gen, device=dev).to(dt)
        rhs = torch.randn(E, K, N, generator=gen, device=dev).to(dt)
        dy = torch.randn(T, N, generator=gen, device=dev).to(dt)
        tgm.reset_launch_counts()
        for got, ref in ((tgm.gmm(lhs, rhs, be), tgm.gmm_plain(lhs, rhs, be)),
                         (tgm.gmm(dy, rhs, be, trans_b=True),
                          tgm.gmm_plain(dy, rhs, be, trans_b=True))):
            ref = ref.float()
            assert bool(((got.float() - ref).abs() <= _bf16_tol(ref)).all()), (T, K, N, E, dt)
        got, ref = tgm.tgmm(lhs, dy, be, E), tgm.tgmm_plain(lhs, dy, be, E)
        for e in range(E):
            tol = 2.0**-16 * (128 * be_list.count(e))**0.5 * float(ref[e].pow(2).mean().sqrt())
            assert float((got[e] - ref[e]).abs().max()) <= tol + 2.0**-30, (T, K, N, E, dt, e)
        suffix = tgm._SUFFIX[tgm.route(K, N)]
        assert tgm.launch_counts == {"gmm": 0, "tgmm": 0, "gmm_wmma": 0, "tgmm_wmma": 0,
                                     "gmm" + suffix: 2, "tgmm" + suffix: 1}, (K, N)
    tgm.reset_launch_counts()
    a, b = lhs.clone().requires_grad_(), rhs.clone().requires_grad_()
    tgm.grouped_matmul(a, b, be).backward(dy)
    torch.cuda.synchronize()
    assert tgm.launch_counts == {"gmm": 2, "tgmm": 1, "gmm_wmma": 0, "tgmm_wmma": 0}

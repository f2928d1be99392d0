"""PyTorch port: training flash attention against the JAX package.

The same numpy inputs (fp32, from a seed) go through the port's
``flash_attention`` on CPU tensors (its ``autograd.Function`` over the plain
forward and backward) and through the JAX package's Pallas kernels in
interpret mode (``_pallas_flash(..., interpret=True)``, forward, lse and
``jax.vjp``), as ``tests/test_ops.py`` and ``tests/test_sliding_window.py``
run them: GQA 4/2, head_dim 64, S 256, causal and not, window 48, ALiBi.
Ragged lengths (S 200, which the Pallas kernel does not take) and ALiBi
with a head count that is not a power of two go against the JAX package's
own public ``flash_attention``, which takes its jnp reference path there.
The backward's order (dq first, handing delta = rowsum(dO * O) to dk/dv)
is held to ``jax.vjp`` through the wrappers on CPU tensors, and the
autograd Function's CPU backward is one call of the plain backward.
Tolerance rtol 2e-4 / atol 2e-5 (fp32 sums in another order), as the port's
other parity tests. The CUDA kernels run only on a card (``gpu`` marker).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu.ops.pallas import flash_attention as jfa
from deepspeed_tpu_torch.models import TransformerLM, mistral_config
from deepspeed_tpu_torch.models.transformer import alibi_slopes, reference_attention
from deepspeed_tpu_torch.ops import flash_attention as tfa

TOL = dict(rtol=2e-4, atol=2e-5)
MODES = {  # name -> (causal, window, alibi)
    "causal": (True, None, False),
    "full": (False, None, False),
    "window48": (True, 48, False),
    "alibi": (True, None, True),
    "alibi_full": (False, None, True),
    "alibi_window48": (True, 48, True),
}


def _inputs(seed, B=2, S=256, nq=4, nkv=2, d=64):
    rng = np.random.default_rng(seed)
    shapes = ((B, S, nq, d), (B, S, nkv, d), (B, S, nkv, d), (B, S, nq, d))
    return [rng.normal(size=s).astype(np.float32) for s in shapes]  # q, k, v, dout


def _torch_fwd_bwd(q, k, v, do, causal, window, alibi):
    """The port's flash_attention on CPU tensors: (out, dq, dk, dv)."""
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = tfa.flash_attention(qt, kt, vt, causal=causal, window=window, alibi=alibi)
    out.backward(torch.from_numpy(do))
    return [x.detach().numpy() for x in (out, qt.grad, kt.grad, vt.grad)]


def _jax_fwd_bwd(fn, q, k, v, do):
    out, vjp = jax.vjp(fn, *(jnp.asarray(x) for x in (q, k, v)))
    return [np.asarray(x) for x in (out, *vjp(jnp.asarray(do)))]


def _assert_all_close(ours, ref, tag):
    for name, a, b in zip(("out", "dq", "dk", "dv"), ours, ref):
        np.testing.assert_allclose(a, b, err_msg=f"{tag}: {name}", **TOL)


@pytest.mark.parametrize("mode", list(MODES))
def test_plain_version_matches_pallas_interpret(mode):
    causal, window, alibi = MODES[mode]
    q, k, v, do = _inputs(0)
    kw = dict(causal=causal, block_q=128, block_k=128, interpret=True, window=window, alibi=alibi)
    ref = _jax_fwd_bwd(lambda a, b, c: jfa._pallas_flash(a, b, c, **kw), q, k, v, do)
    ours = _torch_fwd_bwd(q, k, v, do, causal, window, alibi)
    _assert_all_close(ours, ref, mode)
    # the saved softmax statistics: lse [B, nq, S] fp32
    _, lse_ref = jfa._flash_fwd_impl(causal, 128, 128, True, window, alibi,
                                     *(jnp.asarray(x) for x in (q, k, v)))
    slopes = torch.from_numpy(alibi_slopes(4)) if alibi else None
    _, lse = tfa.flash_attention_reference(*(torch.from_numpy(x) for x in (q, k, v)), causal,
                                           window, slopes)
    assert lse.shape == (2, 4, 256) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref), **TOL)


@pytest.mark.parametrize("mode,heads", [("causal", (4, 2)), ("window48", (4, 2)),
                                        ("full", (4, 4)), ("alibi", (6, 3)),
                                        ("alibi_window48", (6, 2)), ("alibi_full", (12, 4))])
def test_ragged_length_and_any_head_count_match_jax(mode, heads):
    """S 200 (no 128 multiple: the masking is inside the kernels, not the
    TPU package's S % 128 fallback) and ALiBi at 6 and 12 heads, against
    the JAX package's public ``flash_attention`` (its reference path for
    these shapes) and the port's ``reference_attention`` under autograd."""
    causal, window, alibi = MODES[mode]
    nq, nkv = heads
    q, k, v, do = _inputs(1, S=200, nq=nq, nkv=nkv)
    ref = _jax_fwd_bwd(lambda a, b, c: jfa.flash_attention(a, b, c, causal=causal, window=window,
                                                           alibi=alibi), q, k, v, do)
    ours = _torch_fwd_bwd(q, k, v, do, causal, window, alibi)
    _assert_all_close(ours, ref, f"{mode} {heads}")
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = reference_attention(qt, kt, vt, causal=causal, window=window,
                              alibi=alibi_slopes(nq) if alibi else None)
    out.backward(torch.from_numpy(do))
    plain = [x.detach().numpy() for x in (out, qt.grad, kt.grad, vt.grad)]
    _assert_all_close(ours, plain, f"{mode} {heads} vs reference_attention")


@pytest.mark.parametrize("mode", ["causal", "window48", "alibi_full"])
def test_autograd_function_matches_autograd_through_plain_forward(mode):
    """The backward's recurrences (p = exp(s - lse), delta from the stored
    output, ds = p (dp - delta), GQA group sums) give autograd's gradients
    of the plain forward."""
    causal, window, alibi = MODES[mode]
    q, k, v, do = _inputs(2, S=96, nq=8, nkv=2, d=32)
    ours = _torch_fwd_bwd(q, k, v, do, causal, window, alibi)
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    slopes = torch.from_numpy(alibi_slopes(8)) if alibi else None
    out, _ = tfa.flash_attention_reference(qt, kt, vt, causal, window, slopes)
    out.backward(torch.from_numpy(do))
    _assert_all_close(ours, [x.detach().numpy() for x in (out, qt.grad, kt.grad, vt.grad)], mode)


def test_cpu_tensors_take_the_plain_version_without_a_launch():
    tfa.reset_launch_counts()
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(3, S=70))
    out, lse = tfa.flash_fwd(q, k, v, True, 32)
    r_out, r_lse = tfa.flash_attention_reference(q, k, v, True, 32)
    assert torch.equal(out, r_out) and torch.equal(lse, r_lse)
    dq, delta = tfa.flash_bwd_dq(q, k, v, out, lse, do, True, 32)
    dk, dv = tfa.flash_bwd_dkdv(q, k, v, lse, delta, do, True, 32)
    r = tfa.flash_attention_reference_bwd(q, k, v, out, lse, do, True, 32)
    assert all(torch.equal(a, b) for a, b in zip((dq, dk, dv), r))
    assert torch.equal(delta, tfa.flash_delta(out, do))
    assert all(n == 0 for n in tfa.launch_counts.values())
    with pytest.raises(ValueError, match="causal"):
        tfa.flash_attention(q, k, v, causal=False, window=8)


def test_autograd_backward_on_cpu_runs_the_plain_backward_once(monkeypatch):
    """On CPU tensors ``FlashAttention.backward`` is one call of the plain
    backward (dq, dk and dv together), not one per kernel wrapper."""
    calls = []
    plain = tfa.flash_attention_reference_bwd

    def counted(*args, **kw):
        calls.append(1)
        return plain(*args, **kw)

    monkeypatch.setattr(tfa, "flash_attention_reference_bwd", counted)
    q, k, v, do = _inputs(6, S=80, nq=4, nkv=2, d=32)
    ours = _torch_fwd_bwd(q, k, v, do, True, 24, False)
    assert len(calls) == 1
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = reference_attention(qt, kt, vt, causal=True, window=24)
    out.backward(torch.from_numpy(do))
    _assert_all_close(ours, [x.detach().numpy() for x in (out, qt.grad, kt.grad, vt.grad)],
                      "one plain backward")


@pytest.mark.parametrize("mode", ["causal", "alibi_window48"])
def test_dq_first_then_dkdv_from_its_delta_matches_jax_vjp(mode):
    """The backward's new order on CPU tensors: ``flash_bwd_dq`` hands back
    delta = rowsum(dO * O) [B, nq, S] beside dq, and ``flash_bwd_dkdv``
    computes dk/dv from lse and that delta; with the
    reordered autograd Function, both match ``jax.vjp`` of
    ``_pallas_flash(interpret=True)`` on the same inputs."""
    causal, window, alibi = MODES[mode]
    q, k, v, do = _inputs(7)
    kw = dict(causal=causal, block_q=128, block_k=128, interpret=True, window=window, alibi=alibi)
    ref = _jax_fwd_bwd(lambda a, b, c: jfa._pallas_flash(a, b, c, **kw), q, k, v, do)
    _assert_all_close(_torch_fwd_bwd(q, k, v, do, causal, window, alibi), ref, mode)
    qt, kt, vt, dot = (torch.from_numpy(x) for x in (q, k, v, do))
    slopes = torch.from_numpy(alibi_slopes(4)) if alibi else None
    out, lse = tfa.flash_fwd(qt, kt, vt, causal, window, slopes)
    dq, delta = tfa.flash_bwd_dq(qt, kt, vt, out, lse, dot, causal, window, slopes)
    assert delta.shape == (2, 4, 256) and delta.dtype == torch.float32
    np.testing.assert_allclose(delta.numpy(), np.einsum("bsnd,bsnd->bns", do, ref[0]), **TOL)
    dk, dv = tfa.flash_bwd_dkdv(qt, kt, vt, lse, delta, dot, causal, window, slopes)
    _assert_all_close([out.numpy(), dq.numpy(), dk.numpy(), dv.numpy()], ref, f"{mode} wrappers")


def test_model_flash_path_matches_reference_path():
    """The slice's attention switch: ``attention_impl="flash"`` (the
    ``autograd.Function``) and ``"reference"`` give one loss and one set of
    gradients on a tiny Mistral (GQA, window) in fp32."""
    tiny = dict(num_layers=2, hidden_size=64, num_heads=4, num_kv_heads=2, intermediate_size=128,
                vocab_size=256, max_seq_len=256, sliding_window=16)
    ids = torch.from_numpy(np.random.default_rng(5).integers(0, 256, (2, 40)))
    results = []
    for impl in ("flash", "reference"):
        model = TransformerLM(mistral_config("tiny", dtype=torch.float32, attention_impl=impl,
                                             **tiny), device="cpu", trainable=True, seed=3)
        loss = model.loss({"input_ids": ids})
        loss.backward()
        results.append((loss.item(), [p.grad.numpy() for p in model.parameters()]))
    np.testing.assert_allclose(results[0][0], results[1][0], rtol=1e-6)
    for a, b in zip(results[0][1], results[1][1]):
        np.testing.assert_allclose(a, b, **TOL)


def test_plain_version_matches_jax_reference_attention():
    """The port's plain forward against the JAX package's jnp oracle
    (``reference_attention``) on the same inputs, with a window."""
    q, k, v, _ = _inputs(4, S=130, nq=8, nkv=4, d=32)
    out, _ = tfa.flash_attention_reference(*(torch.from_numpy(x) for x in (q, k, v)), True, 40)
    ref = jt.reference_attention(*(jnp.asarray(x) for x in (q, k, v)), causal=True, window=40)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def _bf16_tol(ref):
    ulp = torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(2.0**-126))) - 7)
    return 2 * ulp + max(2.0**-14, 2.0**-12 * float(ref.pow(2).mean().sqrt()))


@pytest.mark.gpu
def test_cuda_kernels_match_plain_version_on_card():
    """On the card: forward (out, lse), then the backward in the autograd
    Function's order, dq first (which hands back delta = rowsum(dO * O)),
    then dk/dv from that delta, against the plain version on the same bf16
    and float16 inputs (the backward on the kernel forward's out and lse):
    head_dim 64 and 128, S 1 / 100 / 257 (ragged), GQA 1 and 4, causal,
    window 48 and ALiBi (float16 too, with and without the window; the
    forward's P . V takes P as a split pair of the input type). Tolerance per element as ``chip_smoke.py`` states
    it: 2 bf16 ulp of |plain| plus max(2^-14, 2^-12 rms(plain)) for the
    16-bit outputs, 2^-14 (1 + |plain|) for lse; delta, an fp32 sum of d
    products on both sides, within 2^-16 of its sum of absolute terms. The
    autograd function launches each kernel once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda")
    cases = [((8, 2), MODES["causal"], torch.bfloat16),
             ((8, 2), MODES["window48"], torch.bfloat16),
             ((6, 6), MODES["alibi_full"], torch.bfloat16),
             ((12, 3), MODES["alibi_window48"], torch.bfloat16),
             ((8, 2), MODES["window48"], torch.float16),
             ((4, 4), MODES["alibi"], torch.float16),
             ((8, 2), MODES["alibi_window48"], torch.float16)]
    for S in (1, 100, 257):
        for d in (64, 128):
            for (nq, nkv), (causal, window, alibi), dtype in cases:
                q, k, v, do = (torch.from_numpy(x).to(dev, dtype)
                               for x in _inputs(S + d, S=S, nq=nq, nkv=nkv, d=d))
                slopes = torch.from_numpy(alibi_slopes(nq)).to(dev) if alibi else None
                out, lse = tfa.flash_fwd(q, k, v, causal, window, slopes)
                dq, delta = tfa.flash_bwd_dq(q, k, v, out, lse, do, causal, window, slopes)
                dk, dv = tfa.flash_bwd_dkdv(q, k, v, lse, delta, do, causal, window, slopes)
                r_out, r_lse = tfa.flash_attention_reference(q, k, v, causal, window, slopes)
                refs = tfa.flash_attention_reference_bwd(q, k, v, out, lse, do, causal, window,
                                                         slopes)
                r_delta = tfa.flash_delta(out, do)
                torch.cuda.synchronize()
                tag = (S, d, nq, nkv, causal, window, alibi, dtype)
                for got, ref in zip((out, dq, dk, dv), (r_out, *refs)):
                    ref = ref.float()
                    assert bool(((got.float() - ref).abs() <= _bf16_tol(ref)).all()), tag
                assert bool(((lse - r_lse).abs() <= 2.0**-14 * (1 + r_lse.abs())).all()), tag
                terms = tfa.flash_delta(out.abs(), do.abs())
                assert bool(((delta - r_delta).abs() <= 2.0**-16 * terms + 2.0**-30).all()), tag
    tfa.reset_launch_counts()
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    tfa.flash_attention(qg, kg, vg, causal=True, window=48).backward(do)
    assert tfa.launch_counts == {"flash_fwd": 1, "flash_bwd_dkdv": 1, "flash_bwd_dq": 1}

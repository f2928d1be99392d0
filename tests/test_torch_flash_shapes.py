"""PyTorch port: the training flash attention at the model families' head
dims (80, 96 and 256) against the JAX package.

The same numpy inputs (fp32, from a seed) go through the port's
``flash_attention`` on CPU tensors (its ``autograd.Function`` over the plain
forward and backward) and through the JAX package's Pallas kernels in
interpret mode (``_pallas_flash(..., interpret=True)``: out, lse and
``jax.vjp``), as ``tests/test_torch_flash_attention.py`` does at head dim
64: d 80 causal (GQA 4/2), d 96 with a window of 48, d 256 with ALiBi; B 1,
S 128, ``block_q = block_k = 128``. At d 256 the backward's order (dq first,
handing delta = rowsum(dO * O) to dk/dv) is held to the same ``jax.vjp``
through the wrappers. Tolerance rtol 2e-4 / atol 2e-5 (fp32 sums in another
order), that file's. The shape rule ``unsupported_shape`` takes every
preset's attention shape at d 64 / 80 / 96 / 128 / 256 and names d 32 (the
CPU-only tiny presets) with ROADMAP A5b. The CUDA kernels at these head dims
run only on a card (``chip_smoke.py --phases build,train_kernels``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu_torch.models as models
from deepspeed_tpu.ops.pallas import flash_attention as jfa
from deepspeed_tpu_torch.models.transformer import alibi_slopes
from deepspeed_tpu_torch.ops import flash_attention as tfa

TOL = dict(rtol=2e-4, atol=2e-5)
S = 128
CASES = {  # name -> (query heads, kv heads, head_dim, causal, window, alibi)
    "d80_causal_gqa": (4, 2, 80, True, None, False),
    "d96_window48": (2, 2, 96, True, 48, False),
    "d256_alibi": (2, 2, 256, True, None, True),
}


def _inputs(name):
    nq, nkv, d = CASES[name][:3]
    rng = np.random.default_rng(sum(map(ord, name)))
    shapes = ((1, S, nq, d), (1, S, nkv, d), (1, S, nkv, d), (1, S, nq, d))
    return [rng.normal(size=s).astype(np.float32) for s in shapes]  # q, k, v, dout


@functools.lru_cache(maxsize=None)
def _jax_reference(name):
    """The Pallas kernels in interpret mode: (out, dq, dk, dv), lse."""
    _, _, _, causal, window, alibi = CASES[name]
    q, k, v, do = (jnp.asarray(x) for x in _inputs(name))
    kw = dict(causal=causal, block_q=128, block_k=128, interpret=True, window=window,
              alibi=alibi)
    out, vjp = jax.vjp(lambda a, b, c: jfa._pallas_flash(a, b, c, **kw), q, k, v)
    grads = [np.asarray(x) for x in (out, *vjp(do))]
    _, lse = jfa._flash_fwd_impl(causal, 128, 128, True, window, alibi, q, k, v)
    return grads, np.asarray(lse)


def _assert_all_close(ours, ref, tag):
    for name, a, b in zip(("out", "dq", "dk", "dv"), ours, ref):
        np.testing.assert_allclose(a, b, err_msg=f"{tag}: {name}", **TOL)


@pytest.mark.parametrize("name", list(CASES))
def test_plain_version_matches_pallas_interpret_at_family_head_dims(name):
    nq, _, _, causal, window, alibi = CASES[name]
    q, k, v, do = _inputs(name)
    ref, lse_ref = _jax_reference(name)
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = tfa.flash_attention(qt, kt, vt, causal=causal, window=window, alibi=alibi)
    out.backward(torch.from_numpy(do))
    _assert_all_close([x.detach().numpy() for x in (out, qt.grad, kt.grad, vt.grad)], ref, name)
    slopes = torch.from_numpy(alibi_slopes(nq)) if alibi else None
    _, lse = tfa.flash_attention_reference(*(torch.from_numpy(x) for x in (q, k, v)), causal,
                                           window, slopes)
    assert lse.shape == (1, nq, S) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), lse_ref, **TOL)


def test_dq_then_dkdv_wrappers_match_jax_vjp_at_d256():
    """``flash_bwd_dq`` hands back delta = rowsum(dO * O) [B, nq, S] beside
    dq, and ``flash_bwd_dkdv`` takes it in place of the output: at d 256 the
    wrappers on CPU tensors match ``jax.vjp`` of the Pallas kernels."""
    name = "d256_alibi"
    nq, _, _, causal, window, _ = CASES[name]
    ref, _ = _jax_reference(name)
    qt, kt, vt, dot = (torch.from_numpy(x) for x in _inputs(name))
    slopes = torch.from_numpy(alibi_slopes(nq))
    out, lse = tfa.flash_fwd(qt, kt, vt, causal, window, slopes)
    dq, delta = tfa.flash_bwd_dq(qt, kt, vt, out, lse, dot, causal, window, slopes)
    assert delta.shape == (1, nq, S) and delta.dtype == torch.float32
    np.testing.assert_allclose(delta.numpy(), np.einsum("bsnd,bsnd->bns", dot.numpy(), ref[0]),
                               **TOL)
    dk, dv = tfa.flash_bwd_dkdv(qt, kt, vt, lse, delta, dot, causal, window, slopes)
    _assert_all_close([x.numpy() for x in (out, dq, dk, dv)], ref, f"{name} wrappers")


PRESET_SHAPES = [("phi_config", "2", 80), ("gpt_neox_config", "20b", 96),
                 ("gptj_config", "6b", 256), ("gpt_neox_config", "pythia-1b", 256),
                 ("falcon_config", "7b", 64), ("mistral_config", "7b", 128),
                 ("qwen2_config", "7b", 128), ("phi_config", "tiny", 32),
                 ("gptj_config", "tiny", 32)]


@pytest.mark.parametrize("fn,size,d", PRESET_SHAPES)
def test_shape_rule_takes_every_preset_head_dim_and_names_d32(fn, size, d):
    """``unsupported_shape`` is the flash kernels' one rule: empty for the
    presets at head dims 64 / 80 / 96 / 128 / 256 at any group size; the
    tiny presets' d 32 is named, with ROADMAP A5b (no longer A5b.2)."""
    cfg = getattr(models, fn)(size)
    assert cfg.head_dim == d
    misses = tfa.unsupported_shape(cfg.num_heads, cfg.num_kv_heads, cfg.head_dim)
    if d in (64, 80, 96, 128, 256):
        assert misses == []
    else:
        assert len(misses) == 1 and f"head_dim {d} " in misses[0]
        assert "ROADMAP A5b)" in misses[0] and "A5b.2" not in misses[0]

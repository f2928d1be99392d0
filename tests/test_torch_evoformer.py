"""PyTorch port: Evoformer attention (DS4Sci_EvoformerAttention) against the
JAX package.

The same numpy inputs (fp32, from a seed) go through both packages on the
CPU:

- the port's plain forward (out, lse) and plain backward (dq; dk / dv with
  db1; db2) against the JAX package's Pallas kernels in interpret mode,
  ``_evo_fwd_impl`` / ``_evo_bwd_impl(..., interpret=True)`` called
  directly with 128-wide tiles at R 128 and R 256 (grids of several
  blocks), on the same ``out`` / ``lse``;
- the port's ``autograd.Function`` (``evo_flash``, over the plain versions
  on CPU tensors) and public ``evoformer_attention`` on CPU tensors (the
  chunked plain path, which CPU tensors take whatever the bias layout)
  against ``jax.vjp`` of the JAX package's, for the output and all five
  cotangents: mask and pair bias, mask only, pair only, none; leading dims
  (2,); an OpenFold mask bias (1e9 * (mask - 1)) with a fully masked MSA
  row; a bias given in bf16; the AlphaFold and the non-AlphaFold layouts
  through the chunked path with seq_chunk 0 and 2 (n_seq / seq_chunk plain
  calls, never the kernel route); R 96 and 200, which the TPU's lane rule
  keeps off its kernel (the JAX side then takes its jnp path);
- on CPU tensors each autograd Function's backward is one call of its
  plain backward;
- the tensor-core forward's and dq's arithmetic, emulated tile by tile
  (bf16 operands, fp32 sums per tile pair, P and dS as bf16 hi + lo
  pairs), against the plain versions and the Pallas kernels in interpret
  mode at R 100, 130 and 384, within ``chip_smoke.py``'s tolerance for the
  card.

Tolerances are the JAX package's own (``tests/test_aux_components.py``):
3e-5 for the forward, 5e-5 for the gradients (fp32 sums in another order).
A bias gradient returned in bf16 is the same fp32 sum rounded once on each
side: the fp32 sums agree within the gradient tolerance and the rounding
adds at most one bf16 ulp, so those are held to rtol 2^-7, atol 5e-5.

On a fully masked row (every key at -1e9) all scores equal -1e9 in fp32
and the output is an average that keeps no digits of q . k: it is compared
for finiteness only. The model masks those outputs downstream, so the
upstream gradient there is 0, as it is in these tests, which makes every
cotangent well-conditioned and compared in full.

The CUDA kernels run only on a card (``gpu`` marker).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import evoformer_attn as jea
from deepspeed_tpu.ops.pallas import evoformer_attention as jev
from deepspeed_tpu_torch.ops import evoformer_attention as tev
from deepspeed_tpu_torch.ops import evoformer_attn as tea

FWD_TOL = dict(rtol=3e-5, atol=3e-5)
GRAD_TOL = dict(rtol=5e-5, atol=5e-5)
NAMES = ("dq", "dk", "dv", "dbias1", "dbias2")


def _qkv(rng, shape):
    return [rng.normal(size=shape).astype(np.float32) for _ in range(4)]  # q, k, v, dout


def _t(*xs):
    return [None if x is None else torch.from_numpy(np.array(x, np.float32)) for x in xs]


def _j(*xs):
    return [None if x is None else jnp.asarray(x) for x in xs]


def _assert_counts_zero():
    assert all(n == 0 for n in tev.launch_counts.values()), tev.launch_counts


# ---------------------------------------------------------------------------
# the plain versions against the Pallas kernels in interpret mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("R", [128, 256])
def test_plain_versions_match_pallas_interpret(R):
    rng = np.random.default_rng(R)
    N, G, h, d = 4, 2, 2, 32
    q, k, v, do = _qkv(rng, (N, R, h, d))
    b1 = (2 * rng.normal(size=(N, R))).astype(np.float32)
    b2 = rng.normal(size=(G, h, R, R)).astype(np.float32)
    out_j, lse_j = jev._evo_fwd_impl(128, 128, True, *_j(q, k, v, b1, b2))
    out_t, lse_t = tev.evo_attention_reference(*_t(q, k, v, b1, b2))
    assert lse_t.shape == (N, h, R) and lse_t.dtype == torch.float32
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **FWD_TOL)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), **FWD_TOL)

    # each plain backward on the same out / lse as the Pallas backward
    out_n, lse_n = np.asarray(out_j), np.asarray(lse_j)
    ref = jev._evo_bwd_impl(128, 128, True, *_j(q, k, v, b1, b2, out_n, lse_n, do))
    ops = _t(q, k, v, b1, b2, out_n, lse_n, do)
    dq = tev.evo_bwd_dq(*ops)
    dk, dv, db1 = tev.evo_bwd_dkdv(*ops)
    db2 = tev.evo_bwd_db2(*ops)
    for name, a, b in zip(NAMES, (dq, dk, dv, db1, db2), ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **GRAD_TOL)
    assert db1.shape == (N, R) and db2.shape == (G, h, R, R)
    _assert_counts_zero()


@pytest.mark.parametrize("biases", ["both", "mask", "pair", "none"])
def test_evo_flash_function_matches_jax_vjp(biases):
    """The port's autograd.Function against jax.vjp of the JAX ``evo_flash``
    (Pallas in interpret mode): out and every present cotangent; an
    absent bias gets None and its pass is skipped."""
    rng = np.random.default_rng(3)
    N, G, R, h, d = 4, 2, 128, 2, 32
    q, k, v, do = _qkv(rng, (N, R, h, d))
    b1 = (2 * rng.normal(size=(N, R))).astype(np.float32) if biases in ("both", "mask") else None
    b2 = (rng.normal(size=(G, h, R, R)).astype(np.float32) if biases in ("both", "pair")
          else None)
    present = [x for x in (q, k, v, b1, b2) if x is not None]

    def jfn(*args):
        it = iter(args)
        a, b, c = next(it), next(it), next(it)
        return jev.evo_flash(a, b, c, next(it) if b1 is not None else None,
                             next(it) if b2 is not None else None, block_q=128, block_k=128,
                             interpret=True)

    out_j, vjp = jax.vjp(jfn, *_j(*present))
    grads_j = vjp(jnp.asarray(do))
    ts = [t.requires_grad_() for t in _t(*present)]
    it = iter(ts)
    tq, tk, tv = next(it), next(it), next(it)
    tb1 = next(it) if b1 is not None else None
    tb2 = next(it) if b2 is not None else None
    out_t = tev.evo_flash(tq, tk, tv, tb1, tb2)
    out_t.backward(torch.from_numpy(do))
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), **FWD_TOL)
    names = [n for n, x in zip(NAMES, (q, k, v, b1, b2)) if x is not None]
    for name, t, g in zip(names, ts, grads_j):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), err_msg=name, **GRAD_TOL)
    _assert_counts_zero()


# ---------------------------------------------------------------------------
# the public op against the JAX package's
# ---------------------------------------------------------------------------

def _kernel_route(q, k, v, biases, seq_chunk=0):
    """The port's kernel route (leading dims collapsed, biases broadcast,
    the autograd Function), called directly: on CPU tensors the public op
    takes the plain path instead."""
    return tea._evoformer_kernel(q, k, v, *tea._route(q, biases))


def _compare_public(q, k, v, do, biases, seq_chunk=0, interpret=True, masked_rows=None,
                    bias_tol=None, port=None):
    """The port's evoformer_attention (or ``port``) on CPU tensors against
    jax.vjp of the JAX package's (interpret=True: the Pallas route where it
    takes the call, else its jnp path): out and every cotangent (q, k, v,
    biases)."""
    jb = [jnp.asarray(b) for b in biases]
    out_j, vjp = jax.vjp(
        lambda a, b, c, *bs: jea.evoformer_attention(a, b, c, bs, seq_chunk=seq_chunk,
                                                     interpret=interpret),
        *_j(q, k, v), *jb)
    grads_j = vjp(jnp.asarray(do))
    tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
    tb = [torch.from_numpy(np.array(b.astype(jnp.float32))).to(
        torch.bfloat16 if b.dtype == jnp.bfloat16 else torch.float32).requires_grad_()
        for b in jb]
    out_t = (port or tea.DS4Sci_EvoformerAttention)(tq, tk, tv, tb, seq_chunk=seq_chunk)
    out_t.backward(torch.from_numpy(do))
    o_t, o_j = out_t.detach().numpy(), np.asarray(out_j)
    if masked_rows is not None:  # fully masked rows: finite only
        assert np.isfinite(o_t[masked_rows]).all() and np.isfinite(o_j[masked_rows]).all()
        keep = np.ones(o_t.shape, bool)
        keep[masked_rows] = False
        o_t, o_j = o_t[keep], o_j[keep]
    np.testing.assert_allclose(o_t, o_j, **FWD_TOL)
    for i, (t, g) in enumerate(zip([tq, tk, tv, *tb], grads_j)):
        name = NAMES[i] if i < 3 else f"bias{i - 2}"
        assert t.grad.shape == t.shape and t.grad.dtype == t.dtype, name
        tol = GRAD_TOL if t.dtype == torch.float32 else bias_tol
        np.testing.assert_allclose(t.grad.float().numpy(), np.asarray(g.astype(jnp.float32)),
                                   err_msg=name, **tol)


def _biases(rng, lead, n_seq, R, h, scale=2.0):
    mask = (scale * rng.normal(size=(*lead, n_seq, 1, 1, R))).astype(np.float32)
    pair = rng.normal(size=(*lead, 1, h, R, R)).astype(np.float32)
    return mask, pair


@pytest.mark.parametrize("biases", ["both", "mask", "pair", "none"])
def test_public_op_matches_jax(biases):
    """The public op (CPU: the plain path) and the kernel route (its glue
    for each bias layout, over the Function's plain versions) against the
    JAX package's Pallas route in interpret mode."""
    rng = np.random.default_rng(5)
    B, n_seq, R, h, d = 1, 3, 128, 2, 32
    q, k, v, do = _qkv(rng, (B, n_seq, R, h, d))
    mask, pair = _biases(rng, (B, ), n_seq, R, h)
    chosen = {"both": [mask, pair], "mask": [mask], "pair": [pair], "none": []}[biases]
    _compare_public(q, k, v, do, chosen)
    _compare_public(q, k, v, do, chosen, port=_kernel_route)
    _assert_counts_zero()


def test_public_op_leading_dims_and_bf16_bias():
    """Leading dims (2,): the mask bias per sample, the pair bias given
    once ([1, 1, h, R, R]) and broadcast over both samples, in bf16; its
    gradient sums back over the broadcast and returns in bf16. The public
    op on CPU tensors takes the plain path, held to the JAX package's jnp
    path; the kernel route (the Function over the plain versions) is held
    to the Pallas route. Each side pairs with the one that rounds the bf16
    gradient where it does: the plain paths once after the fp32 sum over
    the samples, both kernel routes once per sample before it."""
    rng = np.random.default_rng(6)
    lead, n_seq, R, h, d = (2, ), 2, 128, 2, 32
    q, k, v, do = _qkv(rng, (*lead, n_seq, R, h, d))
    mask, _ = _biases(rng, lead, n_seq, R, h)
    pair = jnp.asarray(rng.normal(size=(1, 1, h, R, R)).astype(np.float32)).astype(jnp.bfloat16)
    tol = dict(rtol=2.0**-7, atol=5e-5)
    _compare_public(q, k, v, do, [mask, pair], interpret=False, bias_tol=tol)
    _compare_public(q, k, v, do, [mask, pair], bias_tol=tol, port=_kernel_route)


def test_public_op_openfold_mask_with_fully_masked_row():
    """OpenFold's mask bias, 1e9 * (mask - 1): the last residues padded and
    one MSA row fully masked. dout is 0 on that row (the model masks it)."""
    rng = np.random.default_rng(7)
    B, n_seq, R, h, d = 1, 4, 128, 2, 32
    q, k, v, do = _qkv(rng, (B, n_seq, R, h, d))
    mask = np.ones((B, n_seq, R), np.float32)
    mask[..., 115:] = 0.0  # padded residues
    mask[:, 2] = 0.0  # a padded MSA row: every key of its queries masked
    mask_bias = (1e9 * (mask - 1.0))[:, :, None, None, :].astype(np.float32)
    _, pair = _biases(rng, (B, ), n_seq, R, h)
    do[:, 2] = 0.0
    _compare_public(q, k, v, do, [mask_bias, pair], masked_rows=(slice(None), 2))
    _compare_public(q, k, v, do, [mask_bias, pair], masked_rows=(slice(None), 2),
                    port=_kernel_route)


@pytest.mark.parametrize("seq_chunk", [0, 2])
def test_public_op_chunked_path(seq_chunk):
    """A full per-(sequence, head) bias is not the AlphaFold pattern: both
    packages take the chunked plain path, with all its cotangents."""
    rng = np.random.default_rng(8)
    B, n_seq, R, h, d = 2, 4, 16, 4, 32
    q, k, v, do = _qkv(rng, (B, n_seq, R, h, d))
    mask, _ = _biases(rng, (B, ), n_seq, R, h)
    odd = rng.normal(size=(B, n_seq, h, R, R)).astype(np.float32)
    assert tea._route(torch.from_numpy(q), [torch.from_numpy(odd)]) is None
    _compare_public(q, k, v, do, [mask, odd], seq_chunk=seq_chunk, interpret=False)
    _assert_counts_zero()


@pytest.mark.parametrize("R", [96, 200])
def test_public_op_ragged_R_against_jnp_path(R):
    """R outside the TPU lane rule: the port routes it to its kernels'
    Function (ragged tiles are masked in the CUDA kernels), the JAX package
    to its jnp path."""
    rng = np.random.default_rng(R)
    B, n_seq, h, d = 1, 2, 2, 32
    q, k, v, do = _qkv(rng, (B, n_seq, R, h, d))
    mask, pair = _biases(rng, (B, ), n_seq, R, h)
    assert tea._route(torch.from_numpy(q), [torch.from_numpy(mask), torch.from_numpy(pair)])
    _compare_public(q, k, v, do, [mask, pair], interpret=False)


def test_single_bias_and_route_guard():
    """Mirrors the JAX package's route test. A missing pair bias still
    routes. The port's guard is its CUDA kernels' own, not the TPU's lane
    rule: head_dim 32 / 64 / 128 and bf16 / fp16 / fp32 q/k/v with any
    n_res (R 96 routes here, not on the TPU), because the kernels mask
    ragged tiles and have no (8, 128) tiling to fill."""
    B, n_seq, R, h, d = 1, 2, 128, 2, 32
    q = torch.zeros(B, n_seq, R, h, d)
    mask = torch.zeros(B, n_seq, 1, 1, R)
    pair = torch.zeros(B, 1, h, R, R)
    b1, b2 = tea._route(q, [mask])
    assert b1 is mask and b2 is None
    b1, b2 = tea._route(q, [pair, None, mask])
    assert b1 is mask and b2 is pair
    assert tea._route(q, []) == (None, None)
    # a full per-(seq, head) bias is not the AlphaFold pattern -> no route
    assert tea._route(q, [torch.zeros(B, n_seq, h, R, R)]) is None
    assert tea._route(q, [mask, mask]) is None  # a second mask bias
    # the TPU's lane rule keeps R 96 off its kernel; the CUDA kernels take it
    q96 = torch.zeros(B, n_seq, 96, h, d)
    assert jea._pallas_route(jnp.zeros(q96.shape), [], interpret=True) is None
    assert tea._route(q96, []) == (None, None)
    # head dims the kernels are not built for, and float64, take the plain path
    assert tea._route(torch.zeros(B, n_seq, R, h, 16), []) is None
    assert tea._route(torch.zeros(B, n_seq, R, h, 48), []) is None
    assert tea._route(q.double(), []) is None
    # the kernel wrapper refuses what the kernels do not take
    with pytest.raises(ValueError):
        tev.evo_flash(q[0], q[0], q[0], torch.zeros(n_seq, R + 1))
    with pytest.raises(ValueError):
        tev.evo_flash(q[0], q[0], q[0], None, torch.zeros(3, h, R, R))


@pytest.mark.parametrize("dtype, expected", [(torch.bfloat16, "mma"), (torch.float16, "mma"),
                                             (torch.float32, "fp32")])
def test_route_is_chosen_by_the_dtype_alone(dtype, expected):
    """bf16 and fp16 q/k/v take the tensor-core forward, dq, dk/dv and db2,
    fp32 the CUDA-core ones (whose tolerance the 16-bit products cannot
    hold); each route has its own C entry points and launch counts, and
    nothing else (shape, biases) decides."""
    assert tev.route(dtype) == expected
    sfx = tev._SUFFIX[expected]
    for kernel in ("fwd", "bwd_dq", "bwd_dkdv", "bwd_db1", "bwd_db2"):
        assert f"evo_{kernel}{sfx}" in tev.launch_counts
    assert {"evo_fwd_fp32", "evo_bwd_dq_fp32"} <= set(tev.launch_counts)
    assert len(tev.launch_counts) == 10  # five kernels x two routes
    src = (Path(tev.__file__).parent / "csrc" / "evoformer_attention.cu").read_text()
    for entry in ("ds_evo_fwd", "ds_evo_bwd_dq", "ds_evo_bwd_dkdv", "ds_evo_bwd_db2"):
        assert f"int {entry}{sfx}(" in src  # the route's C entry point
    with pytest.raises(ValueError):
        tev.route(torch.float64)


@pytest.mark.parametrize("n_seq, R, h, G", [(512, 384, 8, 1), (384, 384, 4, 1), (4, 100, 2, 2),
                                            (40, 257, 4, 2), (1, 64, 2, 3), (7, 1, 1, 1),
                                            (64, 2048, 8, 1), (5000, 64, 1, 1)])
def test_db2_row_chunks_cover_every_row_once(n_seq, R, h, G):
    """The tensor-core db2's row chunks: every row of a group in exactly one
    chunk, chunks in order and never empty, at most one a row; enough chunks
    that the grid gives every SM about ``DB2_CTAS_PER_SM`` CTAs where the
    rows allow, and one chunk where one chunk's grid already fills the card."""
    S = tev.db2_row_chunks(n_seq, R, h, G)
    assert 1 <= S <= n_seq
    bounds = tev.chunk_rows(n_seq, S)
    assert len(bounds) == S and bounds[0][0] == 0 and bounds[-1][1] == n_seq
    assert all(lo < hi for lo, hi in bounds)
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))  # in order, no gap, no overlap
    rows = [r for lo, hi in bounds for r in range(lo, hi)]
    assert rows == list(range(n_seq))
    per_chunk = (-(-R // 64))**2 * h * G
    target = tev.DB2_CTAS_PER_SM * tev.SMS
    if per_chunk >= target:
        assert S == 1
    elif S < n_seq:
        assert S * per_chunk >= target > (S - 1) * per_chunk
    else:
        assert S * per_chunk <= target


def test_db2_row_chunks_at_the_evoformer_shapes():
    """AlphaFold's crop: the MSA-row call (h 8, 288 tiles a chunk) splits its
    512 rows into 8 chunks, a triangle call (h 4, 144 tiles) its 384 rows
    into 15; a grid already wider than the card keeps one chunk."""
    assert tev.db2_row_chunks(512, 384, 8, 1) == 8
    assert tev.db2_row_chunks(384, 384, 4, 1) == 15
    assert tev.db2_row_chunks(64, 4096, 8, 1) == 1
    assert tev.db2_row_chunks(64, 2048, 8, 2) == 1


def test_cpu_tensor_never_launches_a_kernel():
    rng = np.random.default_rng(9)
    q, k, v, do = _t(*_qkv(rng, (2, 100, 2, 64)))
    b1 = torch.zeros(2, 100)
    for t in (q, k, v, b1):
        t.requires_grad_()
    tev.evo_flash(q, k, v, b1).backward(do)
    assert q.grad is not None and b1.grad.shape == (2, 100)
    _assert_counts_zero()


@pytest.mark.parametrize("biases", ["both", "mask", "pair"])
def test_cpu_routed_layout_takes_the_chunked_path(monkeypatch, biases):
    """On CPU tensors the AlphaFold bias layouts, which ``_route`` accepts,
    go to the chunked plain path and honour ``seq_chunk`` (n_seq / seq_chunk
    calls of ``_attend``, never ``evo_flash``), as the JAX package does off
    the TPU without ``interpret``: output and every cotangent against its
    chunked path."""
    calls = []
    attend = tea._attend

    def counted(*args):
        calls.append(1)
        return attend(*args)

    def refuse(*args, **kw):
        raise AssertionError("a CPU call took the kernel route")

    monkeypatch.setattr(tea, "_attend", counted)
    monkeypatch.setattr(tea, "evo_flash", refuse)
    rng = np.random.default_rng(11)
    B, n_seq, R, h, d = 1, 4, 128, 2, 32
    q, k, v, do = _qkv(rng, (B, n_seq, R, h, d))
    mask, pair = _biases(rng, (B, ), n_seq, R, h)
    chosen = {"both": [mask, pair], "mask": [mask], "pair": [pair]}[biases]
    assert tea._route(torch.from_numpy(q), [torch.from_numpy(b) for b in chosen]) is not None
    _compare_public(q, k, v, do, chosen, seq_chunk=2, interpret=False)
    assert len(calls) == n_seq // 2
    _assert_counts_zero()


def test_evo_flash_backward_on_cpu_runs_the_plain_backward_once(monkeypatch):
    """On CPU tensors ``EvoFlash.backward`` is one call of the plain
    backward, whose five results it splits, and gives autograd's gradients
    of the plain forward."""
    calls = []
    plain = tev.evo_attention_reference_bwd

    def counted(*args):
        calls.append(1)
        return plain(*args)

    monkeypatch.setattr(tev, "evo_attention_reference_bwd", counted)
    rng = np.random.default_rng(12)
    N, R, h, d = 2, 100, 2, 64
    q, k, v, do = _qkv(rng, (N, R, h, d))
    b1 = rng.normal(size=(N, R)).astype(np.float32)
    b2 = rng.normal(size=(1, h, R, R)).astype(np.float32)
    ours = [t.requires_grad_() for t in _t(q, k, v, b1, b2)]
    tev.evo_flash(*ours).backward(torch.from_numpy(do))
    assert len(calls) == 1
    ref = [t.requires_grad_() for t in _t(q, k, v, b1, b2)]
    tev.evo_attention_reference(*ref)[0].backward(torch.from_numpy(do))
    for name, a, b in zip(NAMES, ours, ref):
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), err_msg=name, **GRAD_TOL)
    _assert_counts_zero()


# ---------------------------------------------------------------------------
# the tensor-core forward's and dq's tile walk, emulated on the CPU
# ---------------------------------------------------------------------------

TILE = 64
LOG2E = 1.4426950408889634


def _split(x):
    """x as the kernels feed it to the tensor cores: a pair hi + lo of bf16
    values (as fp32)."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def _tile_scores(qt, kt, b1, b2, q0, k0, scale):
    """scale * q.k (fp32 sums of the exact products of 16-bit values), then
    the pair bias, then the mask bias, for one (query tile, key tile)."""
    s = scale * (qt @ kt.transpose(-1, -2))
    if b2 is not None:
        s = s + b2[:, :, q0:q0 + TILE, k0:k0 + TILE]
    if b1 is not None:
        s = s + b1[:, None, None, k0:k0 + TILE]
    return s


def _walk_fwd(q, k, v, b1, b2):
    """(out in q's dtype, lse) by the tensor-core forward's walk: 64 x 64
    tiles (a ragged last tile holds only real keys), the online softmax
    from m = -1e30, l = 0 in base 2, P as a bf16 hi + lo pair into P.V,
    each tile pair summed from zero and added once to the rescaled
    accumulator."""
    N, R, h, d = q.shape
    scale = 1.0 / d**0.5
    b2n = None if b2 is None else b2.repeat_interleave(N // b2.shape[0], 0)  # row n: group n // n_seq
    qf, kf, vf = (t.float().permute(0, 2, 1, 3) for t in (q, k, v))  # [N, h, R, d]
    out, lse = torch.zeros(N, h, R, d), torch.zeros(N, h, R)
    for q0 in range(0, R, TILE):
        qt = qf[:, :, q0:q0 + TILE]
        m = torch.full(qt.shape[:3], -1e30)
        l, acc = torch.zeros(qt.shape[:3]), torch.zeros(qt.shape)
        for k0 in range(0, R, TILE):
            s = _tile_scores(qt, kf[:, :, k0:k0 + TILE], b1, b2n, q0, k0, scale)
            mx = torch.maximum(m, s.amax(-1))
            alpha = torch.exp2((m - mx) * LOG2E)
            p = torch.exp2((s - mx[..., None]) * LOG2E)
            l = l * alpha + p.sum(-1)
            hi, lo = _split(p)
            vt = vf[:, :, k0:k0 + TILE]
            acc = acc * alpha[..., None] + (hi @ vt + lo @ vt)
            m = mx
        l_safe = l.clamp_min(1e-30)
        out[:, :, q0:q0 + TILE] = acc / l_safe[..., None]
        lse[:, :, q0:q0 + TILE] = m + torch.log(l_safe)
    return out.permute(0, 2, 1, 3).to(q.dtype), lse


def _walk_dq(q, k, v, b1, b2, out, lse, dout):
    """dq in q's dtype by the tensor-core dq's walk: per 64 x 64 tile pair
    p = exp2((s - lse) log2 e), ds = p (dO.v - delta) with delta =
    rowsum(dO * O), ds as a bf16 hi + lo pair into ds.k summed from zero and
    added once; dq stored times scale."""
    N, R, h, d = q.shape
    scale = 1.0 / d**0.5
    b2n = None if b2 is None else b2.repeat_interleave(N // b2.shape[0], 0)
    qf, kf, vf, of, dof = (t.float().permute(0, 2, 1, 3) for t in (q, k, v, out, dout))
    delta = (dof * of).sum(-1)
    dq = torch.zeros(N, h, R, d)
    for q0 in range(0, R, TILE):
        qt, dot = qf[:, :, q0:q0 + TILE], dof[:, :, q0:q0 + TILE]
        acc = torch.zeros(qt.shape)
        for k0 in range(0, R, TILE):
            kt, vt = kf[:, :, k0:k0 + TILE], vf[:, :, k0:k0 + TILE]
            s = _tile_scores(qt, kt, b1, b2n, q0, k0, scale)
            p = torch.exp2((s - lse[:, :, q0:q0 + TILE, None]) * LOG2E)
            ds = p * (dot @ vt.transpose(-1, -2) - delta[:, :, q0:q0 + TILE, None])
            hi, lo = _split(ds)
            acc = acc + (hi @ kt + lo @ kt)
        dq[:, :, q0:q0 + TILE] = acc * scale
    return dq.permute(0, 2, 1, 3).to(q.dtype)


@pytest.mark.parametrize("R", [100, 130, 384])
@pytest.mark.parametrize("G", [1, 2])
def test_tensor_core_walk_matches_plain_and_pallas(R, G):
    """The tensor-core forward's and dq's arithmetic (bf16 operands, fp32
    sums per tile pair added once, P and dS as bf16 hi + lo pairs), emulated
    tile by tile, against the plain versions and the Pallas kernels in
    interpret mode on the same bf16-valued inputs, within the tolerance
    ``chip_smoke.py`` holds the card to (``_gpu_err``): d 32, 8 heads,
    ragged R, OpenFold's mask bias with padded residues and one fully
    masked row (out and lse there compared for finiteness; dO 0 there, as
    the model masks it)."""
    rng = np.random.default_rng(R + G)
    N, h, d = 3 * G, 8, 32
    q, k, v, do = (torch.from_numpy(x).to(torch.bfloat16) for x in _qkv(rng, (N, R, h, d)))
    mask = np.ones((N, R), np.float32)
    mask[:, R - R // 10:] = 0.0
    mask[1] = 0.0  # every key of row 1 masked
    b1 = torch.from_numpy(1e9 * (mask - 1.0))
    b2 = torch.from_numpy(rng.normal(size=(G, h, R, R)).astype(np.float32))
    do[1] = 0
    keep = torch.ones(N, dtype=torch.bool)
    keep[1] = False

    out, lse = _walk_fwd(q, k, v, b1, b2)
    assert torch.isfinite(out.float()).all() and torch.isfinite(lse).all()
    r_out, r_lse = tev.evo_attention_reference(q, k, v, b1, b2)
    block = 128 if R % 128 == 0 else R  # the Pallas tiles must divide R
    j_in = _j(*(t.float().numpy() for t in (q, k, v)), b1.numpy(), b2.numpy())
    p_out, p_lse = (torch.from_numpy(np.array(x)) for x in jev._evo_fwd_impl(
        block, block, True, *j_in))
    for ref_out, ref_lse in ((r_out, r_lse), (p_out, p_lse)):
        assert _gpu_err(out[keep], ref_out[keep], "low") <= 1.0
        assert _gpu_err(lse[keep], ref_lse[keep], "lse") <= 1.0

    dq = _walk_dq(q, k, v, b1, b2, out, lse, do)
    r_dq = tev.evo_attention_reference_bwd(q, k, v, b1, b2, out, lse, do)[0]
    terms = _abs_terms(q, k, v, b1, b2, out, lse, do)[0]
    p_dq = torch.from_numpy(np.array(jev._evo_bwd_impl(
        block, block, True, *j_in,
        *_j(out.float().numpy(), lse.numpy(), do.float().numpy()))[0]))
    for ref in (r_dq, p_dq):
        assert _gpu_err(dq, ref, "low", terms) <= 1.0
    assert not dq[1].any()  # dO 0 on the fully masked row
    _assert_counts_zero()


# ---------------------------------------------------------------------------
# the CUDA kernels (on a card only)
# ---------------------------------------------------------------------------

def _abs_terms(q, k, v, b1, b2, out, lse, do):
    """(dq, dk, dv, db1, db2) summed over the absolute values of their
    terms (ds taken as p (|dO| . |v| + rowsum |dO * O|)), as
    ``chip_smoke.py``'s ``_evo_abs_terms``."""
    N, R, h, d = q.shape
    scale = 1.0 / d**0.5
    s = tev._add_biases(scale * torch.einsum("nqhd,nkhd->nhqk", q.float(), k.float()), b1, b2)
    p = torch.exp(s - lse[..., None])
    ado = do.float().abs()
    adelta = (ado * out.float().abs()).sum(-1).permute(0, 2, 1)[..., None]
    a = p * (torch.einsum("nqhd,nkhd->nhqk", ado, v.float().abs()) + adelta)
    db2 = a.reshape(b2.shape[0], -1, h, R, R).sum(1) if b2 is not None else None
    return (scale * torch.einsum("nhqk,nkhd->nqhd", a, k.float().abs()),
            scale * torch.einsum("nhqk,nqhd->nkhd", a, q.float().abs()),
            torch.einsum("nhqk,nqhd->nkhd", p, ado), a.sum(dim=(1, 2)), db2)


def _gpu_err(got, ref, kind, terms=None):
    """The largest error as a fraction of ``chip_smoke.py``'s tolerance:
    bf16 / fp16 outputs 2 bf16 ulp(|ref|) + max(2^-14, 2^-12 rms(ref));
    fp32 outputs 2^-16 |ref| + 2^-14 rms(ref) + 2^-30; lse 2^-14 (1 + |ref|);
    the fp32 bias sums 2^-16 sqrt(terms) rms(ref) + 2^-30; each gradient
    plus 2^-18 of its sum over absolute terms (``terms``)."""
    ref = ref.float()
    err = (got.float() - ref).abs()
    rms = float(ref.pow(2).mean().sqrt())
    if kind == "lse":
        tol = 2.0**-14 * (1.0 + ref.abs())
    elif kind == "low":
        ulp = torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(2.0**-126))) - 7)
        tol = 2 * ulp + max(2.0**-14, 2.0**-12 * rms)
    elif kind == "fp32":
        tol = 2.0**-16 * ref.abs() + 2.0**-14 * rms + 2.0**-30
    else:
        tol = 2.0**-16 * kind**0.5 * rms + 2.0**-30
    if terms is not None:
        tol = tol + 2.0**-18 * terms
    return float((err / tol).max())


@pytest.mark.gpu
def test_cuda_kernels_match_plain_version_on_card():
    """On the card: out, lse, dq, dk, dv, db1, db2 of the kernels against the
    plain version on the same inputs (the backward on the kernel forward's
    out and lse): both biases or neither, G 1 and 2, ragged R (and R 1,
    where every gradient cancels to rounding), head_dim 32 / 64 / 128, bf16,
    fp16 and fp32, db2 with one row a group and with 40 rows a group split
    into chunks; each case's kernels launch on its dtype's route; the
    forward and dq on both routes at R 1, 100 and 257, head_dim 32 and 128,
    with three rows a group; and
    the autograd Function launches each kernel once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda")
    cases = [(4, 2, 200, 4, 32, torch.bfloat16, True), (3, 1, 130, 2, 64, torch.float32, True),
             (2, 2, 64, 2, 128, torch.bfloat16, False), (6, 3, 96, 8, 32, torch.float32, True),
             (4, 2, 1, 2, 32, torch.float32, True), (5, 1, 100, 2, 64, torch.float16, True),
             (2, 2, 160, 2, 32, torch.float16, True), (80, 2, 257, 4, 32, torch.bfloat16, True)]
    assert tev.db2_row_chunks(40, 257, 4, 2) > 1  # the last case splits its rows
    for N, G, R, h, d, dtype, with_b in cases:
        tev.reset_launch_counts()
        rng = np.random.default_rng(N * R + d)
        q, k, v, do = (torch.from_numpy(x).to(dev, dtype) for x in _qkv(rng, (N, R, h, d)))
        b1 = torch.from_numpy(2 * rng.normal(size=(N, R)).astype(np.float32)).to(dev)
        b2 = torch.from_numpy(rng.normal(size=(G, h, R, R)).astype(np.float32)).to(dev)
        if not with_b:
            b1 = b2 = None
        out, lse = tev.evo_fwd(q, k, v, b1, b2)
        r_out, r_lse = tev.evo_attention_reference(q, k, v, b1, b2)
        got = [tev.evo_bwd_dq(q, k, v, b1, b2, out, lse, do),
               *tev.evo_bwd_dkdv(q, k, v, b1, b2, out, lse, do)]
        got.append(tev.evo_bwd_db2(q, k, v, b1, b2, out, lse, do) if with_b else None)
        ref = tev.evo_attention_reference_bwd(q, k, v, b1, b2, out, lse, do)
        terms = _abs_terms(q, k, v, b1, b2, out, lse, do)
        torch.cuda.synchronize()
        kind = "low" if dtype != torch.float32 else "fp32"
        tag = f"N={N} G={G} R={R} h={h} d={d} {dtype} biases={with_b}"
        assert _gpu_err(out, r_out, kind) <= 1.0, tag
        assert _gpu_err(lse, r_lse, "lse") <= 1.0, tag
        for name, a, b, t in zip(NAMES[:3], got[:3], ref[:3], terms):
            assert _gpu_err(a, b, kind, t) <= 1.0, f"{name} {tag}"
        if with_b:
            assert _gpu_err(got[3], ref[3], h * R, terms[3]) <= 1.0, f"db1 {tag}"
            assert _gpu_err(got[4], ref[4], N // G, terms[4]) <= 1.0, f"db2 {tag}"
        sfx = "_fp32" if dtype == torch.float32 else ""
        routed = {f"evo_{k}{sfx}": 1 for k in ("fwd", "bwd_dq", "bwd_dkdv")} | (
            {f"evo_bwd_db1{sfx}": 1, f"evo_bwd_db2{sfx}": 1} if with_b else {})
        assert {k: n for k, n in tev.launch_counts.items() if n} == routed, tag
    for R in (1, 100, 257):
        for d in (32, 128):
            for dtype in (torch.bfloat16, torch.float32):
                tev.reset_launch_counts()
                N, G, h = 6, 2, 2
                rng = np.random.default_rng(R + d)
                q, k, v, do = (torch.from_numpy(x).to(dev, dtype)
                               for x in _qkv(rng, (N, R, h, d)))
                b1 = torch.from_numpy(2 * rng.normal(size=(N, R)).astype(np.float32)).to(dev)
                b2 = torch.from_numpy(rng.normal(size=(G, h, R, R)).astype(np.float32)).to(dev)
                out, lse = tev.evo_fwd(q, k, v, b1, b2)
                dq = tev.evo_bwd_dq(q, k, v, b1, b2, out, lse, do)
                r_out, r_lse = tev.evo_attention_reference(q, k, v, b1, b2)
                r_dq = tev.evo_attention_reference_bwd(q, k, v, b1, b2, out, lse, do)[0]
                t_dq = _abs_terms(q, k, v, b1, b2, out, lse, do)[0]
                torch.cuda.synchronize()
                kind = "low" if dtype != torch.float32 else "fp32"
                tag = f"fwd / dq N={N} G={G} R={R} d={d} {dtype}"
                assert _gpu_err(out, r_out, kind) <= 1.0, tag
                assert _gpu_err(lse, r_lse, "lse") <= 1.0, tag
                assert _gpu_err(dq, r_dq, kind, t_dq) <= 1.0, tag
                sfx = "_fp32" if dtype == torch.float32 else ""
                assert {k: n for k, n in tev.launch_counts.items() if n} == {
                    f"evo_fwd{sfx}": 1, f"evo_bwd_dq{sfx}": 1}, tag
    tev.reset_launch_counts()
    q, k, v, do = (torch.randn(4, 100, 2, 32, device=dev, dtype=torch.bfloat16) for _ in range(4))
    b1 = torch.zeros(4, 100, device=dev, requires_grad=True)
    b2 = torch.zeros(2, 2, 100, 100, device=dev, requires_grad=True)
    q.requires_grad_()
    tev.evo_flash(q, k, v, b1, b2).backward(do)
    torch.cuda.synchronize()
    assert tev.launch_counts == dict.fromkeys(tev.launch_counts, 0) | {
        "evo_fwd": 1, "evo_bwd_dq": 1, "evo_bwd_dkdv": 1, "evo_bwd_db1": 1, "evo_bwd_db2": 1}

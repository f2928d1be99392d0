"""PyTorch port: block-sparse attention against the JAX package.

Inputs are made from a seed with numpy and fed to both packages in fp32:

- every layout class over a grid of parameters (the seeded random patterns
  of Variable and BigBird included) and ``make_layout_lut``: bit for bit;
- the plain version ``block_sparse_attention_gathered`` against the JAX
  gathered form and against the Pallas kernel in interpret mode (through
  the JAX ``block_sparse_attention(..., interpret=True)``): causal and not,
  rpe, key padding and attn mask in both modes, per-head layouts, an empty
  row, head_dim 32 and 64. Tolerance 2e-5 (atol and rtol), the JAX
  package's own ``tests/test_sparse_attention.py`` tolerance: fp32 sums in
  another order;
- the ``autograd.Function`` on the CPU against ``jax.vjp`` of the JAX
  ``block_sparse_attention(interpret=True)``: q, k, v, a trainable rpe and
  an additive key-padding mask, at rtol 1e-4 / atol 2e-5 (gradients are
  longer sums);
- ``SparseSelfAttention``, ``BertSparseSelfAttention`` with weights carried
  from the JAX ``init``, the ``SparseAttentionUtils`` helpers and
  ``build_sparsity_config``'s errors;
- the kernels' route by dtype, and a torch emulation of the tensor-core
  kernel's walk (16-row warps, 16-key slices, causal slices above the
  diagonal skipped, P as a split hi + lo pair, each slice summed from zero
  into the alpha-rescaled accumulator) against the plain version and the
  Pallas kernel in interpret mode, within the tolerance ``chip_smoke.py``
  holds the card to.

The CUDA kernels run only on a card (``gpu`` marker).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import sparse_attention as jsa
from deepspeed_tpu_torch.models.convert import load_sparse_attention_params
from deepspeed_tpu_torch.ops import block_sparse_attention as tbs
from deepspeed_tpu_torch.ops import sparse_attention as tsa

TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=2e-5, rtol=1e-4)

LAYOUTS = {  # name -> (class name, constructor kwargs, seq_len)
    "dense": ("DenseSparsityConfig", dict(num_heads=2, block=16), 64),
    "fixed_bi": ("FixedSparsityConfig", dict(num_heads=4, block=16, num_local_blocks=4), 160),
    "fixed_uni_per_head": ("FixedSparsityConfig", dict(
        num_heads=4, block=16, different_layout_per_head=True, num_local_blocks=4,
        num_global_blocks=1, attention="unidirectional", num_different_global_patterns=4), 272),
    "fixed_horizontal": ("FixedSparsityConfig", dict(
        num_heads=2, block=32, num_local_blocks=4, num_global_blocks=2,
        horizontal_global_attention=True), 320),
    "variable_random": ("VariableSparsityConfig", dict(
        num_heads=4, block=16, different_layout_per_head=True, num_random_blocks=2,
        local_window_blocks=[2, 3], global_block_indices=[0, 5], seed=7), 256),
    "variable_uni_ranges": ("VariableSparsityConfig", dict(
        num_heads=2, block=16, num_random_blocks=1, global_block_indices=[1, 6],
        global_block_end_indices=[3, 8], attention="unidirectional", seed=3), 192),
    "variable_horizontal": ("VariableSparsityConfig", dict(
        num_heads=2, block=16, local_window_blocks=[4], horizontal_global_attention=True), 128),
    "bigbird_bi": ("BigBirdSparsityConfig", dict(
        num_heads=4, block=16, different_layout_per_head=True, num_random_blocks=2, seed=11), 256),
    "bigbird_uni": ("BigBirdSparsityConfig", dict(
        num_heads=2, block=16, num_random_blocks=1, num_sliding_window_blocks=5,
        num_global_blocks=2, attention="unidirectional"), 192),
    "bslongformer_bi": ("BSLongformerSparsityConfig", dict(
        num_heads=2, block=16, global_block_indices=[0, 4]), 128),
    "bslongformer_uni_ranges": ("BSLongformerSparsityConfig", dict(
        num_heads=4, block=16, different_layout_per_head=True, num_sliding_window_blocks=5,
        global_block_indices=[2], global_block_end_indices=[4], attention="unidirectional"), 160),
    "local_uni": ("LocalSlidingWindowSparsityConfig", dict(num_heads=2, block=16), 128),
    "local_bi": ("LocalSlidingWindowSparsityConfig", dict(
        num_heads=2, block=16, num_sliding_window_blocks=5, attention="bidirectional"), 128),
}


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_layouts_and_luts_equal_jax(name):
    cls, kw, L = LAYOUTS[name]
    ours = getattr(tsa, cls)(**kw).make_layout(L)
    ref = getattr(jsa, cls)(**kw).make_layout(L)
    assert ours.dtype == ref.dtype == np.int8
    assert np.array_equal(ours, ref)
    for a, b in zip(tbs.make_layout_lut(ours), jsa.make_layout_lut(ref)):
        assert a.dtype == b.dtype == np.int32 and np.array_equal(a, b)


def test_make_layout_lut_pads_with_the_last_column():
    layout = np.zeros((1, 4, 4), np.int8)
    layout[0, 0, 0] = 1
    layout[0, 2, [1, 3]] = 1
    lut, nvalid = tbs.make_layout_lut(layout)
    assert lut.shape == (1, 4, 2) and nvalid.tolist() == [[1, 0, 2, 0]]
    assert lut[0, 2].tolist() == [1, 3] and lut[0, 0].tolist() == [0, 0]


def _fixed_layout(H, L, per_head=False, uni=True, block=16):
    kw = dict(num_heads=H, block=block, num_local_blocks=2, num_global_blocks=1,
              attention="unidirectional" if uni else "bidirectional")
    if per_head:
        kw.update(different_layout_per_head=True, num_different_global_patterns=2)
    return jsa.FixedSparsityConfig(**kw).make_layout(L)


CASES = {  # name -> (B, H, L, d, layout kind, causal, extras)
    "causal": (2, 2, 64, 32, "fixed_uni", True, {}),
    "bidirectional": (2, 2, 64, 32, "bigbird", False, {}),
    "rpe": (1, 2, 64, 32, "fixed_uni", True, {"rpe": True}),
    "masks_add": (2, 2, 64, 32, "fixed_uni", True, {"kp": "add", "am": "add"}),
    "masks_mul": (2, 2, 64, 32, "bigbird", False, {"kp": "mul", "am": "mul", "rpe": True}),
    "per_head": (1, 4, 64, 32, "fixed_per_head", True, {"kp": "mul", "am": "add"}),
    "empty_row": (1, 2, 64, 32, "empty_row", False, {}),
    "d64": (1, 2, 64, 64, "fixed_uni", True, {"rpe": True, "kp": "add"}),
}


def _case(name, seed=0):
    B, H, L, d, kind, causal, ext = CASES[name]
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.normal(size=(B, H, L, d)).astype(np.float32) for _ in range(4))
    if kind == "fixed_uni":
        layout = _fixed_layout(H, L)
    elif kind == "fixed_per_head":
        layout = _fixed_layout(H, L, per_head=True)
    elif kind == "bigbird":
        layout = jsa.BigBirdSparsityConfig(num_heads=H, block=16).make_layout(L)
    else:  # only the first block row attends anywhere: the others are empty
        layout = np.zeros((H, L // 16, L // 16), np.int8)
        layout[:, 0, 0] = 1
    kw = dict(causal=causal)
    if ext.get("rpe"):
        kw["rpe"] = rng.normal(size=(L, L)).astype(np.float32)
    for key, shape, name_ in (("kp", (B, L), "key_padding_mask"), ("am", (L, L), "attn_mask")):
        if key in ext:
            mode = ext[key]
            kw[name_] = ((rng.random(shape) > 0.2).astype(np.float32) if mode == "mul" else
                         rng.normal(size=shape).astype(np.float32))
            kw[f"{name_}_mode"] = mode
    return (q, k, v, do), layout, kw


def _as(kw, conv):
    return {k: conv(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}


@pytest.mark.parametrize("name", list(CASES))
def test_plain_version_matches_jax_gathered_and_pallas_interpret(name):
    (q, k, v, _), layout, kw = _case(name)
    lut, nvalid = tbs.make_layout_lut(layout)
    ours = tbs.block_sparse_attention_gathered(*(torch.from_numpy(x) for x in (q, k, v)), lut,
                                               nvalid, 16, **_as(kw, torch.from_numpy)).numpy()
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    jkw = _as(kw, jnp.asarray)
    ref = np.asarray(jsa.block_sparse_attention_gathered(jq, jk, jv, lut, nvalid, 16, **jkw))
    np.testing.assert_allclose(ours, ref, **TOL)
    pallas = np.asarray(jsa.block_sparse_attention(jq, jk, jv, layout, 16, interpret=True, **jkw))
    np.testing.assert_allclose(ours, pallas, **TOL)
    assert np.isfinite(ours).all()
    if name == "empty_row":
        np.testing.assert_array_equal(ours[:, :, 16:], 0.0)


def test_cpu_tensors_take_the_plain_version_without_a_launch():
    (q, k, v, _), layout, kw = _case("masks_add")
    lut, nvalid = tbs.make_layout_lut(layout)
    tbs.reset_launch_counts()
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    tkw = _as(kw, torch.from_numpy)
    out = tbs.block_sparse_fwd(qt, kt, vt, lut, nvalid, 16, **tkw)
    ref = tbs.block_sparse_attention_gathered(qt, kt, vt, lut, nvalid, 16, **tkw)
    assert torch.equal(out, ref)
    assert tbs.launch_counts == {"block_sparse_fwd": 0, "block_sparse_fwd_fp32": 0}
    with pytest.raises(ValueError, match="mask mode"):
        tbs.block_sparse_attention(qt, kt, vt, layout, 16, attn_mask_mode="max")


GRAD_CASES = {  # name -> (case, trainable extras)
    "causal_rpe": ("rpe", ("rpe", )),
    "masks_add_rpe": ("masks_add", ("key_padding_mask", "attn_mask")),
    "per_head_bidirectional": ("masks_mul", ("rpe", )),
}


@pytest.mark.parametrize("name", list(GRAD_CASES))
def test_autograd_function_matches_jax_vjp(name):
    case, trainable = GRAD_CASES[name]
    (q, k, v, do), layout, kw = _case(case, seed=1)
    names = ["q", "k", "v", *trainable]
    arrays = [q, k, v, *(kw[n] for n in trainable)]
    leaves = [torch.from_numpy(x).requires_grad_() for x in arrays]
    tkw = dict(_as(kw, torch.from_numpy), **dict(zip(trainable, leaves[3:])))
    out = tbs.block_sparse_attention(*leaves[:3], layout, 16, **tkw)
    out.backward(torch.from_numpy(do))

    def fn(*xs):
        jkw = dict(_as(kw, jnp.asarray), **dict(zip(trainable, xs[3:])))
        return jsa.block_sparse_attention(*xs[:3], layout, 16, interpret=True, **jkw)

    ref, vjp = jax.vjp(fn, *(jnp.asarray(x) for x in arrays))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)
    for n, leaf, g in zip(names, leaves, vjp(jnp.asarray(do))):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(g), err_msg=n, **GRAD_TOL)


def test_backward_over_head_chunks_equals_one_chunk(monkeypatch):
    """The recompute in chunks of heads gives the one-chunk gradients
    (heads are independent; the shared rpe's gradient sums over chunks)."""
    (q, k, v, do), layout, kw = _case("per_head", seed=2)
    kw["rpe"] = np.random.default_rng(3).normal(size=(64, 64)).astype(np.float32)

    def grads():
        leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v, kw["rpe"])]
        tkw = dict(_as(kw, torch.from_numpy), rpe=leaves[3])
        tbs.block_sparse_attention(*leaves[:3], layout, 16, **tkw).backward(torch.from_numpy(do))
        return [x.grad.numpy() for x in leaves]

    whole = grads()
    monkeypatch.setattr(tbs, "BWD_CHUNK_BYTES", 1)  # one head per chunk
    for a, b in zip(grads(), whole):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


def test_sparse_self_attention_module_matches_jax():
    rng = np.random.default_rng(5)
    q, k, v = (rng.normal(size=(2, 4, 64, 32)).astype(np.float32) for _ in range(3))
    cfg = dict(num_heads=4, block=16, num_local_blocks=2, attention="unidirectional")
    ours = tsa.SparseSelfAttention(tsa.FixedSparsityConfig(**cfg), max_seq_length=128)
    ref = jsa.SparseSelfAttention(jsa.FixedSparsityConfig(**cfg), max_seq_length=128)
    assert ours.causal and ref.causal
    out = ours(*(torch.from_numpy(x) for x in (q, k, v)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref(*(jnp.asarray(x) for x in (q, k, v)))),
                               **TOL)
    assert np.array_equal(ours.get_layout(64), ref.get_layout(64))
    with pytest.raises(ValueError, match="dividable"):
        ours(*(torch.from_numpy(x[:, :, :60]) for x in (q, k, v)))
    with pytest.raises(ValueError, match="exceeds"):
        ours.get_layout(256)


def test_bert_sparse_self_attention_matches_jax_with_carried_weights():
    cfg = dict(num_heads=4, block=16)
    ref = jsa.BertSparseSelfAttention(num_attention_heads=4, hidden_size=64,
                                      sparsity_config=jsa.BigBirdSparsityConfig(**cfg),
                                      max_seq_length=256)
    params = jax.tree.map(np.asarray, ref.init(jax.random.PRNGKey(0)))
    ours = tsa.BertSparseSelfAttention(4, 64, sparsity_config=tsa.BigBirdSparsityConfig(**cfg),
                                       max_seq_length=256, device="cpu")
    load_sparse_attention_params(ours, params)
    for name in ("query", "key", "value"):
        assert tuple(getattr(ours, name)["kernel"].shape) == (64, 64)  # [in, out]
    rng = np.random.default_rng(6)
    hidden = rng.normal(size=(2, 70, 64)).astype(np.float32)
    mask = np.ones((2, 70), np.float32)
    mask[1, 60:] = 0.0
    pad_len, _, mask_p, _, _, hidden_p = tsa.SparseAttentionUtils.pad_to_block_size(
        16, attention_mask=torch.from_numpy(mask), inputs_embeds=torch.from_numpy(hidden))
    j_pad = jsa.SparseAttentionUtils.pad_to_block_size(
        16, attention_mask=jnp.asarray(mask), inputs_embeds=jnp.asarray(hidden))
    assert pad_len == j_pad[0] == 10 and hidden_p.shape == (2, 80, 64)
    np.testing.assert_array_equal(mask_p.numpy(), np.asarray(j_pad[2]))
    out = ours(hidden_p, attention_mask=mask_p)
    ref_out = ref(params, j_pad[5], attention_mask=j_pad[2])
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out), atol=1e-4, rtol=1e-4)
    out = tsa.SparseAttentionUtils.unpad_sequence_output(pad_len, out)
    assert out.shape == (2, 70, 64)
    with pytest.raises(ValueError, match="not a multiple"):
        tsa.BertSparseSelfAttention(3, 64, device="cpu")
    with pytest.raises(ValueError, match="does not name"):
        load_sparse_attention_params(ours, {"query": params["query"]})


def test_sparse_attention_utils_match_jax():
    rng = np.random.default_rng(7)
    ids = rng.integers(1, 50, size=(2, 21)).astype(np.int64)
    mask = np.ones((2, 21), np.int64)
    emb = rng.normal(size=(2, 21, 8)).astype(np.float32)
    table = rng.normal(size=(50, 8)).astype(np.float32)
    ours = tsa.SparseAttentionUtils.pad_to_block_size(
        16, input_ids=torch.from_numpy(ids), attention_mask=torch.from_numpy(mask),
        token_type_ids=torch.from_numpy(mask * 0), position_ids=torch.from_numpy(mask),
        inputs_embeds=torch.from_numpy(emb), pad_token_id=3,
        model_embeddings=torch.from_numpy(table))
    ref = jsa.SparseAttentionUtils.pad_to_block_size(
        16, input_ids=jnp.asarray(ids), attention_mask=jnp.asarray(mask),
        token_type_ids=jnp.asarray(mask * 0), position_ids=jnp.asarray(mask),
        inputs_embeds=jnp.asarray(emb), pad_token_id=3, model_embeddings=jnp.asarray(table))
    assert ours[0] == ref[0] == 11
    for a, b in zip(ours[1:], ref[1:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    none = tsa.SparseAttentionUtils.pad_to_block_size(16, input_ids=torch.zeros(1, 32))
    assert none[0] == 0 and none[2] is None
    with pytest.raises(ValueError, match="at least one"):
        tsa.SparseAttentionUtils.pad_to_block_size(16)
    pe = rng.normal(size=(8, 4)).astype(np.float32)
    for n in (5, 20):
        np.testing.assert_array_equal(
            tsa.SparseAttentionUtils.extend_position_embedding(torch.from_numpy(pe), n).numpy(),
            np.asarray(jsa.SparseAttentionUtils.extend_position_embedding(jnp.asarray(pe), n)))

    class Tok:
        model_max_length = 8
        init_kwargs = {}

    tok = tsa.SparseAttentionUtils.update_tokenizer_model_max_length(Tok(), 128)
    assert tok.model_max_length == 128 and tok.init_kwargs["model_max_length"] == 128


@pytest.mark.parametrize("block,err,match", [
    ({"mode": "striped"}, NotImplementedError, "striped"),
    ({"mode": "fixed", "num_local_block": 8}, ValueError, "unknown keys"),
    ({"mode": "fixed", "num_sliding_window_blocks": 3}, ValueError, "unknown keys"),
    ({"mode": "fixed", "seed": 3}, ValueError, "unknown keys"),
    ({"mode": "fixed", "num_local_blocks": 3, "num_global_blocks": 2}, ValueError, "dividable"),
    ({"mode": "fixed", "attention": "sideways"}, NotImplementedError, "uni/bi"),
    ({"mode": "fixed", "attention": "unidirectional", "horizontal_global_attention": True},
     ValueError, "bi-directional"),
    ({"mode": "fixed", "num_different_global_patterns": 2}, ValueError, "different_layout"),
    ({"mode": "variable", "global_block_indices": [0, 2], "global_block_end_indices": [1]},
     ValueError, "length"),
    ({"mode": "bslongformer", "global_block_indices": [3], "global_block_end_indices": [2]},
     ValueError, "smaller"),
])
def test_build_sparsity_config_errors_match_jax(block, err, match):
    for mod in (tsa, jsa):
        with pytest.raises(err, match=match):
            mod.build_sparsity_config(block, num_heads=4)


def test_build_sparsity_config_builds_the_same_classes_as_jax():
    blocks = [{"mode": "dense", "block": 32},
              {"mode": "fixed", "block": 16, "num_local_blocks": 2, "attention": "unidirectional"},
              {"mode": "variable", "num_random_blocks": 1, "local_window_blocks": [2, 2]},
              {"mode": "bigbird", "num_sliding_window_blocks": 3, "seed": 3},
              {"mode": "bslongformer", "global_block_indices": [0, 3]},
              {"mode": "local", "num_sliding_window_blocks": 3}]
    for b in blocks:
        ours, ref = tsa.build_sparsity_config(b, 4), jsa.build_sparsity_config(b, 4)
        assert type(ours).__name__ == type(ref).__name__
        assert np.array_equal(ours.make_layout(ours.block * 8), ref.make_layout(ref.block * 8))


def test_route_is_chosen_by_the_dtype_alone():
    """bfloat16 and float16 take the tensor-core kernel
    (``ds_block_sparse_fwd``), float32 the CUDA-core one
    (``ds_block_sparse_fwd_fp32``), each counted under its own name;
    other dtypes are refused."""
    assert tbs.route(torch.bfloat16) == tbs.route(torch.float16) == "mma"
    assert tbs.route(torch.float32) == "fp32"
    names = {f"block_sparse_fwd{tbs._SUFFIX[tbs.route(dt)]}"
             for dt in (torch.bfloat16, torch.float16, torch.float32)}
    assert names == set(tbs.launch_counts) == {"block_sparse_fwd", "block_sparse_fwd_fp32"}
    for dt in (torch.float64, torch.int32):
        with pytest.raises(ValueError, match="bfloat16, float16 or float32"):
            tbs.route(dt)


# ---------------------------------------------------------------------------
# the tensor-core kernel's walk, emulated on the CPU
# ---------------------------------------------------------------------------

ROWS = 16  # query rows of a warp, and keys of a step
LOG2E = 1.4426950408889634


def _split(x, dtype):
    """x as the kernel feeds it to the tensor cores: a pair hi + lo of
    ``dtype`` values (as fp32)."""
    hi = x.to(dtype).float()
    return hi, (x - hi).to(dtype).float()


def _walk(q, k, v, lut, nvalid, block, dtype, slices, causal=False, rpe=None,
          key_padding_mask=None, attn_mask=None, key_padding_mask_mode="add",
          attn_mask_mode="mul"):
    """[B, H, L, d] in ``dtype`` by the tensor-core kernel's walk: a CTA's
    64 rows walk the union of their four 16-row warps' block rows' columns
    (``union_plan``) in steps of ``slices`` 16-key slices, skipping (with
    causal) the slices wholly above its last row; each warp masks the
    slices of columns its own row lacks and, with causal, those wholly
    above its rows, and skips a step with none of its own. S = scale * q.k
    from the 16-bit values with fp32 sums, then rpe, the key padding and
    the attn mask, the causal mask on the diagonal slice; the online softmax
    from m = -1e30, l = 0 in base 2, a score at or below -5e29 never
    entering; P as a hi + lo pair into P.V, each step's product summed from
    zero and added once to the rescaled accumulator; out = acc / max(l,
    1e-30). With ``slices`` 1 a warp's arithmetic is the per-warp walk's
    (its own row's columns in LUT order, one slice a step)."""
    B, H, L, d = q.shape
    scale = 1.0 / d**0.5
    qf, kf, vf = (t.to(dtype).float() for t in (q, k, v))
    kpb = (None if key_padding_mask is None else
           tbs._mask_to_bias(key_padding_mask, key_padding_mask_mode))
    amb = None if attn_mask is None else tbs._mask_to_bias(attn_mask, attn_mask_mode)
    spc = block // ROWS
    entries, count = tbs.union_plan(torch.as_tensor(lut), torch.as_tensor(nvalid), block, L)
    out = torch.zeros(B, H, L, d)
    ar = torch.arange(ROWS)

    def n_slices(c, q_last):  # of column c, for rows up to q_last
        return max(0, min(spc, (q_last - c * block + ROWS) // ROWS)) if causal else spc

    for h in range(H):
        for t in range(count.shape[1]):
            todo = []  # (k0, warp bits) of every slice the CTA stages, in order
            for e in entries[h, t, :int(count[h, t])].tolist():
                c, bits = e & (2**24 - 1), e >> 24
                todo += [(c * block + sl * ROWS, bits)
                         for sl in range(n_slices(c, min(64 * t + 64, L) - 1))]
            for w in range(4):
                q0 = 64 * t + ROWS * w
                if q0 >= L:
                    continue
                qt = qf[:, h, q0:q0 + ROWS]
                m = torch.full((B, ROWS), -1e30)
                l, acc = torch.zeros(B, ROWS), torch.zeros(B, ROWS, d)
                for i in range(0, len(todo), slices):
                    step = todo[i:i + slices]
                    on = [bits >> w & 1 and not (causal and k0 > q0 + ROWS - 1)
                          for k0, bits in step]
                    if not any(on):
                        continue
                    parts = []
                    for (k0, _), keep in zip(step, on):
                        sp = scale * (qt @ kf[:, h, k0:k0 + ROWS].transpose(-1, -2))
                        if rpe is not None:
                            sp = sp + rpe[q0:q0 + ROWS, k0:k0 + ROWS]
                        if kpb is not None:
                            sp = sp + kpb[:, None, k0:k0 + ROWS]
                        if amb is not None:
                            sp = sp + amb[q0:q0 + ROWS, k0:k0 + ROWS]
                        if causal and k0 == q0:  # the diagonal slice
                            sp = torch.where(ar[None, :] > ar[:, None], -1e30, sp)
                        parts.append(sp if keep else torch.full_like(sp, -1e30))
                    s = torch.cat(parts, -1)
                    vt = torch.cat([vf[:, h, k0:k0 + ROWS] for k0, _ in step], -2)
                    mx = torch.maximum(m, s.amax(-1))
                    alpha = torch.exp2((m - mx) * LOG2E)
                    p = torch.where(s > -5e29, torch.exp2((s - mx[..., None]) * LOG2E), 0.0)
                    l = l * alpha + p.sum(-1)
                    hi, lo = _split(p, dtype)
                    acc = acc * alpha[..., None] + (hi @ vt + lo @ vt)
                    m = mx
                out[:, h, q0:q0 + ROWS] = acc / l.clamp_min(1e-30)[..., None]
    return out.to(dtype)


WALK_CASES = dict(CASES,
                  block32=(2, 2, 128, 32, "fixed_uni_b32", True, {"rpe": True, "kp": "mul"}),
                  block64=(1, 2, 256, 64, "bigbird_b64", False, {"am": "add"}))


def _walk_case(name):
    if name in CASES:
        inputs, layout, kw = _case(name)
        return inputs, layout, kw, 16
    B, H, L, d, kind, causal, ext = WALK_CASES[name]
    rng = np.random.default_rng(9)
    inputs = tuple(rng.normal(size=(B, H, L, d)).astype(np.float32) for _ in range(4))
    block = 32 if kind == "fixed_uni_b32" else 64
    layout = (_fixed_layout(H, L, block=32) if kind == "fixed_uni_b32" else
              jsa.BigBirdSparsityConfig(num_heads=H, block=64).make_layout(L))
    kw = dict(causal=causal)
    if ext.get("rpe"):
        kw["rpe"] = rng.normal(size=(L, L)).astype(np.float32)
    if "kp" in ext:
        kw["key_padding_mask"] = (rng.random((B, L)) > 0.2).astype(np.float32)
        kw["key_padding_mask_mode"] = "mul"
    if "am" in ext:
        kw["attn_mask"] = rng.normal(size=(L, L)).astype(np.float32)
        kw["attn_mask_mode"] = "add"
    return inputs, layout, kw, block


@pytest.mark.parametrize("walk", [(torch.bfloat16, 2), (torch.float16, 2), (torch.bfloat16, 1)],
                         ids=["bf16", "fp16", "bf16-one-slice"])
@pytest.mark.parametrize("name", list(WALK_CASES))
def test_tensor_core_walk_matches_plain_and_pallas(name, walk):
    """The tensor-core kernel's arithmetic, emulated step by step on the
    16-bit values (two slices a step, the union walk; one, the per-warp
    walk's), against the plain version and the Pallas kernel in interpret
    mode on the same values, within the card's tolerance (2 bf16 ulps of
    |plain| plus max(2^-14, 2^-12 rms(plain))): the file's mask and layout
    cases (empty rows; with 'mul' key padding, a fully padded last sample)
    plus blocks of 32 and 64 (two and four slices a column, the diagonal
    inside a column). Empty rows and the padded sample are exact zeros."""
    dtype, slices = walk
    (q, k, v, _), layout, kw, block = _walk_case(name)
    if kw.get("key_padding_mask_mode") == "mul":
        kw["key_padding_mask"][-1] = 0.0  # every key of the last sample padded
    rounded = [torch.from_numpy(x).to(dtype).float() for x in (q, k, v)]
    lut, nvalid = tbs.make_layout_lut(layout)
    tkw = _as(kw, torch.from_numpy)
    out = _walk(*rounded, lut, nvalid, block, dtype, slices, **tkw).float()
    assert torch.isfinite(out).all()
    plain = tbs.block_sparse_attention_gathered(*rounded, lut, nvalid, block, **tkw)
    pallas = torch.from_numpy(np.array(jsa.block_sparse_attention(
        *(jnp.asarray(t.numpy()) for t in rounded), layout, block, interpret=True,
        **_as(kw, jnp.asarray))))
    for ref in (plain, pallas):
        assert bool(((out - ref).abs() <= _bf16_tol(ref)).all()), float((out - ref).abs().max())
    rows = torch.from_numpy(nvalid == 0).repeat_interleave(block, dim=1)  # [H, L]
    assert not out[:, rows].any()
    if kw.get("key_padding_mask_mode") == "mul":
        assert not out[-1].any()


@pytest.mark.parametrize("name", ["fixed_uni_per_head", "fixed_horizontal", "variable_random",
                                  "bigbird_bi", "bslongformer_uni_ranges"])
def test_union_plan_covers_each_row_with_exact_membership(name):
    """The union walk's descriptor against the layout: each tile of 64 rows
    lists the union of its four 16-row warps' block rows' columns, ascending
    and distinct, and warp w's bit is set exactly on its own row's columns
    (none for a warp past L); blocks of 16 (four rows a tile) and 32 (two)."""
    cls, kw, L = LAYOUTS[name]
    layout = getattr(tsa, cls)(**kw).make_layout(L)
    block = kw["block"]
    lut, nvalid = (torch.from_numpy(x) for x in tbs.make_layout_lut(layout))
    entries, count = tbs.union_plan(lut, nvalid, block, L)
    H, n_tiles = layout.shape[0], -(-L // 64)
    assert entries.dtype == count.dtype == torch.int32
    assert tuple(count.shape) == (H, n_tiles) and entries.shape[:2] == count.shape
    for h in range(H):
        for t in range(n_tiles):
            e = entries[h, t, :int(count[h, t])].long()
            cols, bits = (e & (2**24 - 1)).tolist(), (e >> 24).tolist()
            assert cols == sorted(set(cols))
            union = set()
            for w in range(4):
                q0 = 64 * t + 16 * w
                own = set(np.nonzero(layout[h, q0 // block])[0].tolist()) if q0 < L else set()
                assert {c for c, b in zip(cols, bits) if b >> w & 1} == own, (h, t, w)
                union |= own
            assert set(cols) == union and all(0 < b < 16 for b in bits)


def test_union_plan_is_cached_per_layout(monkeypatch):
    """``cached_union_plan`` builds the descriptor once while the same LUT
    tensors come back unmodified, and again for other tensors, an in-place
    edit, another block or length."""
    calls = []
    real = tbs.union_plan
    monkeypatch.setattr(tbs, "union_plan", lambda *args: calls.append(args[2:]) or real(*args))
    monkeypatch.setattr(tbs, "_union_memo", None)
    layout = _fixed_layout(2, 128)
    lut, nvalid = (torch.from_numpy(x) for x in tbs.make_layout_lut(layout))
    first = tbs.cached_union_plan(lut, nvalid, 16, 128)
    assert tbs.cached_union_plan(lut, nvalid, 16, 128) is first and len(calls) == 1
    for args in ((lut.clone(), nvalid, 16, 128), (lut, nvalid, 32, 128), (lut, nvalid, 16, 64)):
        tbs.cached_union_plan(*args)
    nvalid.add_(0)  # an in-place edit bumps the version counter
    again = tbs.cached_union_plan(lut, nvalid, 16, 128)
    assert len(calls) == 5 and again is not first
    assert all(torch.equal(a, b) for a, b in zip(again, first))


def _bf16_tol(ref):
    ulp = torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(2.0**-126))) - 7)
    return 2 * ulp + max(2.0**-14, 2.0**-12 * float(ref.pow(2).mean().sqrt()))


@pytest.mark.gpu
def test_cuda_kernel_matches_plain_version_on_card():
    """On the card: both routes against the plain version on the same
    inputs (every case above and the walk's blocks of 32 and 64, in bf16
    and fp16 on ``ds_block_sparse_fwd`` and fp32 on
    ``ds_block_sparse_fwd_fp32``, through the model's [B, S, n, d]
    strides), within 2 bf16 ulps of |plain| plus max(2^-14, 2^-12
    rms(plain)), as ``chip_smoke.py`` states it; each launch counted on its
    route; and the autograd function launches its route's kernel once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    tbs.reset_launch_counts()
    n = 0
    for name in WALK_CASES:
        (q, k, v, do), layout, kw, block = _walk_case(name)
        lut, nvalid = (torch.from_numpy(x).to(dev) for x in tbs.make_layout_lut(layout))
        tkw = _as(kw, lambda x: torch.from_numpy(x).to(dev))
        for dtype in (torch.bfloat16, torch.float16, torch.float32):
            # [B, H, L, d] views of [B, L, H, d] buffers, as the model passes them
            qt, kt, vt = (torch.from_numpy(x).to(dev, dtype).transpose(1, 2).contiguous()
                          .transpose(1, 2) for x in (q, k, v))
            out = tbs.block_sparse_fwd(qt, kt, vt, lut, nvalid, block, **tkw)
            ref = tbs.block_sparse_attention_gathered(qt, kt, vt, lut, nvalid, block,
                                                      **tkw).float()
            torch.cuda.synchronize()
            assert bool(((out.float() - ref).abs() <= _bf16_tol(ref)).all()), (name, dtype)
        n += 1
    assert tbs.launch_counts == {"block_sparse_fwd": 2 * n, "block_sparse_fwd_fp32": n}
    for dtype, sfx in ((torch.bfloat16, ""), (torch.float32, "_fp32")):
        tbs.reset_launch_counts()
        qg = qt.to(dtype).clone().requires_grad_()
        tbs.block_sparse_attention(qg, kt.to(dtype), vt.to(dtype), layout, block, **tkw).backward(
            torch.from_numpy(do).to(dev, dtype))
        assert tbs.launch_counts == {"block_sparse_fwd": 0, "block_sparse_fwd_fp32": 0,
                                     f"block_sparse_fwd{sfx}": 1} and qg.grad is not None

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
  ``build_sparsity_config``'s errors.

The CUDA kernel runs only on a card (``gpu`` marker).
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
    assert torch.equal(out, ref) and tbs.launch_counts == {"block_sparse_fwd": 0}
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


def _bf16_tol(ref):
    ulp = torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(2.0**-126))) - 7)
    return 2 * ulp + max(2.0**-14, 2.0**-12 * float(ref.pow(2).mean().sqrt()))


@pytest.mark.gpu
def test_cuda_kernel_matches_plain_version_on_card():
    """On the card: ``ds_block_sparse_fwd`` against the plain version on
    the same inputs (every case above, in bf16, fp16 and fp32, through the
    model's [B, S, n, d] strides), within 2 bf16 ulps of |plain| plus
    max(2^-14, 2^-12 rms(plain)), as ``chip_smoke.py`` states it; and the
    autograd function launches the kernel once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    for name in CASES:
        (q, k, v, do), layout, kw = _case(name)
        lut, nvalid = (torch.from_numpy(x).to(dev) for x in tbs.make_layout_lut(layout))
        tkw = _as(kw, lambda x: torch.from_numpy(x).to(dev))
        for dtype in (torch.bfloat16, torch.float16, torch.float32):
            # [B, H, L, d] views of [B, L, H, d] buffers, as the model passes them
            qt, kt, vt = (torch.from_numpy(x).to(dev, dtype).transpose(1, 2).contiguous()
                          .transpose(1, 2) for x in (q, k, v))
            out = tbs.block_sparse_fwd(qt, kt, vt, lut, nvalid, 16, **tkw)
            ref = tbs.block_sparse_attention_gathered(qt, kt, vt, lut, nvalid, 16, **tkw).float()
            torch.cuda.synchronize()
            assert bool(((out.float() - ref).abs() <= _bf16_tol(ref)).all()), (name, dtype)
    tbs.reset_launch_counts()
    qg = qt.clone().requires_grad_()
    tbs.block_sparse_attention(qg, kt, vt, layout, 16, **tkw).backward(
        torch.from_numpy(do).to(dev, qg.dtype))
    assert tbs.launch_counts == {"block_sparse_fwd": 1} and qg.grad is not None

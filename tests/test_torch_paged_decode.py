"""PyTorch port: the split paged decode over each token's live blocks.

The decode kernel splits each token's live blocks (not the table's
capacity, as the TPU grid does) into fp32 partials that a second kernel
merges. Their plain versions (``decode_split_plan``,
``paged_decode_partials_reference``, ``merge_decode_splits``) are held here
against the JAX package's per-token and KV-split Pallas grids in interpret
mode (``_pallas_paged(..., q_tile=1, kv_splits=N)``, which routes
``kv_splits > 1`` to ``_paged_kv_split``) and its gather oracle, on the
same inputs made from a seed with numpy, in fp32. Tolerance: 1e-5 of the
output's largest magnitude, per element. Both sides sum the same fp32 terms
(q.k over d <= 128, p.v over <= 160 slots, at most 8 partials) in another
order, which moves a sum by a few fp32 ulps of its terms (~1e-7 relative
each); 1e-5 leaves room for that and nothing else: one missing or doubled
block moves the output by ~1e-1 of its size. The CUDA kernels themselves
only run on a card (``gpu`` marker in ``test_torch_paged_attention.py``).
"""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models.transformer import alibi_slopes as jax_alibi_slopes
from deepspeed_tpu.ops.pallas import paged_attention as jpa
from deepspeed_tpu_torch.models.transformer import alibi_slopes
from deepspeed_tpu_torch.ops import paged_attention as tpa

REL = 1e-5
CASES = ["plain", "window", "alibi", "window_alibi", "int8", "int8_window"]
BS, MAX_BLOCKS, N_SEQS = 16, 10, 4  # 3 and 8 splits do not divide 10 blocks


def _setup(case, d, bs=BS, g=4, max_blocks=MAX_BLOCKS):
    """A decode batch whose tokens sit at different depths: a full table,
    a context of 4 blocks, one of 1 block (most of 8 splits have no live
    block), a token in the middle of a block (past the table when blocks
    are short), the pad run (seq 0, pos 0), and, with a window, contexts
    that start inside and past it."""
    tag = f"{case}/{d}" if (bs, g, max_blocks) == (BS, 4, MAX_BLOCKS) else f"{case}/{d}/{bs}/{g}"
    rng = np.random.default_rng(zlib.crc32(tag.encode()))
    nkv = 2
    nq = nkv * g
    pool = bs * max_blocks * N_SEQS + 1  # the trailing scratch slot
    kf = rng.normal(size=(pool, nkv, d)).astype(np.float32)
    vf = rng.normal(size=(pool, nkv, d)).astype(np.float32)
    tables = rng.permutation(N_SEQS * max_blocks).astype(np.int32).reshape(N_SEQS, max_blocks)
    kw = {}
    if case.startswith("int8"):
        ks = np.ascontiguousarray((np.abs(kf).max(axis=2) / 127.0).T, np.float32)  # [nkv, pool]
        vs = np.ascontiguousarray((np.abs(vf).max(axis=2) / 127.0).T, np.float32)
        kf = np.round(kf / ks.T[:, :, None]).clip(-127, 127).astype(np.int8)
        vf = np.round(vf / vs.T[:, :, None]).clip(-127, 127).astype(np.int8)
        kw = dict(k_scale=ks, v_scale=vs)
    if "alibi" in case:
        kw["alibi"] = alibi_slopes(nq)
    if "window" in case:
        kw["window"] = 37
    seq_idx = np.asarray([0, 1, 2, 3, 1, 0, 0], np.int32)
    pos = np.asarray([max_blocks * bs - 1, 4 * bs - 1, 5, 7 * bs + 9, 2 * bs, 0, 0], np.int32)
    q = rng.normal(size=(seq_idx.size, nq, d)).astype(np.float32)
    return dict(q=q, k=kf, v=vf, tables=tables, seq_idx=seq_idx, pos=pos, kw=kw)


def _torch_args(s):
    kw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v) for k, v in s["kw"].items()}
    args = (torch.from_numpy(s["q"]), torch.from_numpy(s["k"]), torch.from_numpy(s["v"]),
            torch.from_numpy(s["tables"]), torch.from_numpy(s["seq_idx"]),
            torch.from_numpy(s["pos"]), BS)
    return args, kw


def _jax(s):
    args = (jnp.asarray(s["q"]), jnp.asarray(s["k"]), jnp.asarray(s["v"]), jnp.asarray(s["tables"]),
            jnp.asarray(s["seq_idx"]), jnp.asarray(s["pos"]))
    kw, pallas_kw = {}, {}
    for k, v in s["kw"].items():
        if k == "alibi":
            kw[k] = v
            pallas_kw[k] = tuple(np.asarray(jax_alibi_slopes(len(v))).tolist())
        elif k == "window":
            kw[k] = pallas_kw[k] = v
        else:
            kw[k] = pallas_kw[k] = jnp.asarray(v)
    return args, kw, pallas_kw


def _close(ours, ref, msg=""):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=REL * np.abs(ref).max(), err_msg=msg)


@pytest.mark.parametrize("kv_splits", [1, 3, 8])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("case", CASES)
def test_partials_and_merge_match_jax_kv_split(case, d, kv_splits):
    """The plain partials over the live-range split, merged, against the
    Pallas grid with the same split count (per-token at 1, ``_paged_kv_split``
    above) in interpret mode and against the JAX gather oracle."""
    s = _setup(case, d)
    args, kw = _torch_args(s)
    acc, m, l = tpa.paged_decode_partials_reference(*args, kv_splits, **kw)
    T, nq = s["q"].shape[:2]
    assert acc.shape == (kv_splits, T, nq, d) and m.shape == l.shape == (kv_splits, T, nq)
    ours = tpa.merge_decode_splits(acc, m, l, torch.float32).numpy()
    jargs, jkw, pkw = _jax(s)
    out = jpa._pallas_paged(*jargs, block_size=BS, interpret=True, q_tile=1, kv_splits=kv_splits,
                            **pkw)
    _close(ours, out, f"kv_splits={kv_splits} vs the Pallas grid")
    _close(ours, jpa.paged_attention_reference(*jargs, BS, **jkw), "vs the gather oracle")


def _live_blocks(p, window):
    """The TPU kernels' block predicate for one token, block by block."""
    keep = [j for j in range(MAX_BLOCKS) if j * BS <= p]
    if window is not None:
        keep = [j for j in keep if (j + 1) * BS - 1 > p - window]
    return keep


@pytest.mark.parametrize("window", [None, 1, 17, 64, 1000])
def test_split_plan_takes_every_live_block_once(window):
    """For every position (negative, inside the table, past it) and split
    count: the splits are contiguous runs of blocks in split order, their
    union is exactly the blocks the TPU kernels' predicate keeps, each in
    one split, and split sizes differ by at most one block."""
    pos = torch.arange(-3, MAX_BLOCKS * BS + 40)
    for kv_splits in (1, 2, 3, 7, 8, 16):
        b0, b1 = tpa.decode_split_plan(pos, BS, MAX_BLOCKS, kv_splits, window)
        assert b0.shape == b1.shape == (kv_splits, pos.numel())
        for t, p in enumerate(pos.tolist()):
            runs = [(int(b0[s, t]), int(b1[s, t])) for s in range(kv_splits)]
            taken = [j for lo, hi in runs for j in range(lo, hi)]
            assert taken == _live_blocks(p, window), (p, kv_splits, runs)
            sizes = [hi - lo for lo, hi in runs]
            assert min(sizes) >= 0 and max(sizes) - min(sizes) <= 1, (p, kv_splits, runs)
            assert all(runs[i][1] == runs[i + 1][0] for i in range(kv_splits - 1))


def test_splits_without_a_live_block_are_neutral():
    """A token with one live block and 8 splits: the 7 splits without a live
    block hold m = -1e30, l = 0, acc = 0, and the merge gives the one live
    split's normalised output, the same as the whole softmax."""
    s = _setup("window_alibi", 64)
    args, kw = _torch_args(s)
    acc, m, l = tpa.paged_decode_partials_reference(*args, 8, **kw)
    t = 2  # seq 2 at position 5: one live block
    b0, b1 = tpa.decode_split_plan(args[5], BS, MAX_BLOCKS, 8, kw["window"])
    dead = (b1[:, t] == b0[:, t]).nonzero().flatten()
    assert dead.numel() == 7
    assert bool((m[dead, t] == tpa.MASK_VALUE).all()) and bool((l[dead, t] == 0).all())
    assert bool((acc[dead, t] == 0).all())
    live = int((b1[:, t] > b0[:, t]).nonzero().item())
    merged = tpa.merge_decode_splits(acc, m, l, torch.float32)
    _close(merged[t].numpy(), (acc[live, t] / l[live, t][:, None]).numpy())
    ref = tpa.paged_attention_reference(*args, **kw)
    _close(merged.numpy(), ref.numpy())


def test_merge_matches_the_jax_formula():
    """The plain merge against the TPU kernel's jnp merge expression
    (``_paged_kv_split``'s last three lines) on random partials, with dead
    splits (m = -1e30, l = 0, acc = 0) among them and one row all dead."""
    rng = np.random.default_rng(11)
    ks, T, nq, d = 5, 3, 4, 16
    acc = rng.normal(size=(ks, T, nq, d)).astype(np.float32)
    m = rng.normal(scale=4.0, size=(ks, T, nq)).astype(np.float32)
    l = rng.uniform(0.5, 30.0, size=(ks, T, nq)).astype(np.float32)
    dead = rng.random(size=(ks, T, nq)) < 0.4
    dead[:, 1, 2] = True
    acc[dead] = 0.0
    m[dead] = -1e30
    l[dead] = 0.0
    ours = tpa.merge_decode_splits(torch.from_numpy(acc), torch.from_numpy(m),
                                   torch.from_numpy(l), torch.float32).numpy()
    jm, jl = jnp.asarray(m)[..., None], jnp.asarray(l)[..., None]
    m_star = jnp.max(jm, axis=0, keepdims=True)
    w = jnp.exp(jm - m_star)
    ref = jnp.sum(jnp.asarray(acc) * w, axis=0) / jnp.maximum(jnp.sum(jl * w, axis=0), 1e-30)
    _close(ours, ref)
    assert not ours[1, 2].any()  # every split dead: 0 / 1e-30


@pytest.mark.parametrize("case", ["plain", "int8_window"])
def test_partial_and_merge_wrappers_take_the_plain_versions_on_cpu(case):
    """On CPU tensors the kernels-alone wrappers return the plain versions
    and launch nothing; the split route of ``paged_decode`` returns the
    plain gather version."""
    s = _setup(case, 64)
    args, kw = _torch_args(s)
    tpa.reset_launch_counts()
    parts = tpa.paged_decode_partials(*args, 3, **kw)
    for got, want in zip(parts, tpa.paged_decode_partials_reference(*args, 3, **kw)):
        assert torch.equal(got, want)
    merged = tpa.paged_decode_merge(*parts, dtype=torch.float32)
    assert torch.equal(merged, tpa.merge_decode_splits(*parts, torch.float32))
    assert torch.equal(tpa.paged_decode(*args, kv_splits=3, **kw),
                       tpa.paged_attention_reference(*args, **kw))
    assert all(v == 0 for v in tpa.launch_counts.values())


@pytest.mark.gpu
def test_decode_kernels_take_any_block_size_and_group_on_card():
    """On the card: both decode routes (1, 3 and 8 splits) and the split's
    partials and merge apart, at block sizes 1, 24 and 128 (a 64-position
    step spans many blocks, straddles blocks, or halves one) and at g 1 and
    8 query heads per kv head, d 64 and 128, bf16 and int8 pools, with a
    window and ALiBi. Tolerances as ``test_torch_paged_attention.py``'s
    ``gpu`` test: outputs 2 bf16 ulps at |plain| plus 2^-14; partials m
    2^-14 (1 + |m|), l 2^-14 l, acc 2^-14 l max|v|."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda")

    def bf16_close(out, ref):
        err = (out.float() - ref.float()).abs()
        ulp = torch.exp2(torch.floor(torch.log2(ref.float().abs().clamp_min(2.0**-126))) - 7)
        return bool((err <= 2 * ulp + 2.0**-14).all()), err.max().item()

    tol = 2.0**-14
    for bs, max_blocks in ((1, 160), (24, 10), (128, 10)):
        for g in (1, 8):
            for d in (64, 128):
                for case in ("window_alibi", "int8", "int8_window"):
                    s = _setup(case, d, bs=bs, g=g, max_blocks=max_blocks)
                    if "alibi" in case:
                        s["kw"]["alibi"] = alibi_slopes(s["q"].shape[1])
                    kw = {k: (torch.from_numpy(v).to(dev) if isinstance(v, np.ndarray) else v)
                          for k, v in s["kw"].items()}
                    q = torch.from_numpy(s["q"]).to(dev, torch.bfloat16)
                    if case.startswith("int8"):
                        k, v = torch.from_numpy(s["k"]).to(dev), torch.from_numpy(s["v"]).to(dev)
                        vmax = (v.float() * kw["v_scale"].t()[:, :, None]).abs().max()
                    else:
                        k = torch.from_numpy(s["k"]).to(dev, torch.bfloat16)
                        v = torch.from_numpy(s["v"]).to(dev, torch.bfloat16)
                        vmax = v.float().abs().max()
                    args = (q, k, v, torch.from_numpy(s["tables"]).to(dev),
                            torch.from_numpy(s["seq_idx"]).to(dev),
                            torch.from_numpy(s["pos"]).to(dev), bs)
                    tag = (bs, g, d, case)
                    ref = tpa.paged_attention_reference(*args, **kw)
                    for splits in (1, 3, 8):
                        ok, worst = bf16_close(tpa.paged_decode(*args, kv_splits=splits, **kw), ref)
                        assert ok, (tag, splits, worst)
                        acc, m, l = tpa.paged_decode_partials(*args, splits, **kw)
                        racc, rm, rl = tpa.paged_decode_partials_reference(*args, splits, **kw)
                        torch.cuda.synchronize()
                        assert bool(((m - rm).abs() <= tol * (1 + rm.abs())).all()), (tag, splits)
                        assert bool(((l - rl).abs() <= tol * rl).all()), (tag, splits)
                        assert bool(((acc - racc).abs() <= tol * vmax * rl[..., None]).all()), (
                            tag, splits)
                        ok, worst = bf16_close(tpa.paged_decode_merge(acc, m, l),
                                               tpa.merge_decode_splits(acc, m, l))
                        assert ok, (tag, splits, worst)

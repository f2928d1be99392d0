"""PyTorch port: paged attention.

The port's plain version (``deepspeed_tpu_torch.ops.paged_attention``) is
held against the JAX package's gather oracle and its Pallas kernels run in
interpret mode (per-token, q-tiled and KV-split grids) on the same inputs,
made from a seed with numpy, in fp32 at rtol 2e-4 / atol 2e-5 (the JAX
package's own tolerance for these kernels). The prefill tile descriptors,
the dispatch heuristics and the CPU behaviour of the kernel wrappers are
checked here; the CUDA kernels themselves only run on a card (``gpu``
marker), where ``chip_smoke.py`` also holds them against the plain version.
"""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.autotuning.kernel_config import set_kernel_config_path
from deepspeed_tpu.models.transformer import alibi_slopes as jax_alibi_slopes
from deepspeed_tpu.ops.pallas import paged_attention as jpa
from deepspeed_tpu_torch.models.transformer import alibi_slopes
from deepspeed_tpu_torch.ops import paged_attention as tpa

RTOL, ATOL = 2e-4, 2e-5
CASES = ["plain", "int8", "alibi", "window", "window_alibi", "int8_window", "gqa"]


@pytest.fixture(autouse=True)
def _fresh_registry():
    set_kernel_config_path(None)
    yield
    set_kernel_config_path(None)


def _setup(case, batch, d=32, bs=16, n_seqs=3, blocks_per_seq=4):
    rng = np.random.default_rng(zlib.crc32(f"{case}/{batch}".encode()))
    nkv, g = (2, 4) if case == "gqa" else (2, 2)
    nq = nkv * g
    pool = bs * blocks_per_seq * n_seqs
    kf = rng.normal(size=(pool, nkv, d)).astype(np.float32)
    vf = rng.normal(size=(pool, nkv, d)).astype(np.float32)
    tables = rng.permutation(n_seqs * blocks_per_seq).astype(np.int32).reshape(n_seqs,
                                                                               blocks_per_seq)
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
        kw["window"] = 17
    if batch == "prefill":
        # a prefill-shaped batch (T >= 64 and T >= 2 S): a 40-token chunk
        # mid-context, a 30-token chunk from position 0, one decode token,
        # then the pad run
        seq_idx = np.asarray([0] * 40 + [1] * 30 + [2] + [0] * 9, np.int32)
        pos = np.asarray(list(range(10, 50)) + list(range(30)) + [3 * bs + 12] + [0] * 9,
                         np.int32)
    elif batch == "mixed":
        # a 13-token prefill chunk, a 6-token chunk mid-context, one decode
        # token, then the pad run (seq 0, pos 0) that ragged batches carry
        seq_idx = np.asarray([0] * 13 + [1] * 6 + [2] + [0] * 4, np.int32)
        pos = np.asarray(list(range(20, 33)) + list(range(bs, bs + 6)) + [3 * bs + 5] + [0] * 4,
                         np.int32)
    else:
        # decode: one token per sequence at varied depths, plus the pad run
        seq_idx = np.asarray([0, 1, 2, 0, 0], np.int32)
        pos = np.asarray([blocks_per_seq * bs - 1, bs + 3, 2 * bs + 7, 0, 0], np.int32)
    q = rng.normal(size=(seq_idx.size, nq, d)).astype(np.float32)
    return dict(q=q, k=kf, v=vf, tables=tables, seq_idx=seq_idx, pos=pos, bs=bs, kw=kw)


def _torch_ref(s):
    kw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v) for k, v in s["kw"].items()}
    out = tpa.paged_attention_reference(
        torch.from_numpy(s["q"]), torch.from_numpy(s["k"]), torch.from_numpy(s["v"]),
        torch.from_numpy(s["tables"]), torch.from_numpy(s["seq_idx"]), torch.from_numpy(s["pos"]),
        s["bs"], **kw)
    return out.numpy()


def _jax_kw(s, pallas=False):
    kw = {}
    for k, v in s["kw"].items():
        if k == "alibi":
            kw[k] = tuple(np.asarray(jax_alibi_slopes(len(v))).tolist()) if pallas else v
        elif k == "window":
            kw[k] = v
        else:
            kw[k] = jnp.asarray(v)
    return kw


@pytest.mark.parametrize("batch", ["mixed", "decode"])
@pytest.mark.parametrize("case", CASES)
def test_reference_matches_jax_oracle_and_pallas_grids(case, batch):
    """One input set, four JAX answers (gather oracle; per-token, q-tiled
    and KV-split Pallas grids in interpret mode) and the port's plain
    version: all agree."""
    s = _setup(case, batch)
    ours = _torch_ref(s)
    args = (jnp.asarray(s["q"]), jnp.asarray(s["k"]), jnp.asarray(s["v"]), jnp.asarray(s["tables"]),
            jnp.asarray(s["seq_idx"]), jnp.asarray(s["pos"]))
    ref = jpa.paged_attention_reference(*args, s["bs"], **_jax_kw(s))
    np.testing.assert_allclose(ours, np.asarray(ref), rtol=RTOL, atol=ATOL)
    for q_tile, kv_splits in ((1, 1), (4, 1), (1, 4)):
        out = jpa._pallas_paged(*args, block_size=s["bs"], interpret=True, q_tile=q_tile,
                                kv_splits=kv_splits, **_jax_kw(s, pallas=True))
        np.testing.assert_allclose(ours, np.asarray(out), rtol=RTOL, atol=ATOL,
                                   err_msg=f"q_tile={q_tile} kv_splits={kv_splits}")


@pytest.mark.parametrize("case", ["plain", "int8_window"])
def test_wrappers_take_the_plain_version_on_cpu(case):
    """On CPU tensors every wrapper (and the dispatch) returns the plain
    version and launches nothing."""
    s = _setup(case, "mixed")
    ours = _torch_ref(s)
    kw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v) for k, v in s["kw"].items()}
    args = (torch.from_numpy(s["q"]), torch.from_numpy(s["k"]), torch.from_numpy(s["v"]),
            torch.from_numpy(s["tables"]), torch.from_numpy(s["seq_idx"]),
            torch.from_numpy(s["pos"]), s["bs"])
    tpa.reset_launch_counts()
    outs = [tpa.paged_decode(*args, kv_splits=1, **kw), tpa.paged_decode(*args, kv_splits=4, **kw),
            tpa.paged_prefill(*args, q_tile=4, **kw), tpa.paged_attention(*args, **kw)]
    for out in outs:
        np.testing.assert_array_equal(out.numpy(), ours)
    assert all(v == 0 for v in tpa.launch_counts.values())


def _random_runs(rng, n_seqs, T):
    """A ragged batch layout: contiguous runs of sequence rows (each row at
    most once), then the pad run of seq 0."""
    lens = rng.integers(1, 40, size=n_seqs)
    seq_idx, pos = [], []
    for s, n in enumerate(lens):
        start = int(rng.integers(0, 100))
        seq_idx += [s] * int(n)
        pos += list(range(start, start + int(n)))
    pad = T - len(seq_idx)
    return (np.asarray(seq_idx + [0] * pad, np.int32), np.asarray(pos + [0] * pad, np.int32))


@pytest.mark.parametrize("q_tile", [1, 4, 8, 16])
def test_prefill_tiles_never_cross_a_sequence(q_tile):
    """Every token lands in exactly one tile; a tile holds at most q_tile
    consecutive tokens of one run (so of one sequence); the tile's seq and
    position bounds are its tokens'."""
    rng = np.random.default_rng(q_tile)
    for trial in range(20):
        n_seqs = int(rng.integers(1, 6))
        seq_idx, pos = _random_runs(rng, n_seqs, T=n_seqs * 40 + int(rng.integers(0, 9)))
        start, length, seq, tmax, tmin = (t.numpy() for t in tpa.prefill_tiles(
            torch.from_numpy(seq_idx), torch.from_numpy(pos), q_tile, n_seqs))
        assert start.shape[0] == -(-seq_idx.size // q_tile) + n_seqs + 1
        covered = np.zeros(seq_idx.size, int)
        for i in np.nonzero(length)[0]:
            toks = np.arange(start[i], start[i] + length[i])
            assert length[i] <= q_tile
            assert (seq_idx[toks] == seq[i]).all(), f"tile {i} crosses a sequence"
            assert tmax[i] == pos[toks].max() and tmin[i] == pos[toks].min()
            if toks[0] > 0:  # a tile starts at a run start or q_tile past the previous tile
                assert seq_idx[toks[0] - 1] != seq[i] or length[i - 1] == q_tile
            covered[toks] += 1
        assert (covered == 1).all()


@pytest.mark.parametrize("case", ["gqa", "int8_window", "alibi"])
def test_prefill_route_at_its_tile_matches_pallas_q_tile_16(case, monkeypatch):
    """A prefill-shaped batch takes ``paged_prefill`` with no tile given,
    so the wrapper's default ``prefill_q_tile(g)`` applies (16 tokens at
    g = 4, 32 at g = 2); the port's route on CPU tensors (the plain version)
    is held against the Pallas q-tiled grid in interpret mode at q_tile 16."""
    s = _setup(case, "prefill")
    T, S = s["seq_idx"].size, s["tables"].shape[0]
    assert tpa.resolve_q_tile(T, S) > 1
    g = s["q"].shape[1] // s["k"].shape[1]
    assert tpa.prefill_q_tile(g) == 64 // g
    kw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v) for k, v in s["kw"].items()}
    args = (torch.from_numpy(s["q"]), torch.from_numpy(s["k"]), torch.from_numpy(s["v"]),
            torch.from_numpy(s["tables"]), torch.from_numpy(s["seq_idx"]),
            torch.from_numpy(s["pos"]), s["bs"])
    seen = []
    real = tpa.paged_prefill

    def spy(*a, **k):
        seen.append(k.get("q_tile"))
        return real(*a, **k)

    monkeypatch.setattr(tpa, "paged_prefill", spy)
    ours = tpa.paged_attention(*args, **kw).numpy()
    assert seen == [None]
    jargs = (jnp.asarray(s["q"]), jnp.asarray(s["k"]), jnp.asarray(s["v"]),
             jnp.asarray(s["tables"]), jnp.asarray(s["seq_idx"]), jnp.asarray(s["pos"]))
    out = jpa._pallas_paged(*jargs, block_size=s["bs"], interpret=True, q_tile=16,
                            **_jax_kw(s, pallas=True))
    np.testing.assert_allclose(ours, np.asarray(out), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("g", [1, 2, 3, 4, 5, 8, 16, 33, 64, 71])
def test_prefill_default_tile_fills_64_rows(g):
    """The prefill kernel's default tile is 64 // g tokens up to g 64:
    never more than 64 rows (tokens x query heads of a kv head), one CTA's
    chunk, and at least one token. Above 64 query heads a kv head (Falcon-
    7B's 71) it is 8 tokens, whose rows fill 64-row chunks, every one but
    the last full."""
    qt = tpa.prefill_q_tile(g)
    chunks = tpa.prefill_row_chunks(g, qt)
    if g <= 64:
        assert qt == 64 // g and 1 <= qt and qt * g <= 64 < (qt + 1) * g and chunks == 1
    else:
        assert qt == 8 and 64 * (chunks - 1) < qt * g <= 64 * chunks


def test_cached_prefill_tiles_reuse_only_the_same_unmodified_tensors():
    """The wrapper's descriptor memo: the same seq_idx / pos objects with the
    same tile and sequence count reuse the descriptors (the serving forward
    passes them to every layer); an in-place edit, another tile, another
    count or an equal copy recomputes, and the result is always
    ``prefill_tiles``'s."""
    rng = np.random.default_rng(7)
    seq_np, pos_np = _random_runs(rng, 3, T=130)
    seq_idx, pos = torch.from_numpy(seq_np), torch.from_numpy(pos_np)
    first = tpa.cached_prefill_tiles(seq_idx, pos, 16, 3)
    assert tpa.cached_prefill_tiles(seq_idx, pos, 16, 3) is first
    for got in (tpa.cached_prefill_tiles(seq_idx, pos, 8, 3),
                tpa.cached_prefill_tiles(seq_idx, pos, 16, 4),
                tpa.cached_prefill_tiles(seq_idx.clone(), pos, 16, 3)):
        assert got is not first
    fresh = tpa.cached_prefill_tiles(seq_idx, pos, 16, 3)
    assert fresh is not first  # the memo holds one entry: the last call's
    pos[5] += 1  # an in-place edit bumps the version counter
    edited = tpa.cached_prefill_tiles(seq_idx, pos, 16, 3)
    assert edited is not fresh
    for got, want in zip(edited, tpa.prefill_tiles(seq_idx, pos, 16, 3)):
        assert torch.equal(got, want)


def test_dispatch_heuristics_match_jax_defaults():
    for T in (1, 8, 32, 63, 64, 128, 512, 768):
        for S in (1, 4, 8, 32, 64):
            assert tpa.resolve_q_tile(T, S) == jpa._resolve_q_tile(T, S), (T, S)
            for mb in (1, 4, 7, 8, 16, 32, 64):
                for qt in (1, 8):
                    assert (tpa.resolve_kv_splits(T, S, mb, qt)
                            == jpa._resolve_kv_splits(T, S, mb, q_tile=qt)), (T, S, mb, qt)


@pytest.mark.gpu
def test_cuda_kernels_match_plain_version_on_card():
    """On the card: each kernel path against the plain version, bf16 and
    int8 pools, at head_dim 64, 80, 96, 128 and 256; the decode at 1, 3
    and 8 splits (8: more splits than the tables' blocks), the prefill at q_tile 4, at its
    full tile 64 // g given and at its default. Tolerance, per element: 2
    bf16 ulps at |plain| plus 2^-14. Both sum in fp32 and round once to bf16
    (the kernels' tensor-core products take the 16-bit inputs exactly and
    feed the probabilities as a split hi + lo pair, ~2^-17 relative), so
    their fp32 results differ by ~1e-6 of the terms' size and round to bf16
    numbers at most one ulp apart, two across a power of two; the floor
    covers near-zero outputs whose ulp is smaller than that difference. The
    split decode's two kernels apart: its fp32 partials against
    ``paged_decode_partials_reference`` (m within 2^-14 (1 + |m|), l within
    2^-14 l, acc within 2^-14 l max|v|: the split P and the scores' fp32
    rounding move a term by ~2^-17 of itself, and acc sums at most l max|v|),
    the merge kernel on them against ``merge_decode_splits`` (bf16 rule)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda")

    def bf16_close(out, ref):
        err = (out.float() - ref.float()).abs()
        ulp = torch.exp2(torch.floor(torch.log2(ref.float().abs().clamp_min(2.0**-126))) - 7)
        return bool((err <= 2 * ulp + 2.0**-14).all()), err.max().item()

    for case in CASES:
        for d in tpa.KERNEL_HEAD_DIMS:
            s = _setup(case, "mixed", d=d)
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
                    torch.from_numpy(s["seq_idx"]).to(dev), torch.from_numpy(s["pos"]).to(dev),
                    s["bs"])
            ref = tpa.paged_attention_reference(*args, **kw).float()
            for out in (tpa.paged_decode(*args, kv_splits=1, **kw),
                        tpa.paged_decode(*args, kv_splits=3, **kw),
                        tpa.paged_decode(*args, kv_splits=8, **kw),
                        tpa.paged_prefill(*args, q_tile=4, **kw),
                        tpa.paged_prefill(*args, q_tile=64 // (q.shape[1] // k.shape[1]), **kw),
                        tpa.paged_prefill(*args, **kw)):
                torch.cuda.synchronize()
                ok, worst = bf16_close(out, ref)
                assert ok, (case, d, worst)
            for splits in (1, 3, 8):
                acc, m, l = tpa.paged_decode_partials(*args, splits, **kw)
                racc, rm, rl = tpa.paged_decode_partials_reference(*args, splits, **kw)
                torch.cuda.synchronize()
                tol = 2.0**-14
                assert bool(((m - rm).abs() <= tol * (1 + rm.abs())).all()), (case, d, splits)
                assert bool(((l - rl).abs() <= tol * rl).all()), (case, d, splits)
                assert bool(((acc - racc).abs() <= tol * vmax * rl[..., None]).all()), (
                    case, d, splits)
                ok, worst = bf16_close(tpa.paged_decode_merge(acc, m, l),
                                       tpa.merge_decode_splits(acc, m, l))
                assert ok, (case, d, splits, worst)
    # descriptors left on the host would hand the kernel host pointers
    with pytest.raises(ValueError, match="block_tables"):
        tpa.paged_decode(args[0], args[1], args[2], args[3].cpu(), *args[4:], **kw)

"""PyTorch port: sampled decoding on the serving engine, against the JAX
package where the two must agree and against the filtered softmax where
they cannot (the port's draws are its own counter-based Gumbel-max, not
threefry).

* ``SamplingParams.validate`` / ``pack_sampling`` equal the JAX package's;
  ``filter_top_p`` / ``_filtered`` keep exactly its token sets (ties,
  ``top_p`` 1 and a tiny one included), but for tokens whose mass before
  them is within float32 rounding of ``top_p``.
* Temperature 0 is the argmax; a draw is a function of (seed, position,
  logits row) only: not of the batch's composition or order, nor of
  whether ``put`` or a ``decode`` horizon drew it.
* 20,000 draws pass a chi-square test (p > 1e-3) against the filtered
  softmax and never leave the nucleus.
* All-greedy ``sampling`` lists keep the streams equal to the JAX engine's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from deepspeed_tpu.inference.v2 import DSStateManagerConfig as JaxSMConfig
from deepspeed_tpu.inference.v2 import DynamicSplitFuseScheduler as JaxScheduler
from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.inference.v2 import RaggedInferenceEngineConfig as JaxConfig
from deepspeed_tpu.inference.v2 import sampling as jax_sampling
from deepspeed_tpu.models import llama2 as jax_llama2
from deepspeed_tpu_torch.inference.v2 import (DSStateManagerConfig, DynamicSplitFuseScheduler,
                                              InferenceEngineV2, RaggedInferenceEngineConfig,
                                              SamplingParams)
from deepspeed_tpu_torch.inference.v2 import sampling
from deepspeed_tpu_torch.models import llama2, llama2_config, params_from_jax

TINY = dict(num_layers=2, hidden_size=64, num_heads=4, num_kv_heads=2, intermediate_size=128,
            vocab_size=128, max_seq_len=256)
VOCAB = TINY["vocab_size"]


# ---------------------------------------------------------------------------
# knobs and the nucleus, against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(temperature=-0.1), dict(temperature=101.0),
                                dict(temperature=float("nan")), dict(top_p=0.0),
                                dict(top_p=1.5), dict(seed=2**31), dict(seed=-2**31 - 1),
                                dict(temperature=0.7, top_p=0.9, seed=-5), dict()])
def test_validate_agrees_with_jax(kw):
    def outcome(cls):
        try:
            cls(**kw).validate()
            return "ok"
        except ValueError:
            return "ValueError"

    assert outcome(SamplingParams) == outcome(jax_sampling.SamplingParams)


def test_pack_sampling_agrees_with_jax():
    knobs = [dict(temperature=0.8, top_p=0.95, seed=11), None, dict(temperature=0.5),
             dict(temperature=0.0, seed=3), dict(top_p=0.3, seed=-7)]
    uids = [4, 9, 123456789, 2, 77]
    tp = [None if k is None else SamplingParams(**k) for k in knobs]
    jp = [None if k is None else jax_sampling.SamplingParams(**k) for k in knobs]
    for got, want in zip(sampling.pack_sampling(tp, uids, 8),
                         jax_sampling.pack_sampling(jp, uids, 8)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert sampling.all_greedy([None, SamplingParams(temperature=0.0)])
    assert not sampling.all_greedy(tp) and sampling.all_greedy(None)


def _logit_rows():
    rng = np.random.default_rng(0)
    rows = rng.normal(size=(6, VOCAB)).astype(np.float32) * 1.5
    rows[1, :5] = rows[1].max() + 1.0  # five-way tie at the top
    rows[2, 10:40] = 0.25               # a tie across the nucleus boundary
    rows[3] = 0.0                       # flat: every token tied
    rows[4, 7] = 30.0                   # one token holds all the mass
    return rows


@pytest.mark.parametrize("top_p", [1.0, 0.95, 0.5, 0.1, 1e-6])
def test_filter_top_p_keeps_jax_token_sets(top_p):
    rows = _logit_rows()
    got = sampling.filter_top_p(torch.from_numpy(rows), top_p).numpy()
    want = np.asarray(jax_sampling.filter_top_p(jnp.asarray(rows), top_p))
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    np.testing.assert_array_equal(got[np.isfinite(got)], want[np.isfinite(want)])
    if top_p == 1e-6:  # only the top token (and its exact ties) survive
        kept = np.isfinite(got)
        np.testing.assert_array_equal(kept, rows >= rows.max(axis=1, keepdims=True))


def test_filtered_per_row_knobs_match_jax():
    """Per-row temperature and top-p. Row 2 (temperature 0.3, top_p 1)
    has tokens whose mass is below float32's resolution of the cumulative
    sum: whether the mass before them rounds to 1.0 (masked) depends on
    the summation order of each package's cumsum. Only such tokens, those
    whose exact (float64) mass before them lies within 2^-22 of top_p, may
    differ; every other membership must be equal."""
    rows = _logit_rows()
    temps = np.asarray([0.7, 1.0, 0.3, 2.0, 0.0, 1.3], np.float32)
    top_ps = np.asarray([0.9, 0.5, 1.0, 0.2, 0.95, 1e-3], np.float32)
    got = sampling._filtered(torch.from_numpy(rows), torch.from_numpy(temps),
                             torch.from_numpy(top_ps)).numpy()
    want = np.asarray(jax_sampling._filtered(jnp.asarray(rows), jnp.asarray(temps),
                                             jnp.asarray(top_ps)))
    scaled = rows.astype(np.float64) / np.maximum(temps, 1e-6)[:, None]
    p = np.exp(scaled - scaled.max(axis=1, keepdims=True))
    p /= p.sum(axis=1, keepdims=True)
    before = np.empty_like(p)  # exact mass of the tokens ranked above each
    for r in range(p.shape[0]):
        order = np.argsort(-scaled[r], kind="stable")
        before[r, order] = np.cumsum(p[r, order]) - p[r, order]
    differ = np.isfinite(got) != np.isfinite(want)
    assert (np.abs(before - top_ps[:, None])[differ] <= 2.0**-22).all()
    assert differ[[0, 1, 3, 4, 5]].sum() == 0
    both = np.isfinite(got) & np.isfinite(want)
    np.testing.assert_allclose(got[both], want[both], rtol=1e-6)


# ---------------------------------------------------------------------------
# the draw
# ---------------------------------------------------------------------------

def _draw(rows, temps, top_ps, seeds, ctrs):
    t = lambda a, dt: torch.as_tensor(np.asarray(a), dtype=dt)  # noqa: E731
    return sampling.sample_tokens(t(rows, torch.float32), t(temps, torch.float32),
                                  t(top_ps, torch.float32), t(seeds, torch.int32),
                                  t(ctrs, torch.int32)).numpy()


def test_greedy_rows_are_the_argmax_and_draws_ignore_the_batch():
    rng = np.random.default_rng(1)
    rows = rng.normal(size=(8, VOCAB)).astype(np.float32) * 2
    temps = np.asarray([0, 0.8, 0, 1.0, 0.5, 0, 1.2, 0.9], np.float32)
    top_ps = np.asarray([1, 0.95, 0.5, 1, 0.7, 1, 0.9, 0.99], np.float32)
    seeds = np.asarray([1, 2, 3, 4, 5, 6, 7, -8], np.int32)
    ctrs = np.asarray([0, 5, 9, 100, 2**20, 3, 77, 4], np.int32)
    full = _draw(rows, temps, top_ps, seeds, ctrs)
    greedy = temps == 0
    np.testing.assert_array_equal(full[greedy], rows[greedy].argmax(axis=1))
    assert full.dtype == np.int32
    for i in range(8):  # each row alone
        assert _draw(rows[i:i + 1], temps[i:i + 1], top_ps[i:i + 1], seeds[i:i + 1],
                     ctrs[i:i + 1])[0] == full[i]
    perm = rng.permutation(8)  # the batch in another order
    np.testing.assert_array_equal(_draw(rows[perm], temps[perm], top_ps[perm], seeds[perm],
                                        ctrs[perm]), full[perm])
    # another seed or position moves the draws; the same ones repeat them
    n = 64
    base = _draw(np.repeat(rows[1:2], n, 0), np.full(n, 1.0, np.float32),
                 np.ones(n, np.float32), np.full(n, 2, np.int32), np.arange(n, dtype=np.int32))
    again = _draw(np.repeat(rows[1:2], n, 0), np.full(n, 1.0, np.float32),
                  np.ones(n, np.float32), np.full(n, 2, np.int32), np.arange(n, dtype=np.int32))
    other = _draw(np.repeat(rows[1:2], n, 0), np.full(n, 1.0, np.float32),
                  np.ones(n, np.float32), np.full(n, 3, np.int32), np.arange(n, dtype=np.int32))
    np.testing.assert_array_equal(base, again)
    assert len(set(base.tolist())) > 10 and (base != other).sum() > n // 2


def test_uniforms_are_uniform_and_integer_exact():
    u = sampling.uniforms(torch.arange(64, dtype=torch.int32) * 7919 - 100,
                          torch.arange(64, dtype=torch.int32), 4096).numpy().ravel()
    assert 0.0 < u.min() and u.max() < 1.0
    assert stats.kstest(u, "uniform").pvalue > 1e-3
    # the extreme hashes stay inside (0, 1) in float32: the Gumbel noise is
    # finite, so a masked logit (-inf) can never win the argmax
    ends = sampling.unit_float(torch.tensor([0, 0xFFFFFFFF], dtype=torch.int64))
    assert ends.dtype == torch.float32 and 0.0 < float(ends[0]) and float(ends[1]) < 1.0
    assert torch.isfinite(-torch.log(-torch.log(ends))).all()
    # the int64 mixer equals the same arithmetic on exact Python integers
    def mix(v):
        v ^= v >> 16
        v = (v * 0x21F0AAAD) % 2**32
        v ^= v >> 15
        v = (v * 0x735A2D97) % 2**32
        return v ^ (v >> 15)

    x = [0, 1, 0xFFFFFFFF, 0x89ABCDEF, 0x12345678, 2**31]
    assert sampling._mix32(torch.tensor(x, dtype=torch.int64)).tolist() == [mix(v) for v in x]


def test_chi_square_against_the_filtered_softmax():
    rng = np.random.default_rng(2)
    row = (rng.normal(size=VOCAB) * 2.0).astype(np.float32)
    temp, top_p, n = 0.8, 0.95, 20_000
    filt = sampling._filtered(torch.from_numpy(row[None]), torch.tensor([temp]),
                              torch.tensor([top_p])).numpy()[0]
    p = np.exp(filt - filt[np.isfinite(filt)].max())
    p /= p.sum()
    draws = _draw(np.repeat(row[None], n, 0), np.full(n, temp, np.float32),
                  np.full(n, top_p, np.float32), np.full(n, 1234, np.int32),
                  np.arange(n, dtype=np.int32))
    assert np.isfinite(filt[draws]).all(), "a token outside the nucleus was drawn"
    counts = np.bincount(draws, minlength=VOCAB)
    order = np.argsort(-p)
    top = order[:64]
    keep = top[p[top] * n >= 5]  # buckets with at least 5 expected draws
    rest = np.setdiff1d(np.arange(VOCAB), keep)
    obs, exp = counts[keep], p[keep] * n
    if p[rest].sum() > 0:  # one bucket for the rest of the nucleus
        obs, exp = np.append(obs, counts[rest].sum()), np.append(exp, p[rest].sum() * n)
    assert len(obs) >= 20 and obs.sum() == n
    assert stats.chisquare(obs, exp * (n / exp.sum())).pvalue > 1e-3


# ---------------------------------------------------------------------------
# the engine and the scheduler
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    jmodel = jax_llama2("tiny", dtype=jnp.float32, attention_impl="reference", **TINY)
    jparams = jax.jit(lambda r: jmodel.init(r, None))(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              llama2_config("tiny", dtype=torch.float32, **TINY), device="cpu")
    tmodel = llama2("tiny", device="cpu", dtype=torch.float32, params=tparams, **TINY)
    return jmodel, jparams, tmodel


SM = dict(max_tracked_sequences=8, max_ragged_batch_size=64, max_ragged_sequence_count=8,
          max_context=96)


def _port(tiny):
    return InferenceEngineV2(tiny[2], RaggedInferenceEngineConfig(
        kv_block_size=8, num_kv_blocks=64, kv_dtype=torch.float32,
        state_manager=DSStateManagerConfig(**SM)), device="cpu")


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, VOCAB, size=n).astype(np.int32) for n in lens]


KNOBS = [SamplingParams(temperature=0.8, top_p=0.95, seed=5), None,
         SamplingParams(temperature=1.0, seed=17), SamplingParams(temperature=0.0, seed=1)]


def test_put_loop_and_decode_horizon_streams_are_identical(tiny):
    prompts = _prompts(3, [13, 7, 20, 9])
    uids = [1, 2, 3, 4]
    streams = []
    for use_decode in (False, True):
        eng = _port(tiny)
        first = eng.put(uids, prompts, sample="greedy", sampling=KNOBS)
        if use_decode:
            rest = eng.decode(uids, [[t] for t in first], 12, sampling=KNOBS)
        else:
            cols, cur = [], first
            for _ in range(12):
                cur = eng.put(uids, [[t] for t in cur], sample="greedy", sampling=KNOBS)
                cols.append(cur)
            rest = np.stack(cols, axis=1)
        streams.append(np.concatenate([first[:, None], rest], axis=1))
    np.testing.assert_array_equal(streams[0], streams[1])
    # the greedy rows (None and temperature 0) are the plain argmax stream
    eng = _port(tiny)
    first = eng.put(uids, prompts, sample="greedy")
    greedy = np.concatenate([first[:, None], eng.decode(uids, [[t] for t in first], 12)], 1)
    np.testing.assert_array_equal(streams[0][[1, 3]], greedy[[1, 3]])
    assert (streams[0][[0, 2]] != greedy[[0, 2]]).any()


def test_scheduler_sampled_streams_replay_under_any_batch_composition(tiny):
    """The same sampled requests through budgets that chunk and batch them
    differently, alone and together: every stream is the same."""
    prompts = _prompts(4, [30, 9, 17, 23])
    runs = []
    for budget, together in ((64, True), (16, True), (64, False)):
        eng = _port(tiny)
        out = {}
        sched = DynamicSplitFuseScheduler(eng, token_budget=budget)
        for uid, p in enumerate(prompts):
            sched.submit(uid, p, max_new_tokens=10, sampling=KNOBS[uid])
            if not together:
                out.update(sched.run())
        out.update(sched.run())
        runs.append(out)
    assert runs[0] == runs[1] == runs[2]
    with pytest.raises(ValueError):
        DynamicSplitFuseScheduler(_port(tiny)).submit(9, prompts[0],
                                                      sampling=SamplingParams(top_p=0.0))


def test_all_greedy_sampling_lists_match_the_jax_engine(tiny):
    jmodel, jparams, _ = tiny
    jeng = JaxEngine(jmodel, JaxConfig(kv_block_size=8, num_kv_blocks=64, kv_dtype=jnp.float32,
                                       state_manager=JaxSMConfig(**SM),
                                       use_pallas_kernels="never"), params=jparams)
    prompts = _prompts(5, [25, 6, 14])
    res = []
    for eng, sched_cls, sp in ((jeng, JaxScheduler, jax_sampling.SamplingParams),
                               (_port(tiny), DynamicSplitFuseScheduler, SamplingParams)):
        sched = sched_cls(eng, token_budget=32)
        for uid, p in enumerate(prompts):
            sched.submit(uid, p, max_new_tokens=8,
                         sampling=[None, sp(temperature=0.0, seed=3), sp()][uid])
        res.append(sched.run())
    assert res[0] == res[1]

"""PyTorch port: paged attention at head dims 80, 96 and 256 and group sizes
over 8 (phi-2, GPT-NeoX-20B, GPT-J-6B / Pythia, Falcon-40B and Falcon-7B).

The port's plain version (what the kernel wrappers run on CPU tensors) is
held against the JAX package's gather oracle and its Pallas kernels in
interpret mode (the per-token or q-tiled grid, each new head dim and group
size meeting one) on the same inputs,
made from a seed with numpy, in fp32 at rtol 2e-4 / atol 2e-5 (the JAX
package's own tolerance for these kernels), one small case per new shape;
the split decode's plain partials and merge against the same. The host-side
plans the kernels launch by (the decode's head tiles of <= 8 query heads,
the prefill's default tile and its 64-row chunks) are checked without a
device, and so is the grid's index arithmetic, emulated: every (token,
query head) row lands in exactly one CTA. Last, the serving engine through
the CUDA attention module (plain versions on the CPU) against the JAX
engine at phi-2's and Falcon-7B's head shapes. The CUDA kernels themselves
only run on a card (``gpu`` marker in ``test_torch_paged_attention.py``),
where ``chip_smoke.py`` also holds them against the plain version.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu.models as jax_models
from deepspeed_tpu.inference.v2 import DSStateManagerConfig as JaxSMConfig
from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.inference.v2 import RaggedInferenceEngineConfig as JaxConfig
from deepspeed_tpu.models.transformer import alibi_slopes as jax_alibi_slopes
from deepspeed_tpu.ops.pallas import paged_attention as jpa
import deepspeed_tpu_torch.models as models
from deepspeed_tpu_torch.inference.v2 import (DSStateManagerConfig, InferenceEngineV2,
                                              ModulesConfig, RaggedInferenceEngineConfig)
from deepspeed_tpu_torch.models import params_from_jax
from deepspeed_tpu_torch.models.transformer import alibi_slopes
from deepspeed_tpu_torch.ops import paged_attention as tpa

RTOL, ATOL = 2e-4, 2e-5
# name -> (kv heads, group size, head_dim, int8 pools, ALiBi, window)
SHAPES = {
    "phi2_d80_int8": (4, 1, 80, True, False, None),
    "neox_d96": (4, 1, 96, False, False, 17),
    "gptj_d256_alibi": (2, 1, 256, False, True, None),
    "falcon40b_g16_alibi_window": (2, 16, 64, False, True, 17),
    "falcon7b_g71_int8_window": (1, 71, 64, True, False, 17),
}
# name -> the Pallas grids it meets (q_tile 1: per token; 8: q-tiled): every
# head dim, group size, int8, ALiBi and window meets one, g 71 both
PALLAS_Q_TILES = {
    "phi2_d80_int8": (1, ),
    "neox_d96": (8, ),
    "gptj_d256_alibi": (1, ),
    "falcon40b_g16_alibi_window": (8, ),
    "falcon7b_g71_int8_window": (1, 8),
}
GROUPS = (1, 4, 7, 8, 16, 64, 71, 128)


def _setup(name, bs=16):
    """A mixed batch: a 9-token prefill chunk (a tile of 8 and one of 1), a
    2-token chunk mid-context, one decode token at the end of its table,
    then the pad run (seq 0, pos 0) that ragged batches carry."""
    nkv, g, d, int8, alibi, window = SHAPES[name]
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    n_seqs, bps = 3, 4
    pool = bs * bps * n_seqs + 1  # the trailing scratch slot
    kf = rng.normal(size=(pool, nkv, d)).astype(np.float32)
    vf = rng.normal(size=(pool, nkv, d)).astype(np.float32)
    tables = rng.permutation(n_seqs * bps).astype(np.int32).reshape(n_seqs, bps)
    kw = {}
    if int8:
        ks = np.ascontiguousarray((np.abs(kf).max(axis=2) / 127.0).T, np.float32)  # [nkv, pool]
        vs = np.ascontiguousarray((np.abs(vf).max(axis=2) / 127.0).T, np.float32)
        kf = np.round(kf / ks.T[:, :, None]).clip(-127, 127).astype(np.int8)
        vf = np.round(vf / vs.T[:, :, None]).clip(-127, 127).astype(np.int8)
        kw = dict(k_scale=ks, v_scale=vs)
    if alibi:
        kw["alibi"] = alibi_slopes(nkv * g)
    if window:
        kw["window"] = window
    seq_idx = np.asarray([0] * 9 + [1] * 2 + [2] + [0], np.int32)
    pos = np.asarray(list(range(20, 29)) + [bs + 3, bs + 4] + [bps * bs - 1] + [0], np.int32)
    q = rng.normal(size=(seq_idx.size, nkv * g, d)).astype(np.float32)
    return dict(q=q, k=kf, v=vf, tables=tables, seq_idx=seq_idx, pos=pos, bs=bs, kw=kw)


def _torch_args(s):
    kw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v) for k, v in s["kw"].items()}
    return (torch.from_numpy(s["q"]), torch.from_numpy(s["k"]), torch.from_numpy(s["v"]),
            torch.from_numpy(s["tables"]), torch.from_numpy(s["seq_idx"]),
            torch.from_numpy(s["pos"]), s["bs"]), kw


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


@pytest.mark.parametrize("name", list(SHAPES))
def test_plain_matches_jax_oracle_and_pallas_grids(name):
    """The port's paged attention (its wrappers' CPU route: the plain
    version) against the JAX gather oracle and against the per-token or
    q-tiled (8 tokens a tile) Pallas grid in interpret mode, as
    ``PALLAS_Q_TILES`` assigns them; the split decode's plain partials (3
    splits) merged by the plain merge against the oracle."""
    s = _setup(name)
    args, kw = _torch_args(s)
    ours = tpa.paged_attention(*args, **kw).numpy()
    jargs = (jnp.asarray(s["q"]), jnp.asarray(s["k"]), jnp.asarray(s["v"]),
             jnp.asarray(s["tables"]), jnp.asarray(s["seq_idx"]), jnp.asarray(s["pos"]))
    ref = np.asarray(jpa.paged_attention_reference(*jargs, s["bs"], **_jax_kw(s)))
    np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=ATOL)
    merged = tpa.merge_decode_splits(*tpa.paged_decode_partials_reference(*args, 3, **kw),
                                     dtype=torch.float32).numpy()
    np.testing.assert_allclose(merged, ref, rtol=RTOL, atol=ATOL)
    for q_tile in PALLAS_Q_TILES[name]:
        out = jpa._pallas_paged(*jargs, block_size=s["bs"], interpret=True, q_tile=q_tile,
                                **_jax_kw(s, pallas=True))
        np.testing.assert_allclose(ours, np.asarray(out), rtol=RTOL, atol=ATOL,
                                   err_msg=f"q_tile={q_tile}")


@pytest.mark.parametrize("name", ["phi2_d80_int8", "falcon7b_g71_int8_window"])
def test_wrappers_take_the_new_shapes_and_the_plain_version_on_cpu(name):
    """Every wrapper takes the new shapes on CPU tensors (no shape check
    refuses them) and returns the plain version, launching nothing, at the
    default tile and at tiles whose rows overflow one 64-row chunk."""
    args, kw = _torch_args(_setup(name))
    ours = tpa.paged_attention_reference(*args, **kw)
    tpa.reset_launch_counts()
    outs = [tpa.paged_decode(*args, kv_splits=1, **kw), tpa.paged_decode(*args, kv_splits=3, **kw),
            tpa.paged_prefill(*args, **kw), tpa.paged_prefill(*args, q_tile=13, **kw)]
    for out in outs:
        assert torch.equal(out, ours)
    assert all(v == 0 for v in tpa.launch_counts.values())


def test_shape_rule_takes_the_new_head_dims_and_any_group():
    """``unsupported_shape`` is the one rule: head dims 64, 80, 96, 128 and
    256 at any group size; it still names head_dim 32 and a head count that
    the kv heads do not divide."""
    for d in (64, 80, 96, 128, 256):
        for nq, nkv in ((32, 32), (71, 1), (128, 8), (28, 4), (1, 1)):
            assert tpa.unsupported_shape(nq, nkv, d) == []
    assert tpa.unsupported_shape(8, 8, 32) == ["head_dim 32 (the kernels are built for "
                                               "(64, 80, 96, 128, 256))"]
    assert tpa.unsupported_shape(16, 3, 128) == ["16 query heads over 3 kv heads "
                                                 "(not a multiple)"]


@pytest.mark.parametrize("g", GROUPS)
def test_host_plans_cover_the_group(g):
    """The decode's head tiles: ceil(g / 8), the last holding 1-8 heads (one
    tile for g <= 8). The prefill's default tile: 64 // g tokens up to g 64
    (one full-enough chunk of 64 rows), 8 tokens above; its rows in chunks
    of 64, every chunk but the last full and the last's padding under a
    ninth of the rows."""
    tiles = tpa.decode_head_tiles(g)
    assert 1 <= g - 8 * (tiles - 1) <= 8
    assert (tiles == 1) == (g <= 8)
    qt = tpa.prefill_q_tile(g)
    rows, chunks = qt * g, tpa.prefill_row_chunks(g, qt)
    assert 0 < rows - 64 * (chunks - 1) <= 64
    if g <= 64:
        assert qt == 64 // g and chunks == 1
    else:
        assert qt == 8 and (64 * chunks - rows) * 9 < 64 * chunks
    assert tpa.prefill_row_chunks(g, 1) == -(-g // 64)


@pytest.mark.parametrize("g", GROUPS)
def test_grid_index_arithmetic_covers_every_row_once(g):
    """The kernels' grid arithmetic, emulated: the decode's blockIdx.x =
    (token x nkv + kv head) x tiles + head tile, with rows row0 = token nq +
    kv head g + 8 tile and min(8, g - 8 tile) heads; the prefill's chunk c
    of a tile of n tokens, rows c 64 .. min(n g, 64 (c + 1)) - 1, row r
    token r // g and head kv head g + r % g. Each (token, query head) is
    written by exactly one CTA of each."""
    nkv, T = 2, 11
    nq = g * nkv
    n_ht = tpa.decode_head_tiles(g)
    seen = np.zeros((T, nq), int)
    for x in range(T * nkv * n_ht):
        ht, kvt = x % n_ht, x // n_ht
        kvh, tok = kvt % nkv, kvt // nkv
        head0, gt = kvh * g + 8 * ht, min(8, g - 8 * ht)
        seen[tok, head0:head0 + gt] += 1
    assert (seen == 1).all()
    for q_tile in (tpa.prefill_q_tile(g), 3):
        seen[:] = 0
        starts = list(range(0, T, q_tile))
        chunks = tpa.prefill_row_chunks(g, q_tile)
        for tok0 in starts:
            n = min(q_tile, T - tok0)
            for kvh in range(nkv):
                for c in range(chunks):
                    for r in range(64):
                        tr = 64 * c + r
                        if tr < n * g:
                            seen[tok0 + tr // g, kvh * g + tr % g] += 1
        assert (seen == 1).all(), q_tile


def _engines(family, **over):
    """The JAX engine (plain attention) and the port's engine through the
    CUDA attention module (its plain versions on the CPU) on shared fp32
    weights of one layer."""
    jcfg = getattr(jax_models, f"{family}_config")("tiny", dtype=jnp.float32,
                                                    attention_impl="reference", **over)
    jmodel = jax_models.TransformerLM(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(3))
    sm = dict(max_tracked_sequences=4, max_ragged_batch_size=96, max_ragged_sequence_count=4,
              max_context=96)
    jeng = JaxEngine(jmodel, JaxConfig(kv_block_size=16, num_kv_blocks=24,
                                       state_manager=JaxSMConfig(**sm),
                                       use_pallas_kernels="never"), params=jparams)
    tcfg = getattr(models, f"{family}_config")("tiny", dtype=torch.float32, **over)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    teng = InferenceEngineV2(models.TransformerLM(tcfg, tparams, device="cpu"),
                             RaggedInferenceEngineConfig(
                                 kv_block_size=16, num_kv_blocks=24,
                                 state_manager=DSStateManagerConfig(**sm),
                                 modules=ModulesConfig(attention="paged_cuda_attention")),
                             device="cpu")
    return jeng, teng


@pytest.mark.parametrize("family,over", [
    ("phi", dict(hidden_size=160, num_heads=2, num_layers=1, intermediate_size=64,
                 vocab_size=128)),  # phi-2's head_dim 80
    ("falcon", dict(hidden_size=71 * 64, num_heads=71, num_kv_heads=1, num_layers=1,
                    intermediate_size=64, vocab_size=128)),  # Falcon-7B's 71 heads over 1
])
def test_engine_on_the_cuda_module_matches_jax_at_the_new_shapes(family, over):
    """One put of two prompts (a prefill-shaped batch: the q-tiled route),
    then a decode step of both (the per-token route) through the CUDA
    attention module, against the JAX engine: logits within 2e-4."""
    jeng, teng = _engines(family, **over)
    assert teng._modules["attention"].name() == "paged_cuda_attention"
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 128, size=n).astype(np.int32) for n in (50, 30)]
    for eng_out in zip(*[(np.asarray(eng.put([1, 2], prompts)),
                          np.asarray(eng.put([1, 2], [[7], [9]]))) for eng in (jeng, teng)]):
        np.testing.assert_allclose(eng_out[1], eng_out[0], rtol=2e-4, atol=2e-4)

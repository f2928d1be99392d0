"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which must pass (exit code 1 otherwise):

1. build: compile the hand-written CUDA kernels of
   ``deepspeed_tpu_torch/ops/csrc`` with nvcc for sm_90a, print nvcc's wall
   time and the ``-Xptxas -v`` registers / shared memory / spills per kernel.
2. kernels: hold every kernel path (``paged_decode`` with kv_splits 1 and 8,
   ``paged_prefill``) against the plain PyTorch version on the card, bf16
   and int8 pools, GQA 32/8, head_dim 128, block 64, plus window / ALiBi /
   head_dim 64 cases at small sizes. Tolerance, per output element:
   |kernel - plain| <= 2 ulp(plain) + 2^-14, with ulp the spacing of
   bfloat16 numbers at |plain|. Both compute in fp32 throughout (the kernel
   on CUDA cores, the plain version in fp32 einsums; no bf16 intermediate)
   and round once to bf16 at the end, so their fp32 results differ only by
   summation order, about 1e-6 of the terms' size. Values that close round
   to bf16 numbers at most one ulp apart (two where a power of two lies
   between them); the 2^-14 floor covers the summation-order difference
   where an output is near zero and its ulp is smaller than that. At the
   main path's shapes (decode of 32 sequences x 1024 context, a 512-token
   prefill chunk) time the kernel (CUDA events over many warmed launches),
   the plain version, and ``F.scaled_dot_product_attention`` on the same
   context pre-gathered contiguous (a yardstick only: it excludes the
   gather), beside the least time the card could take (bytes / 3.35 TB/s or
   FLOPs / 989 TFLOP/s, whichever is larger).
3. e2e: Mistral-7B at full width and depth (32 layers), random weights from
   a seeded generator, served through ``DynamicSplitFuseScheduler`` over
   ``InferenceEngineV2``: requests chosen so that every kernel path runs,
   with launch counts reset just before and read just after; then one
   prefill's last-token logits through the kernels against the same
   forward through ``dense_blocked_attention`` (relative L2 error).

It prints the card (name and power limit) and, on the line before the last,
``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
It exits non-zero, printing no result, without a CUDA card or without the
rest of the repository beside it.
"""

import json
import os
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
BF16_FLOPS_PER_S = 989e12  # dense bf16 tensor-core peak, NVIDIA data sheet
TOL_ULPS, TOL_FLOOR = 2, 2.0**-14
LOGITS_REL_L2_TOL = 5e-2
SOURCE = "deepspeed_tpu_torch/ops/csrc/paged_attention.cu"
TPU_SRC = "deepspeed_tpu/ops/pallas/paged_attention.py"
KERNELS = {  # name -> (TPU kernel it replaces)
    "paged_decode": f"{TPU_SRC}:258",
    "paged_decode_split": f"{TPU_SRC}:550",
    "paged_prefill": f"{TPU_SRC}:394",
}


def log(msg):
    print(msg, flush=True)


def time_ms(fn, iters=50, warmup=5):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / iters


def bound_ms(n_bytes, flops):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# phase 1: build
# ---------------------------------------------------------------------------

def phase_build():
    from deepspeed_tpu_torch.ops import paged_attention as pa

    t0 = time.perf_counter()
    built = pa.kernel_build()
    log(f"[build] kernels ready in {time.perf_counter() - t0:.2f}s")
    log(f"[build] paged_attention: nvcc {built.seconds:.2f}s -> "
        f"{os.path.relpath(built.path, HERE)}")
    name = None
    for line in built.ptxas.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "Used" in line and "registers" in line and name:
            log(f"[build]   {name}: {line.split(':', 1)[1].strip()}")
        elif "spill" in line and name:
            log(f"[build]   {name}: {line.strip()}")
    smem = built.lib.ds_paged_smem_bytes
    log(f"[build] dynamic shared memory per CTA at the main path's shapes (d 128, block 64): "
        f"decode (rows = g = 4) {smem(4, 128, 64)} B, prefill (rows = q_tile 8 x g 4) "
        f"{smem(32, 128, 64)} B")


# ---------------------------------------------------------------------------
# phase 2: kernels against the plain version
# ---------------------------------------------------------------------------

def _make_case(seed, nkv, g, d, bs, tables, seq_idx, pos, int8):
    """Pools with one trailing scratch slot (as the engine's), random
    values from a seeded generator; int8 pools quantized per (slot, head)
    like the engine's append."""
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    n_slots = (int(tables.max()) + 1) * bs + 1
    kf = torch.randn(n_slots, nkv, d, generator=gen, device=dev)
    vf = torch.randn(n_slots, nkv, d, generator=gen, device=dev)
    q = torch.randn(seq_idx.numel(), nkv * g, d, generator=gen, device=dev).to(torch.bfloat16)
    kw = {}
    if int8:
        ks = (kf.abs().amax(-1) / 127).clamp_min(1e-8)
        vs = (vf.abs().amax(-1) / 127).clamp_min(1e-8)
        k = torch.round(kf / ks[..., None]).to(torch.int8)
        v = torch.round(vf / vs[..., None]).to(torch.int8)
        kw = dict(k_scale=ks.t().contiguous(), v_scale=vs.t().contiguous())
    else:
        k, v = kf.to(torch.bfloat16), vf.to(torch.bfloat16)
    return q, k, v, tables.to(dev), seq_idx.to(dev), pos.to(dev), kw


def bf16_ulp(x):
    """Spacing of bfloat16 numbers (8 significant bits) at |x|."""
    import torch

    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(2.0**-126))) - 7)


def _err(out, ref):
    """(max |out - ref|, the largest error as a fraction of its element's
    tolerance); the check passes when the fraction is at most 1."""
    ref = ref.float()
    err = (out.float() - ref).abs()
    return float(err.max()), float((err / (TOL_ULPS * bf16_ulp(ref) + TOL_FLOOR)).max())


def phase_kernels():
    """Returns {kernel name: measurement dict} at the main-path shapes with
    bf16 pools, each holding the int8 pools' measurements under "int8"."""
    import torch
    import torch.nn.functional as F

    from deepspeed_tpu_torch.ops import paged_attention as pa

    failures = []
    worst = {k: 0.0 for k in KERNELS}
    worst_frac = [0.0]

    def check(tag, out, ref):
        e, frac = _err(out, ref)
        worst_frac[0] = max(worst_frac[0], frac)
        if not frac <= 1.0:
            failures.append(f"{tag}: max_abs_err {e:.3e}, {frac:.2f}x its tolerance")
        return e

    def run_paths(tag, q, k, v, tb, si, po, bs, kw, splits):
        ref = pa.paged_attention_reference(q, k, v, tb, si, po, bs, **kw)
        outs = {"paged_decode": pa.paged_decode(q, k, v, tb, si, po, bs, kv_splits=1, **kw),
                "paged_decode_split": pa.paged_decode(q, k, v, tb, si, po, bs, kv_splits=splits,
                                                      **kw),
                "paged_prefill": pa.paged_prefill(q, k, v, tb, si, po, bs, q_tile=8, **kw)}
        torch.cuda.synchronize()
        for name, out in outs.items():
            worst[name] = max(worst[name], check(f"{name} {tag}", out, ref))
        return ref

    # small sizes: a mixed prefill + decode batch with the pad run, at both
    # head dims, bf16 and int8, plain / window / ALiBi / window x ALiBi
    g_small = torch.Generator().manual_seed(0)
    for d in (128, 64):
        for int8 in (False, True):
            for window, alibi in ((None, False), (17, False), (None, True), (17, True)):
                nkv, g, bs = 2, 4, 16
                tables = torch.randperm(12, generator=g_small).to(torch.int32).reshape(3, 4)
                seq = torch.tensor([0] * 13 + [1] * 6 + [2] + [0] * 3, dtype=torch.int32)
                pos = torch.tensor(list(range(20, 33)) + list(range(16, 22)) + [53, 0, 0, 0],
                                   dtype=torch.int32)
                q, k, v, tb, si, po, kw = _make_case(d + int8, nkv, g, d, bs, tables, seq, pos,
                                                     int8)
                if window:
                    kw["window"] = window
                if alibi:
                    kw["alibi"] = torch.tensor([2.0**-(i + 1) for i in range(nkv * g)],
                                               device="cuda")
                run_paths(f"d={d} int8={int8} window={window} alibi={alibi}", q, k, v, tb, si,
                          po, bs, kw, splits=3)
    log(f"[kernels] small-size matrix (32 cases x 3 paths): "
        f"{'all within tolerance' if not failures else failures}; max_abs_err {worst}")

    # main-path shapes: Mistral-7B attention (GQA 32/8, d 128), block 64,
    # tables of 32 blocks (max_context 2048), sliding window 4096
    nkv, g, d, bs, mb, S, ctx, T_pre = 8, 4, 128, 64, 32, 32, 1024, 512
    nq = nkv * g
    tables = torch.randperm(S * mb, generator=g_small).to(torch.int32).reshape(S, mb)
    res = {}
    for int8 in (False, True):
        kvb = 1 if int8 else 2
        scale_b = 8 if int8 else 0  # k and v fp32 scale per (slot, head)
        # decode: 32 sequences, one token each at position 1023
        q, k, v, tb, si, po, kw = _make_case(7 + int8, nkv, g, d, bs, tables,
                                             torch.arange(S, dtype=torch.int32),
                                             torch.full((S, ), ctx - 1, dtype=torch.int32), int8)
        kw["window"] = 4096
        ref = pa.paged_attention_reference(q, k, v, tb, si, po, bs, **kw)
        splits = pa.resolve_kv_splits(S, S, mb)
        meas = {}
        for name, ks in (("paged_decode", 1), ("paged_decode_split", splits)):
            fn = lambda ks=ks: pa.paged_decode(q, k, v, tb, si, po, bs, kv_splits=ks, **kw)
            e = check(f"{name} main int8={int8}", fn(), ref)
            meas[name] = dict(err=e, ms=time_ms(fn))
        plain = time_ms(lambda: pa.paged_attention_reference(q, k, v, tb, si, po, bs, **kw),
                        iters=10, warmup=2)
        n_bytes = (S * nq * d * 2 * 2 + S * ctx * nkv * (2 * d * kvb + scale_b)
                   + tb.numel() * 4 + 2 * S * 4)
        flops = 4 * nq * d * S * ctx
        b_ms, b_by = bound_ms(n_bytes, flops)
        lib_ms = None
        if not int8:
            slots = (tb.long()[:, :ctx // bs, None] * bs
                     + torch.arange(bs, device="cuda")).reshape(S, ctx)
            kc = k[slots].permute(0, 2, 1, 3).contiguous()  # [S, nkv, ctx, d]
            vc = v[slots].permute(0, 2, 1, 3).contiguous()
            qc = q[:, :, None, :]  # [S, nq, 1, d]
            lib_ms = time_ms(lambda: F.scaled_dot_product_attention(qc, kc, vc, enable_gqa=True))
        for name, m in meas.items():
            res[(name, int8)] = dict(m, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                                     library_ms=lib_ms)
        log(f"[kernels] decode S={S} ctx={ctx} int8={int8} splits={splits}: "
            f"paged_decode {meas['paged_decode']['ms']:.4f} ms, paged_decode_split "
            f"{meas['paged_decode_split']['ms']:.4f} ms, plain {plain:.4f} ms, bound {b_ms:.4f} "
            f"ms ({b_by}), sdpa on gathered context {lib_ms} ms, max_abs_err "
            f"{meas['paged_decode']['err']:.3e} / {meas['paged_decode_split']['err']:.3e}")

        # prefill: one 512-token chunk of one sequence from position 0
        q, k, v, tb, si, po, kw = _make_case(11 + int8, nkv, g, d, bs, tables[:1],
                                             torch.zeros(T_pre, dtype=torch.int32),
                                             torch.arange(T_pre, dtype=torch.int32), int8)
        kw["window"] = 4096
        ref = pa.paged_attention_reference(q, k, v, tb, si, po, bs, **kw)
        fn = lambda: pa.paged_prefill(q, k, v, tb, si, po, bs, q_tile=8, **kw)
        e = check(f"paged_prefill main int8={int8}", fn(), ref)
        ms = time_ms(fn)
        plain = time_ms(lambda: pa.paged_attention_reference(q, k, v, tb, si, po, bs, **kw),
                        iters=10, warmup=2)
        n_bytes = 2 * T_pre * nq * d * 2 + T_pre * nkv * (2 * d * kvb + scale_b) + 2 * T_pre * 4
        flops = 4 * nq * d * (T_pre * (T_pre + 1) // 2)
        b_ms, b_by = bound_ms(n_bytes, flops)
        lib_ms = None
        if not int8:
            slots = (tb.long()[0, :T_pre // bs, None] * bs
                     + torch.arange(bs, device="cuda")).reshape(T_pre)
            kc = k[slots].permute(1, 0, 2)[None].contiguous()  # [1, nkv, T, d]
            vc = v[slots].permute(1, 0, 2)[None].contiguous()
            qc = q.permute(1, 0, 2)[None].contiguous()  # [1, nq, T, d]
            lib_ms = time_ms(lambda: F.scaled_dot_product_attention(qc, kc, vc, is_causal=True,
                                                                    enable_gqa=True))
        res[("paged_prefill", int8)] = dict(err=e, ms=ms, plain_ms=plain, bound_ms=b_ms,
                                            bound_by=b_by, library_ms=lib_ms)
        log(f"[kernels] prefill T={T_pre} int8={int8}: paged_prefill {ms:.4f} ms, plain "
            f"{plain:.4f} ms, bound {b_ms:.4f} ms ({b_by}), sdpa on gathered context "
            f"{lib_ms} ms, max_abs_err {e:.3e}")
    log(f"[kernels] largest error over all cases: {worst_frac[0]:.3f} of its tolerance "
        f"({TOL_ULPS} bf16 ulp + 2^-14)")
    if failures:
        raise RuntimeError("kernels disagree with the plain version: " + "; ".join(failures))
    for name in KERNELS:
        res[(name, False)]["int8"] = res[(name, True)]
        res[(name, False)]["err"] = max(res[(name, False)]["err"], res[(name, True)]["err"],
                                        worst[name])
    return {name: res[(name, False)] for name in KERNELS}


# ---------------------------------------------------------------------------
# phase 3: Mistral-7B served end to end
# ---------------------------------------------------------------------------

def phase_e2e():
    import numpy as np
    import torch

    from deepspeed_tpu_torch.inference.v2 import (DSStateManagerConfig,
                                                  DynamicSplitFuseScheduler, InferenceEngineV2,
                                                  ModulesConfig, RaggedInferenceEngineConfig,
                                                  build_model_engine)
    from deepspeed_tpu_torch.ops import paged_attention as pa

    t0 = time.perf_counter()
    cfg = RaggedInferenceEngineConfig(kv_block_size=64,
                                      state_manager=DSStateManagerConfig(max_context=2048))
    engine = build_model_engine("mistral", "7b", cfg, seed=0)
    torch.cuda.synchronize()
    mc = engine.model_config
    n_params = engine.module.num_params()
    kv = engine.state_manager.kv_cache
    log(f"[e2e] Mistral-7B: {mc.num_layers} layers, hidden {mc.hidden_size}, heads "
        f"{mc.num_heads}/{mc.num_kv_heads}, {n_params / 1e9:.3f}B params, KV pool "
        f"{engine.num_kv_blocks} x {cfg.kv_block_size} slots ({kv.memory_bytes() / 2**30:.1f} GiB, "
        f"{kv.k_flat.numel():,} elements per pool), built in {time.perf_counter() - t0:.1f}s")
    if kv.k_flat.numel() <= 2**31:
        log("[e2e] note: the pool is below 2^31 elements; 64-bit offsets not exercised")

    rng = np.random.default_rng(0)
    vocab = mc.vocab_size
    # A: a short prompt admitted alone (per-token grid), then its decode
    #    horizons (split-K grid: 32-block tables). B: a 512-token prompt and
    #    three more in one SplitFuse batch (q-tiled grid), then decode.
    wave_a = {0: (rng.integers(0, vocab, 20), 24)}
    wave_b = {1: (rng.integers(0, vocab, 512), 32), 2: (rng.integers(0, vocab, 128), 32),
              3: (rng.integers(0, vocab, 100), 16), 4: (rng.integers(0, vocab, 200), 24)}
    sched = DynamicSplitFuseScheduler(engine)
    ttft, submitted = {}, {}
    decode_tokens, decode_s = 0, 0.0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pa.reset_launch_counts()
    t_start = time.perf_counter()
    for wave in (wave_a, wave_b):
        for uid, (prompt, n_new) in wave.items():
            sched.submit(uid, prompt.astype(np.int32), max_new_tokens=n_new)
            submitted[uid] = time.perf_counter()
        while sched.has_work:
            fed = sched.stats["prefill_tokens_fed"]
            before = sum(len(v) for v in sched.results.values())
            ts = time.perf_counter()
            if sched.step() == 0:
                raise RuntimeError("scheduler stalled")
            now = time.perf_counter()
            res = sched.results
            if sched.stats["prefill_tokens_fed"] == fed:  # a decode-only step
                decode_s += now - ts
                decode_tokens += sum(len(v) for v in res.values()) - before
            for uid, toks in res.items():
                if toks and uid not in ttft:
                    ttft[uid] = now - submitted[uid]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    launches = dict(pa.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    results = sched.results
    expected = {u: n for w in (wave_a, wave_b) for u, (_, n) in w.items()}
    for uid, n in expected.items():
        toks = results.get(uid)
        if toks is None or len(toks) != n or not all(0 <= t < vocab for t in toks):
            raise RuntimeError(f"request {uid}: bad generation {toks}")
    n_tok = sum(len(v) for v in results.values())
    log(f"[e2e] served {len(results)} requests, {n_tok} tokens generated in {wall:.2f}s; "
        f"TTFT p50 {1e3 * float(np.median(list(ttft.values()))):.1f} ms "
        f"(per request ms: { {u: round(1e3 * t, 1) for u, t in sorted(ttft.items())} }); "
        f"decode {decode_tokens / max(decode_s, 1e-9):.1f} tok/s over {decode_tokens} tokens; "
        f"peak memory {peak / 2**30:.2f} GiB")
    log(f"[e2e] kernel launches on the main path: {launches}")
    missing = [k for k, n in launches.items() if n <= 0]
    if missing:
        raise RuntimeError(f"kernel paths never launched on the main path: {missing}")

    # one prefill's last-token logits: kernels vs the plain attention,
    # asked for explicitly on a second engine sharing the same weights
    prompt = wave_b[1][0].astype(np.int32)
    logits_k = engine.put([100], [prompt])
    engine.flush(100)
    dense_cfg = RaggedInferenceEngineConfig(
        kv_block_size=64, num_kv_blocks=40, state_manager=DSStateManagerConfig(max_context=2048),
        modules=ModulesConfig(attention="dense_blocked_attention"))
    dense = InferenceEngineV2(engine.module, dense_cfg, params=engine.params)
    logits_d = dense.put([100], [prompt])
    if logits_k.shape != (1, vocab) or not np.isfinite(logits_k).all():
        raise RuntimeError(f"bad logits: shape {logits_k.shape}")
    rel = float(np.linalg.norm(logits_k - logits_d) / np.linalg.norm(logits_d))
    same_top = int(np.argmax(logits_k)) == int(np.argmax(logits_d))
    log(f"[e2e] 512-token prefill logits, kernels vs dense_blocked_attention: rel L2 {rel:.3e} "
        f"(tolerance {LOGITS_REL_L2_TOL}: bf16 activations round differently after attention "
        f"outputs that differ in the last bf16 bit, through 32 layers); same argmax: {same_top}")
    if not rel <= LOGITS_REL_L2_TOL:
        raise RuntimeError(f"logits disagree: rel L2 {rel:.3e} > {LOGITS_REL_L2_TOL}")
    del dense
    profile_decode(engine, rng)
    return launches


def profile_decode(engine, rng, n_seqs=8, steps=4, repeats=5):
    """Where a decode step's time goes: torch.profiler over one warmed
    ``decode`` horizon of ``n_seqs`` sequences, kernel time summed from the
    device activity records, against the host's wall clock (the median of
    ``repeats`` unprofiled horizons: the host's clock varies from horizon to
    horizon on a machine whose CPU cores are shared)."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    uids = list(range(200, 200 + n_seqs))
    prompts = [rng.integers(0, engine.model_config.vocab_size, 90).astype(np.int32)
               for _ in uids]
    first = engine.put(uids, prompts, sample="greedy")
    toks = engine.decode(uids, [[t] for t in first], 2)  # warm
    torch.cuda.synchronize()
    walls = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        toks = engine.decode(uids, [[t] for t in toks[:, -1]], steps)
        walls.append(time.perf_counter() - t0)
    wall_plain = float(np.median(walls))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.decode(uids, [[t] for t in toks[:, -1]], steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    for u in uids:
        engine.flush(u)
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy = sum(by_name.values()) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    log(f"[e2e] decode profile, {n_seqs} sequences x {steps} steps: wall {1e3 * wall_plain / steps:.2f} "
        f"ms/step unprofiled (median of {repeats} horizons; range "
        f"{1e3 * min(walls) / steps:.2f}-{1e3 * max(walls) / steps:.2f}), "
        f"{1e3 * wall / steps:.2f} ms/step profiled; device busy "
        f"{1e3 * busy / steps:.2f} ms/step: device idle {100 * (1 - busy / wall_plain):.1f}% of "
        f"the unprofiled wall, {100 * (1 - busy / wall):.1f}% of the profiled one")
    for name, us in top:
        log(f"[e2e]   {us / steps / 1e3:8.3f} ms/step  {name[:90]}")


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs a CUDA card",
              file=sys.stderr)
        return 2
    try:
        import deepspeed_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the deepspeed_tpu_torch package is not beside this script ({e})",
              file=sys.stderr)
        return 2
    t_all = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    log(f"[device] {kind}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.device_count()} visible")
    failed = []
    measured, launches = {}, {}
    for name, fn in (("build", phase_build), ("kernels", phase_kernels), ("e2e", phase_e2e)):
        t0 = time.perf_counter()
        try:
            out = fn()
            if name == "kernels":
                measured = out
            elif name == "e2e":
                launches = out
            log(f"[{name}] ok in {time.perf_counter() - t0:.1f}s")
        except Exception:  # noqa: BLE001 -- report every phase, fail at the end
            failed.append(name)
            log(f"[{name}] FAILED after {time.perf_counter() - t0:.1f}s")
            traceback.print_exc(file=sys.stdout)
            if name == "build":
                break
    log(f"[done] {time.perf_counter() - t_all:.1f}s total; failed phases: {failed or 'none'}")
    if failed:
        return 1
    kernels = [{"name": name, "route": "cuda", "source": SOURCE, "replaces": KERNELS[name],
                "launches": int(launches[name]), "max_abs_err": m["err"], "ms": m["ms"],
                "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
                "library_ms": m["library_ms"],
                "int8": {k: m["int8"][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}
                | {"max_abs_err": m["int8"]["err"]}} for name, m in measured.items()]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

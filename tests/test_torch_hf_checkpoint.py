"""PyTorch port: the HuggingFace checkpoint loader against the JAX package's
and against HF itself, on the CPU.

Tiny random HF models of every supported family (the eleven of
``tests/test_hf_checkpoint.py``, Falcon's 7b and 40b decoder architectures
apart) are built locally with the installed ``transformers`` (no download)
and saved as ``.safetensors``. For each: the port's fp32 converter output
equals ``deepspeed_tpu``'s ``convert_hf_state_dict`` exactly; the port's
``build_hf_engine(..., device="cpu")`` put logits are within 2e-3 of HF's
and of the JAX engine's; and greedy streams through both v2 engines are
identical. The port's own ``.safetensors`` reader is held against the
``safetensors`` package.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from deepspeed_tpu.inference.v2.checkpoint import build_hf_engine as jax_build_hf_engine  # noqa: E402
from deepspeed_tpu.inference.v2.checkpoint.huggingface_engine import (  # noqa: E402
    convert_hf_state_dict as jax_convert, transformer_config_from_hf as jax_config_from_hf)
from deepspeed_tpu_torch.inference.v2 import build_hf_engine  # noqa: E402
from deepspeed_tpu_torch.inference.v2.checkpoint.huggingface_engine import (  # noqa: E402
    HuggingFaceCheckpointEngine, SafetensorsFile, convert_hf_state_dict,
    transformer_config_from_hf)

KINDS = ["llama", "mistral", "gpt2", "opt", "bloom", "gptj", "gpt_neox", "falcon", "falcon40b",
         "qwen2", "phi"]
VOCAB = 128
TOL = 2e-3


def _hf_model(kind):
    """The tiny HF model of ``tests/test_hf_checkpoint.py`` for ``kind``."""
    T = transformers
    small = dict(vocab_size=VOCAB, hidden_size=64, num_hidden_layers=2, num_attention_heads=4)
    llama_like = dict(small, intermediate_size=128, max_position_embeddings=128,
                      tie_word_embeddings=False)
    if kind in ("llama", "mistral", "qwen2"):
        cls = {"llama": (T.LlamaConfig, T.LlamaForCausalLM),
               "mistral": (T.MistralConfig, T.MistralForCausalLM),
               "qwen2": (T.Qwen2Config, T.Qwen2ForCausalLM)}[kind]
        cfg, model = cls[0](num_key_value_heads=2, **llama_like), cls[1]
    elif kind == "gpt2":
        cfg = T.GPT2Config(vocab_size=VOCAB, n_embd=64, n_layer=2, n_head=4, n_positions=128)
        model = T.GPT2LMHeadModel
    elif kind == "opt":
        cfg = T.OPTConfig(ffn_dim=128, max_position_embeddings=128, word_embed_proj_dim=64,
                          do_layer_norm_before=True, **small)
        model = T.OPTForCausalLM
    elif kind == "bloom":
        cfg, model = T.BloomConfig(vocab_size=VOCAB, hidden_size=64, n_layer=2, n_head=4), \
            T.BloomForCausalLM
    elif kind == "gptj":
        cfg = T.GPTJConfig(vocab_size=VOCAB, n_embd=64, n_layer=2, n_head=4, rotary_dim=8,
                           n_positions=128)
        model = T.GPTJForCausalLM
    elif kind == "gpt_neox":
        cfg = T.GPTNeoXConfig(intermediate_size=128, rotary_pct=0.25, max_position_embeddings=128,
                              use_parallel_residual=True, tie_word_embeddings=False, **small)
        model = T.GPTNeoXForCausalLM
    elif kind in ("falcon", "falcon40b"):
        new = kind == "falcon40b"  # the 40b / 180b decoder: GQA kv heads + ln_attn / ln_mlp
        cfg = T.FalconConfig(multi_query=True, parallel_attn=True, new_decoder_architecture=new,
                             bias=False, alibi=False, **(dict(num_kv_heads=2) if new else {}),
                             **small)
        model = T.FalconForCausalLM
    elif kind == "phi":
        cfg = T.PhiConfig(partial_rotary_factor=0.5, **llama_like)
        model = T.PhiForCausalLM
    torch.manual_seed(0)
    return model(cfg).eval()


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """kind -> (HF model, its checkpoint directory), built once a module."""
    root = tmp_path_factory.mktemp("hf")
    cache = {}

    def get(kind):
        if kind not in cache:
            model = _hf_model(kind)
            path = str(root / kind)
            model.save_pretrained(path)
            cache[kind] = (model, path)
        return cache[kind]

    return get


def _hf_config(path):
    with open(os.path.join(path, "config.json")) as f:
        return json.load(f)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_fp32_converter_equals_the_reference_exactly(saved, kind):
    """Every leaf of the port's fp32 conversion equals the JAX package's,
    bit for bit (the transforms are transposes, splits and permutations),
    read through the port's reader on one side and HF's state dict on the
    other; each leaf sits where the port's own initialiser puts it, in its
    shape, and norms and biases are fp32."""
    from deepspeed_tpu_torch.models.transformer import init_params

    _, path = saved(kind)
    hf_cfg = _hf_config(path)
    jcfg, jmt = jax_config_from_hf(hf_cfg)
    cfg, mt = transformer_config_from_hf(hf_cfg)
    assert mt == jmt
    sd = HuggingFaceCheckpointEngine(path).state_dict()
    ref = _flat(jax_convert({k: sd[k].numpy() for k in sd}, jcfg, jmt))
    got = _flat(convert_hf_state_dict(sd, cfg, mt, dtype=torch.float32, device="cpu"))
    assert sorted(got) == sorted(ref)
    for name, want in ref.items():
        assert got[name].dtype == torch.float32
        np.testing.assert_array_equal(got[name].numpy(), want, err_msg=name)
    like = _flat(init_params(cfg, None, "cpu", torch.float32))
    assert set(got) - set(like) <= {"lm_head.bias"}  # the initialiser draws no head bias
    assert {k: tuple(got[k].shape) for k in like} == {k: tuple(v.shape) for k, v in like.items()}
    bf16 = _flat(convert_hf_state_dict(sd, cfg, mt, dtype=torch.bfloat16, device="cpu"))
    assert {k for k, v in bf16.items() if v.dtype == torch.bfloat16} == {
        k for k in bf16 if k.split(".")[1] in ("wq", "wk", "wv", "wo", "w_up", "w_down",
                                                "w_gate", "embedding", "kernel")}


@pytest.mark.parametrize("kind", KINDS)
def test_engine_matches_hf_and_the_jax_engine(saved, kind):
    """``build_hf_engine(path, dtype=float32, device="cpu")``: one put of
    two prompts, each last-token row within 2e-3 of HF's forward and of the
    JAX ``build_hf_engine``'s; then a greedy decode horizon from the rows'
    argmax gives the JAX engine's token streams exactly (ROADMAP A5's parity
    bar)."""
    hf_model, path = saved(kind)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, VOCAB, size=n).astype(np.int32) for n in (12, 5)]
    with torch.no_grad():
        ref = np.stack([hf_model(torch.from_numpy(p.astype(np.int64))[None]).logits[0, -1]
                        .float().numpy() for p in prompts])
    teng = build_hf_engine(path, dtype=torch.float32, device="cpu")
    jeng = jax_build_hf_engine(path, dtype=jnp.float32)
    streams = []
    for eng in (teng, jeng):
        logits = np.asarray(eng.put([1, 2], prompts))
        assert logits.shape == (2, VOCAB)
        np.testing.assert_allclose(logits, ref, rtol=TOL, atol=TOL)
        first = logits.argmax(-1)
        toks = np.asarray(eng.decode([1, 2], [[int(t)] for t in first], 6))
        streams.append((logits, np.concatenate([first[:, None], toks], axis=1)))
    (tl, ts), (jl, js) = streams
    np.testing.assert_allclose(tl, jl, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(ts, js)


@pytest.mark.parametrize("kind", ["llama", "bloom", "gptj"])
def test_decode_continues_to_match_hf(saved, kind):
    """After a prefill, three single-token puts keep matching HF's forward
    over the whole sequence (rotary, ALiBi, the interleaved rotary)."""
    hf_model, path = saved(kind)
    prompt = np.random.default_rng(1).integers(0, VOCAB, size=10)
    engine = build_hf_engine(path, dtype=torch.float32, device="cpu")
    logits = np.asarray(engine.put([1], [prompt.astype(np.int32)]))
    toks = list(prompt)
    for _ in range(3):
        nxt = int(np.argmax(logits[0]))
        toks.append(nxt)
        logits = np.asarray(engine.put([1], [np.asarray([nxt], np.int32)]))
    with torch.no_grad():
        full = hf_model(torch.tensor(toks)[None]).logits[0, -1].float().numpy()
    np.testing.assert_allclose(logits[0], full, rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# the .safetensors reader
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
def test_safetensors_reader_equals_the_package(tmp_path, dtype):
    """The port's reader gives what ``safetensors`` reads, bit for bit,
    for each dtype it decodes (shapes 2-d, 1-d, 0-d and empty)."""
    st = pytest.importorskip("safetensors.torch")
    gen = torch.Generator().manual_seed(3)
    tensors = {"a.weight": torch.randn(7, 5, generator=gen).to(dtype),
               "b.bias": torch.randn(11, generator=gen).to(dtype),
               "scalar": torch.randn((), generator=gen).to(dtype),
               "empty": torch.empty(0, 4, dtype=dtype)}
    path = str(tmp_path / "m.safetensors")
    st.save_file(tensors, path, metadata={"format": "pt"})
    want = st.load_file(path)
    f = SafetensorsFile(path)
    assert sorted(f.keys()) == sorted(want)
    for name, w in want.items():
        got = f.get(name)
        assert got.dtype == dtype and got.shape == w.shape, name
        assert torch.equal(got.view(-1).view(torch.uint8) if got.numel() else got,
                           w.view(-1).view(torch.uint8) if w.numel() else w), name


def test_sharded_directory_and_unknown_dtype(tmp_path):
    """A checkpoint saved in several shards reads as the union of what
    ``safetensors`` reads from each; a tensor of a dtype the reader does not
    decode raises when read, naming the dtype."""
    st = pytest.importorskip("safetensors.torch")
    model = _hf_model("llama").to(torch.bfloat16)
    path = tmp_path / "sharded"
    model.save_pretrained(str(path), max_shard_size="40KB")
    shards = sorted(p for p in os.listdir(path) if p.endswith(".safetensors"))
    assert len(shards) > 1
    want = {}
    for s in shards:
        want.update(st.load_file(str(path / s)))
    sd = HuggingFaceCheckpointEngine(str(path)).state_dict()
    assert sorted(sd) == sorted(want)
    for name, w in want.items():
        assert sd[name].dtype == torch.bfloat16 and torch.equal(sd[name], w), name
    odd = str(tmp_path / "odd.safetensors")
    st.save_file({"ids": torch.arange(4), "w": torch.ones(2)}, odd)
    f = SafetensorsFile(odd)
    assert torch.equal(f.get("w"), torch.ones(2))
    with pytest.raises(ValueError, match="I64"):
        f.get("ids")


@pytest.mark.parametrize("fault", ["header_past_end", "offsets_not_shape", "data_past_end"])
def test_malformed_safetensors_raises_naming_it(tmp_path, fault):
    """A truncated or inconsistent file raises a ValueError naming the file
    (and the tensor, once the header has parsed), not a reshape error or a
    huge allocation."""
    import struct

    entry = {"dtype": "F32", "shape": [2, 3], "data_offsets": [0, 24]}
    data = bytes(24)
    if fault == "offsets_not_shape":
        entry["data_offsets"] = [0, 20]
    elif fault == "data_past_end":
        data = bytes(16)
    header = json.dumps({"w": entry}).encode()
    n = len(header) + (1 << 40 if fault == "header_past_end" else 0)
    path = tmp_path / "bad.safetensors"
    path.write_bytes(struct.pack("<Q", n) + header + data)
    with pytest.raises(ValueError, match="bad.safetensors") as err:
        SafetensorsFile(str(path)).get("w")
    if fault != "header_past_end":
        assert "'w'" in str(err.value)


def test_converter_defaults_to_cuda(monkeypatch):
    """``convert_hf_state_dict`` runs on CUDA unless the caller asks for the
    CPU: with no card and no device it raises, naming CUDA."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg, mt = transformer_config_from_hf(_hf_model("gpt2").config.to_dict())
    with pytest.raises(RuntimeError, match="CUDA"):
        convert_hf_state_dict({}, cfg, mt)


def test_bin_checkpoint_converts_like_safetensors(saved, tmp_path):
    """A directory of ``.bin`` weights (``torch.load(weights_only=True)``)
    gives the same tensors, and the same converted tree, as the
    ``.safetensors`` save of the same model."""
    model, path = saved("gpt_neox")
    model.save_pretrained(str(tmp_path), safe_serialization=False)
    assert any(f.endswith(".bin") for f in os.listdir(tmp_path))
    st_sd = HuggingFaceCheckpointEngine(path).state_dict()
    bin_sd = HuggingFaceCheckpointEngine(str(tmp_path)).state_dict()
    assert sorted(bin_sd) == sorted(st_sd)
    for name in st_sd:
        assert torch.equal(bin_sd[name], st_sd[name]), name
    cfg, mt = transformer_config_from_hf(_hf_config(path))
    a = _flat(convert_hf_state_dict(st_sd, cfg, mt, dtype=torch.float32, device="cpu"))
    b = _flat(convert_hf_state_dict(bin_sd, cfg, mt, dtype=torch.float32, device="cpu"))
    assert all(torch.equal(a[k], b[k]) for k in a) and sorted(a) == sorted(b)


def test_hub_name_without_a_directory_raises(tmp_path, monkeypatch):
    """A name that is not a local directory goes through ``transformers``;
    where it does not import, the loader says a local directory is needed."""
    import builtins

    real = builtins.__import__

    def no_transformers(name, *a, **k):
        if name.split(".")[0] == "transformers":
            raise ImportError("no transformers")
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_transformers)
    with pytest.raises(FileNotFoundError, match="local directory"):
        HuggingFaceCheckpointEngine(str(tmp_path / "not-here")).model_config()
    with pytest.raises(FileNotFoundError, match="no .safetensors or .bin"):
        HuggingFaceCheckpointEngine(str(tmp_path)).state_dict()

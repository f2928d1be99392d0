"""PyTorch port: the model families, the HF config mapping, the factory and
the serving refusals, against the JAX package on the CPU.

Every preset of every family gives a ``TransformerConfig`` equal to the JAX
package's field by field (no parameters are built); ``config.json`` of the
tiny HF models of ``tests/test_hf_checkpoint.py`` maps to equal configs,
and the same checkpoints are refused; the CUDA paged-attention module
takes every preset's head dim and group size and refuses at engine build a
shape its kernels are not built for (head_dim 32), and the training engine
takes every preset's head dim on the flash kernels and refuses d 32 (checked
without a device); the factory builds ``gpt2``, ``opt``, ``qwen2`` and ``phi`` by
name.
"""

import ast
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu.inference.v2 as jax_v2
import deepspeed_tpu.models as jax_models
import deepspeed_tpu_torch.inference.v2 as v2
import deepspeed_tpu_torch.models as models
from deepspeed_tpu.inference.v2.checkpoint.huggingface_engine import \
    transformer_config_from_hf as jax_config_from_hf
from deepspeed_tpu_torch.inference.v2.checkpoint.huggingface_engine import \
    transformer_config_from_hf
from deepspeed_tpu_torch.inference.v2.config_v2 import (DSStateManagerConfig,
                                                        RaggedInferenceEngineConfig)
from deepspeed_tpu_torch.inference.v2.modules.heuristics import build_modules
from deepspeed_tpu_torch.models.transformer import (TransformerLM, cached_attention_route,
                                                  training_attention_route)
from deepspeed_tpu_torch.ops import flash_attention as fa
from deepspeed_tpu_torch.ops import paged_attention as tpa

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PRESETS = {  # family config function -> its sizes (the JAX files' preset keys)
    "llama2_config": ("tiny", "7b", "13b", "70b"),
    "mistral_config": ("tiny", "7b"),
    "qwen2_config": ("tiny", "0.5b", "7b"),
    "gpt2_config": ("tiny", "small", "medium", "large", "xl"),
    "opt_config": ("tiny", "125m", "1.3b", "6.7b", "13b", "30b", "66b"),
    "bloom_config": ("tiny", "560m", "7b1", "176b"),
    "phi_config": ("tiny", "1.5", "2"),
    "gptj_config": ("tiny", "6b"),
    "gpt_neox_config": ("tiny", "pythia-1b", "20b"),
    "falcon_config": ("tiny", "7b", "40b"),
}


def _fields(cfg):
    """A config's fields, the dtype by name (jnp and torch dtypes differ)."""
    out = {}
    for f in dataclasses.fields(models.TransformerConfig):
        v = getattr(cfg, f.name)
        out[f.name] = str(v).replace("torch.", "") if f.name == "dtype" else v
    if not isinstance(cfg, models.TransformerConfig):
        out["dtype"] = str(jnp.dtype(cfg.dtype))
    return out


@pytest.mark.parametrize("fn,size", [(fn, s) for fn, sizes in PRESETS.items() for s in sizes])
def test_presets_equal_the_jax_presets(fn, size):
    """Each family's preset (and an override) equals the JAX package's
    field by field; the family functions take the port's signature."""
    assert _fields(getattr(models, fn)(size)) == _fields(getattr(jax_models, fn)(size))
    over = dict(num_layers=1, max_seq_len=256)
    assert _fields(getattr(models, fn)(size, **over)) == _fields(getattr(jax_models, fn)(size,
                                                                                      **over))


def test_every_jax_preset_is_covered():
    """The table above names every JAX family and every size it has."""
    import inspect
    import re

    for fn in PRESETS:
        src = inspect.getsource(getattr(jax_models, fn))
        keys = tuple(re.findall(r'^\s+"([^"]+)": dict\(', src, re.M))
        assert keys == PRESETS[fn], fn
    jax_fns = {n for n in dir(jax_models) if n.endswith("_config")}
    assert jax_fns == set(PRESETS)
    from deepspeed_tpu_torch import model_implementations

    for fn in PRESETS:
        assert getattr(model_implementations, fn) is getattr(models, fn)
        assert callable(getattr(models, fn[:-len("_config")]))


HF_KINDS = ("llama", "mistral", "qwen2", "gpt2", "opt", "bloom", "gptj", "gpt_neox", "falcon",
            "falcon40b", "phi")


def _tiny_hf_config(kind):
    """``config.json`` of one of the eleven tiny HF models (transformers'
    own config classes, so HF's defaults fill the rest)."""
    T = pytest.importorskip("transformers")
    small = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2, num_attention_heads=4)
    llama_like = dict(small, intermediate_size=128, max_position_embeddings=128,
                      tie_word_embeddings=False)
    make = {
        "llama": lambda: T.LlamaConfig(num_key_value_heads=2, **llama_like),
        "mistral": lambda: T.MistralConfig(num_key_value_heads=2, **llama_like),
        "qwen2": lambda: T.Qwen2Config(num_key_value_heads=2, **llama_like),
        "gpt2": lambda: T.GPT2Config(vocab_size=128, n_embd=64, n_layer=2, n_head=4,
                                     n_positions=128),
        "opt": lambda: T.OPTConfig(ffn_dim=128, max_position_embeddings=128,
                                   word_embed_proj_dim=64, do_layer_norm_before=True, **small),
        "bloom": lambda: T.BloomConfig(vocab_size=128, hidden_size=64, n_layer=2, n_head=4),
        "gptj": lambda: T.GPTJConfig(vocab_size=128, n_embd=64, n_layer=2, n_head=4,
                                     rotary_dim=8, n_positions=128),
        "gpt_neox": lambda: T.GPTNeoXConfig(intermediate_size=128, rotary_pct=0.25,
                                            max_position_embeddings=128,
                                            use_parallel_residual=True,
                                            tie_word_embeddings=False, **small),
        "falcon": lambda: T.FalconConfig(multi_query=True, parallel_attn=True,
                                         new_decoder_architecture=False, bias=False,
                                         alibi=False, **small),
        "falcon40b": lambda: T.FalconConfig(num_kv_heads=2, multi_query=True, parallel_attn=True,
                                            new_decoder_architecture=True, bias=False,
                                            alibi=False, **small),
        "phi": lambda: T.PhiConfig(partial_rotary_factor=0.5, **llama_like),
    }
    return make[kind]().to_dict()


@pytest.mark.parametrize("kind", HF_KINDS)
def test_hf_config_mapping_equals_the_jax_mapping(kind):
    """``transformer_config_from_hf`` gives the JAX package's config, field
    by field, and the same model type."""
    d = _tiny_hf_config(kind)
    cfg, mt = transformer_config_from_hf(d)
    jcfg, jmt = jax_config_from_hf(d)
    assert mt == jmt
    assert _fields(cfg) == _fields(jcfg)


@pytest.mark.parametrize("hf,match", [
    ({"model_type": "mamba"}, "unsupported model_type"),
    ({"model_type": "falcon", "alibi": True, "vocab_size": 8, "hidden_size": 8,
      "num_attention_heads": 2}, "alibi"),
    ({"model_type": "falcon", "bias": True, "vocab_size": 8, "hidden_size": 8,
      "num_attention_heads": 2}, "bias"),
    ({"model_type": "falcon", "parallel_attn": False, "vocab_size": 8, "hidden_size": 8,
      "num_attention_heads": 2}, "sequential"),
])
def test_hf_config_refusals_match_the_jax_mapping(hf, match):
    for fn in (transformer_config_from_hf, jax_config_from_hf):
        with pytest.raises(ValueError, match=match):
            fn(dict(hf))


def _ec():
    return RaggedInferenceEngineConfig(kv_block_size=16)


# the presets at head dims 80 / 96 / 256 and group sizes over 8, with the
# head dim and group size that the first kernels refused
WIDENED = [("phi_config", "2", "head_dim 80"),
           ("gptj_config", "6b", "head_dim 256"),
           ("gpt_neox_config", "20b", "head_dim 96"),
           ("gpt_neox_config", "pythia-1b", "head_dim 256"),
           ("falcon_config", "7b", "group size 71"),
           ("falcon_config", "40b", "group size 16")]


@pytest.mark.parametrize("fn,size,miss", WIDENED)
def test_cuda_attention_refuses_unbuilt_shapes_at_engine_build(fn, size, miss):
    """The six presets the kernels once refused (``miss``) now build on the
    CUDA kernels: no miss in the shape rule, and the engine's modules pick
    ``paged_cuda_attention`` (no device needed: the check reads the
    config); the plain route takes them too."""
    cfg = getattr(models, fn)(size)
    assert tpa.unsupported_shape(cfg.num_heads, cfg.num_kv_heads, cfg.head_dim) == []
    assert build_modules(cfg, _ec(), use_kernels=True)["attention"].name() == \
        "paged_cuda_attention"
    assert build_modules(cfg, _ec(), use_kernels=False)["attention"].name() == \
        "dense_blocked_attention"


@pytest.mark.parametrize("fn", ["phi_config", "gptj_config", "falcon_config"])
def test_cuda_attention_still_refuses_head_dim_32_at_engine_build(fn):
    """A shape still outside the kernels' rule (the tiny presets' head_dim
    32) is refused when the engine's modules are built, naming the miss and
    ROADMAP A5b; the plain route takes it."""
    cfg = getattr(models, fn)("tiny")
    assert cfg.head_dim == 32
    with pytest.raises(ValueError, match=r"head_dim 32.*A5b"):
        build_modules(cfg, _ec(), use_kernels=True)
    assert build_modules(cfg, _ec(), use_kernels=False)["attention"].name() == \
        "dense_blocked_attention"


@pytest.mark.parametrize("fn,size,miss", WIDENED)
def test_v1_cache_route_takes_the_widened_presets_on_cuda(fn, size, miss):
    """``init_inference``'s KV-cache route on a bf16 CUDA cache takes the
    paged kernels at every widened preset (no device: the route is a pure
    function of the shapes)."""
    cfg = getattr(models, fn)(size)
    assert cached_attention_route("auto", "cuda", torch.bfloat16, cfg.num_heads,
                                  cfg.num_kv_heads, cfg.head_dim, 1024) == "paged"
    assert cached_attention_route("flash", "cuda", torch.bfloat16, cfg.num_heads,
                                  cfg.num_kv_heads, cfg.head_dim, 1024) == "paged"


@pytest.mark.parametrize("fn,size,trains", [
    ("phi_config", "2", True), ("gptj_config", "6b", True), ("gpt_neox_config", "20b", True),
    ("gpt_neox_config", "pythia-1b", True), ("falcon_config", "7b", True),
    ("mistral_config", "7b", True), ("qwen2_config", "7b", True), ("phi_config", "tiny", False)])
def test_flash_takes_the_family_head_dims_and_refuses_d32_at_engine_build(fn, size, trains):
    """Training on the card goes through the flash kernels, built for head
    dims 64, 80, 96, 128 and 256: every real preset takes the flash route;
    a model at another head dim (d 32, phi's CPU-only tiny preset) is
    refused when the engine is built, naming the head dim and ROADMAP A5b,
    not at its first step. The CPU and ``attention_impl='reference'`` never
    reach the flash kernels and pass. No device: the check reads the
    config."""
    cfg = getattr(models, fn)(size)
    assert (fa.unsupported_shape(cfg.num_heads, cfg.num_kv_heads, cfg.head_dim) == []) == trains
    if trains:
        assert training_attention_route(cfg, "cuda") == "flash"
    else:
        with pytest.raises(ValueError, match=rf"head_dim {cfg.head_dim} .*ROADMAP A5b\)"):
            training_attention_route(cfg, "cuda")
    assert training_attention_route(cfg, "cpu") == "reference"
    assert training_attention_route(dataclasses.replace(cfg, attention_impl="reference"),
                                    "cuda") == "reference"


def test_training_engine_asks_the_flash_rule_when_built(monkeypatch):
    """``initialize`` asks ``training_attention_route`` with the model's
    config and the parameters' device type before it builds anything else."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.runtime import engine as engine_mod

    seen = []
    monkeypatch.setattr(engine_mod, "training_attention_route",
                        lambda cfg, device_type: seen.append((cfg.head_dim, device_type)))
    model = TransformerLM(models.phi_config("tiny", dtype=torch.float32, num_layers=1,
                                            vocab_size=64), device="cpu", trainable=True)
    deepspeed_tpu_torch.initialize(model=model, config={
        "train_batch_size": 1, "optimizer": {"type": "AdamW", "params": {"lr": 1e-4}}})
    assert seen == [(32, "cpu")]


@pytest.mark.parametrize("fn,size", [("qwen2_config", "7b"), ("qwen2_config", "0.5b"),
                                     ("bloom_config", "7b1"), ("bloom_config", "560m"),
                                     ("gpt2_config", "xl"), ("opt_config", "6.7b"),
                                     ("mistral_config", "7b"), ("llama2_config", "70b")])
def test_cuda_attention_takes_the_kernels_shapes(fn, size):
    """Group sizes 1 to 8 at head dims 64 and 128 build on the kernels
    (Qwen2-7B: g 7; Bloom: ALiBi, g 1)."""
    mods = build_modules(getattr(models, fn)(size), _ec(), use_kernels=True)
    assert mods["attention"].name() == "paged_cuda_attention"


def test_factory_builds_the_reference_families_by_name():
    """gpt2, opt, qwen2 and phi build by name (as the JAX factory has them)
    and serve a put; bloom, gptj, gpt_neox and falcon are refused by name,
    as there, and build through ``build_engine(model)``."""
    sm = DSStateManagerConfig(max_tracked_sequences=2, max_ragged_batch_size=16,
                              max_ragged_sequence_count=2, max_context=32)
    ec = RaggedInferenceEngineConfig(kv_block_size=8, num_kv_blocks=8, state_manager=sm)
    ids = np.arange(5, dtype=np.int32)
    for family in ("gpt2", "opt", "qwen2", "phi"):
        eng = v2.build_model_engine(family, "tiny", ec, device="cpu", dtype=torch.float32,
                                    num_layers=1, vocab_size=64)
        assert np.isfinite(eng.put([1], [ids])).all(), family
    for family in ("bloom", "gptj", "gpt_neox", "falcon"):
        with pytest.raises(ValueError, match="build_engine"):
            v2.build_model_engine(family, "tiny", ec, device="cpu")
        with pytest.raises(ValueError):
            jax_v2.build_model_engine(family, "tiny")
        model = getattr(models, family)("tiny", device="cpu", dtype=torch.float32, num_layers=1)
        eng = v2.build_engine(model, ec, device="cpu")
        assert eng.put([1], [ids]).shape == (1, model.config.vocab_size), family


def test_inference_utils_match_the_jax_module():
    """The enums and helpers of ``inference_utils`` (torch dtypes where the
    JAX module has jnp ones)."""
    for name in ("NormTypeEnum", "ActivationType"):
        ours, theirs = getattr(v2, name), getattr(jax_v2, name)
        assert [(m.name, m.value) for m in ours] == [(m.name, m.value) for m in theirs]
    assert [m.name for m in v2.DtypeEnum] == [m.name for m in jax_v2.DtypeEnum]
    for m in v2.DtypeEnum:
        assert m.value[1:] == jax_v2.DtypeEnum[m.name].value[1:]
        assert str(m.dtype).replace("torch.", "") == str(jnp.dtype(jax_v2.DtypeEnum[m.name].dtype))
        for alias in m.value[1:]:
            assert v2.DtypeEnum.from_str(alias) is m
    with pytest.raises(ValueError):
        v2.DtypeEnum.from_str("fp8")
    for act in v2.ActivationType:
        assert v2.is_gated(act) == jax_v2.is_gated(jax_v2.ActivationType(int(act)))
    for dt, n in ((torch.bfloat16, 2), (torch.float32, 4), (torch.int8, 1)):
        assert v2.elem_size(dt) == n
    assert [v2.ceil_div(a, 4) for a in (0, 1, 4, 5)] == [0, 1, 1, 2]


def test_hf_packages_are_not_imported_at_module_level():
    """Neither the port nor ``chip_smoke.py`` imports ``transformers`` or
    ``safetensors`` at module level (the card's machine has neither); the
    script imports them nowhere."""
    bad = []
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "deepspeed_tpu_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    for path in paths:
        tree = ast.parse(open(path).read(), filename=path)
        script = path.endswith("chip_smoke.py")
        for node in (ast.walk(tree) if script else tree.body):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                names = [node.module]
            if any(n.split(".")[0] in ("transformers", "safetensors") for n in names):
                bad.append(f"{os.path.relpath(path, REPO)}:{node.lineno}")
    assert len(paths) > 40 and not bad, bad

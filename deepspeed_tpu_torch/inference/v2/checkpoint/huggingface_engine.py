"""HuggingFace checkpoint loading for the serving engine (counterpart of
``deepspeed_tpu/inference/v2/checkpoint/huggingface_engine.py``, the
reference's ``inference/v2/checkpoint/huggingface_engine.py`` and
``engine_factory.build_hf_engine``).

A checkpoint directory's ``config.json`` maps to a ``TransformerConfig``
(:func:`transformer_config_from_hf`), and its weights go through the
family's ``ParamSpec`` table (``model_implementations/parameter_spec.py``)
into the port's stacked parameter tree on the serving device. Families:
llama, mistral, qwen2, phi, gpt2, opt, bloom, gptj, gpt_neox, falcon.

Weights are read without the ``safetensors`` package: a ``.safetensors``
file is an 8-byte little-endian header length, a JSON header (each tensor's
dtype, shape and byte range) and the raw bytes (:class:`SafetensorsFile`;
BF16, F16 and F32 are decoded, any other dtype raises when read). Every
``.safetensors`` file of the directory is read (a sharded checkpoint);
without one, ``.bin`` files go through ``torch.load(weights_only=True)``. A
name that is not a local directory is a hub name: it needs ``transformers``,
imported only then.
"""

import json
import math
import os
import struct
from typing import Dict, Iterator, Mapping, Optional, Tuple

import torch

from ....models.transformer import TransformerConfig, TransformerLM, resolve_device
from ..config_v2 import RaggedInferenceEngineConfig
from ..engine_v2 import InferenceEngineV2
from ..model_implementations.parameter_spec import FAMILY_SPECS, convert_with_spec
from ..modules.heuristics import check_modules

SAFETENSORS_DTYPES = {"BF16": torch.bfloat16, "F16": torch.float16, "F32": torch.float32}


class SafetensorsFile:
    """One ``.safetensors`` file: the header is parsed when it is opened;
    each tensor is read from the file when :meth:`get` asks for it."""

    def __init__(self, path: str):
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            head = f.read(8)
            n = struct.unpack("<Q", head)[0] if len(head) == 8 else None
            if n is None or 8 + n > size:
                raise ValueError(f"{path}: the header length runs past the end of the file "
                                 f"({size} bytes); not a whole .safetensors file")
            try:
                header = json.loads(f.read(n))
            except ValueError as e:
                raise ValueError(f"{path}: the header is not JSON") from e
        header.pop("__metadata__", None)
        self.path = path
        self.data_start = 8 + n
        self.entries: Dict[str, dict] = header

    def keys(self):
        return self.entries.keys()

    def get(self, name: str) -> torch.Tensor:
        e = self.entries[name]
        dtype = SAFETENSORS_DTYPES.get(e["dtype"])
        if dtype is None:
            raise ValueError(f"{self.path}: tensor {name!r} has dtype {e['dtype']}; the reader "
                             f"decodes {sorted(SAFETENSORS_DTYPES)}")
        start, end = e["data_offsets"]
        nbytes = math.prod(e["shape"]) * dtype.itemsize
        if not 0 <= start <= end or end - start != nbytes:
            raise ValueError(f"{self.path}: tensor {name!r} spans bytes [{start}, {end}), but "
                             f"{e['dtype']} of shape {e['shape']} takes {nbytes}")
        buf = bytearray(nbytes)
        with open(self.path, "rb") as f:
            f.seek(self.data_start + start)
            if f.readinto(buf) != len(buf):
                raise ValueError(f"{self.path}: tensor {name!r} runs past the end of the file")
        if not buf:
            return torch.empty(e["shape"], dtype=dtype)
        return torch.frombuffer(buf, dtype=dtype).reshape(e["shape"])


class LazyStateDict(Mapping):
    """name -> tensor over the ``.safetensors`` files of a checkpoint: a
    tensor is read when it is looked up, so the converter holds one source
    tensor at a time. A name in several files is read from the last (in
    sorted file order)."""

    def __init__(self, files):
        self._where = {}
        for f in files:
            for name in f.keys():
                self._where[name] = f

    def __getitem__(self, name: str) -> torch.Tensor:
        return self._where[name].get(name)

    def __contains__(self, name) -> bool:
        return name in self._where

    def __iter__(self):
        return iter(self._where)

    def __len__(self) -> int:
        return len(self._where)


def _transformers():
    try:
        import transformers
    except ImportError as e:
        raise FileNotFoundError(
            "the checkpoint is not a local directory, and reading a hub name needs the "
            "transformers package, which does not import here; pass a directory holding "
            "config.json and the .safetensors (or .bin) weights") from e
    return transformers


class HuggingFaceCheckpointEngine:
    """Weights and config of an HF model directory or hub name (the
    reference's class of the same name). ``state_dict()`` is a mapping from
    HF names to torch tensors in the checkpoint's dtype; for ``.safetensors``
    it reads each tensor when it is looked up."""

    def __init__(self, model_name_or_path: str, auth_token: Optional[str] = None):
        self.model_name_or_path = model_name_or_path
        self._sd = None

    def _load(self) -> Mapping:
        if self._sd is not None:
            return self._sd
        path = self.model_name_or_path
        if os.path.isdir(path):
            names = sorted(os.listdir(path))
            safes = [f for f in names if f.endswith(".safetensors")]
            bins = [f for f in names if f.endswith(".bin")]
            if safes:
                sd = LazyStateDict(SafetensorsFile(os.path.join(path, f)) for f in safes)
            elif bins:
                sd = {}
                for f in bins:
                    sd.update(torch.load(os.path.join(path, f), map_location="cpu",
                                         weights_only=True))
            else:
                raise FileNotFoundError(f"no .safetensors or .bin weights in {path}")
        else:  # a hub name
            model = _transformers().AutoModelForCausalLM.from_pretrained(path)
            sd = {k: v.detach() for k, v in model.state_dict().items()}
        self._sd = sd
        return sd

    def parameters(self) -> Iterator[Tuple[str, torch.Tensor]]:
        sd = self._load()
        for name in sd:
            yield name, sd[name]

    def state_dict(self) -> Mapping:
        return self._load()

    def model_config(self) -> dict:
        path = self.model_name_or_path
        cfg_file = os.path.join(path, "config.json")
        if os.path.isdir(path):
            if not os.path.isfile(cfg_file):
                raise FileNotFoundError(f"no config.json in {path}")
            with open(cfg_file) as f:
                return json.load(f)
        return _transformers().AutoConfig.from_pretrained(path).to_dict()


# ---------------------------------------------------------------------------
# config mapping
# ---------------------------------------------------------------------------
def transformer_config_from_hf(hf_cfg: dict) -> Tuple[TransformerConfig, str]:
    """HF ``config.json`` -> (``TransformerConfig``, model_type): the
    per-family policy lookup (the reference's model_type dispatch)."""
    mt = hf_cfg.get("model_type", "llama")
    if mt in ("llama", "mistral", "qwen2"):
        return TransformerConfig(
            vocab_size=hf_cfg["vocab_size"], hidden_size=hf_cfg["hidden_size"],
            num_layers=hf_cfg["num_hidden_layers"], num_heads=hf_cfg["num_attention_heads"],
            num_kv_heads=hf_cfg.get("num_key_value_heads", hf_cfg["num_attention_heads"]),
            intermediate_size=hf_cfg["intermediate_size"],
            max_seq_len=hf_cfg.get("max_position_embeddings", 2048),
            norm="rmsnorm", positions="rotary", mlp="swiglu", use_bias=False,
            qkv_bias=(mt == "qwen2"),  # qwen2: biased qkv only
            tie_embeddings=bool(hf_cfg.get("tie_word_embeddings", False)),
            rope_theta=float(hf_cfg.get("rope_theta", 10000.0)),
            norm_eps=float(hf_cfg.get("rms_norm_eps", 1e-5))), mt
    if mt == "phi":
        d = hf_cfg["hidden_size"] // hf_cfg["num_attention_heads"]
        return TransformerConfig(
            vocab_size=hf_cfg["vocab_size"], hidden_size=hf_cfg["hidden_size"],
            num_layers=hf_cfg["num_hidden_layers"], num_heads=hf_cfg["num_attention_heads"],
            intermediate_size=hf_cfg["intermediate_size"],
            max_seq_len=hf_cfg.get("max_position_embeddings", 2048),
            norm="layernorm", positions="rotary", mlp="gelu", use_bias=True,
            parallel_residual=True, shared_ln=True,
            rotary_dim=int(round(hf_cfg.get("partial_rotary_factor", 0.5) * d)),
            tie_embeddings=False,
            rope_theta=float(hf_cfg.get("rope_theta", 10000.0)),
            norm_eps=float(hf_cfg.get("layer_norm_eps", 1e-5))), mt
    if mt == "gpt2":
        return TransformerConfig(
            vocab_size=hf_cfg["vocab_size"], hidden_size=hf_cfg["n_embd"],
            num_layers=hf_cfg["n_layer"], num_heads=hf_cfg["n_head"],
            intermediate_size=4 * hf_cfg["n_embd"], max_seq_len=hf_cfg.get("n_positions", 1024),
            norm="layernorm", positions="learned", mlp="gelu", use_bias=True,
            tie_embeddings=True, norm_eps=float(hf_cfg.get("layer_norm_epsilon", 1e-5))), mt
    if mt == "opt":
        return TransformerConfig(
            vocab_size=hf_cfg["vocab_size"], hidden_size=hf_cfg["hidden_size"],
            num_layers=hf_cfg["num_hidden_layers"], num_heads=hf_cfg["num_attention_heads"],
            intermediate_size=hf_cfg["ffn_dim"],
            max_seq_len=hf_cfg.get("max_position_embeddings", 2048),
            norm="layernorm", positions="learned", mlp="relu", use_bias=True,
            tie_embeddings=bool(hf_cfg.get("tie_word_embeddings", True)), norm_eps=1e-5), mt
    if mt == "bloom":
        H = hf_cfg.get("hidden_size", hf_cfg.get("n_embed"))
        return TransformerConfig(
            vocab_size=hf_cfg["vocab_size"], hidden_size=H,
            num_layers=hf_cfg.get("num_hidden_layers", hf_cfg.get("n_layer")),
            num_heads=hf_cfg.get("num_attention_heads", hf_cfg.get("n_head")),
            intermediate_size=4 * H, max_seq_len=2048,
            norm="layernorm", positions="alibi", mlp="gelu", use_bias=True,
            tie_embeddings=True, embed_layernorm=True,
            norm_eps=float(hf_cfg.get("layer_norm_epsilon", 1e-5))), mt
    if mt == "gptj":
        return TransformerConfig(
            vocab_size=hf_cfg["vocab_size"], hidden_size=hf_cfg["n_embd"],
            num_layers=hf_cfg["n_layer"], num_heads=hf_cfg["n_head"],
            intermediate_size=hf_cfg.get("n_inner") or 4 * hf_cfg["n_embd"],
            max_seq_len=hf_cfg.get("n_positions", 2048),
            norm="layernorm", positions="rotary", mlp="gelu", use_bias=True,
            tie_embeddings=False, parallel_residual=True, shared_ln=True,
            rotary_dim=hf_cfg.get("rotary_dim") or hf_cfg["n_embd"] // hf_cfg["n_head"],
            norm_eps=float(hf_cfg.get("layer_norm_epsilon", 1e-5))), mt
    if mt == "gpt_neox":
        hd = hf_cfg["hidden_size"] // hf_cfg["num_attention_heads"]
        return TransformerConfig(
            vocab_size=hf_cfg["vocab_size"], hidden_size=hf_cfg["hidden_size"],
            num_layers=hf_cfg["num_hidden_layers"], num_heads=hf_cfg["num_attention_heads"],
            intermediate_size=hf_cfg["intermediate_size"],
            max_seq_len=hf_cfg.get("max_position_embeddings", 2048),
            norm="layernorm", positions="rotary", mlp="gelu", use_bias=True,
            tie_embeddings=bool(hf_cfg.get("tie_word_embeddings", False)),
            parallel_residual=bool(hf_cfg.get("use_parallel_residual", True)), shared_ln=False,
            rotary_dim=max(2, int(hd * float(hf_cfg.get("rotary_pct", 0.25))) // 2 * 2),
            rope_theta=float(hf_cfg.get("rotary_emb_base", 10000.0)),
            norm_eps=float(hf_cfg.get("layer_norm_eps", 1e-5))), mt
    if mt == "falcon":
        nh = hf_cfg.get("num_attention_heads", hf_cfg.get("n_head"))
        new_arch = bool(hf_cfg.get("new_decoder_architecture", False))
        # HF: num_kv_heads applies with new_decoder_architecture or without
        # multi_query; only legacy multi_query models force one kv head
        if new_arch or not hf_cfg.get("multi_query", True):
            nkv = hf_cfg.get("num_kv_heads") or hf_cfg.get("n_head_kv") or nh
        else:
            nkv = 1
        if hf_cfg.get("alibi", False):
            raise ValueError("falcon checkpoints with alibi=true (falcon-rw family) are not "
                             "supported yet: the converter maps falcon to rotary positions")
        if hf_cfg.get("bias", False):
            raise ValueError("falcon checkpoints with bias=true are not supported yet: the "
                             "converter does not extract attention/MLP biases for falcon")
        if not hf_cfg.get("parallel_attn", True) and not new_arch:
            raise ValueError("sequential falcon (parallel_attn=false) is not supported yet: the "
                             "converter emits no post-attention norm for that layout")
        return TransformerConfig(
            vocab_size=hf_cfg["vocab_size"], hidden_size=hf_cfg["hidden_size"],
            num_layers=hf_cfg.get("num_hidden_layers", hf_cfg.get("n_layer")),
            num_heads=nh, num_kv_heads=nkv,
            intermediate_size=4 * hf_cfg["hidden_size"], max_seq_len=2048,
            norm="layernorm", positions="rotary", mlp="gelu",
            use_bias=bool(hf_cfg.get("bias", False)),
            tie_embeddings=bool(hf_cfg.get("tie_word_embeddings", True)),
            parallel_residual=bool(hf_cfg.get("parallel_attn", True)) or new_arch,
            shared_ln=bool(hf_cfg.get("parallel_attn", True)) and not new_arch,
            norm_eps=float(hf_cfg.get("layer_norm_epsilon", 1e-5))), mt
    raise ValueError(f"unsupported model_type {mt!r}; supported: llama, mistral, qwen2, phi, gpt2, "
                     "opt, bloom, gptj, gpt_neox, falcon")


# ---------------------------------------------------------------------------
# weight conversion
# ---------------------------------------------------------------------------
def convert_hf_state_dict(sd: Mapping, cfg: TransformerConfig, model_type: str, dtype=None,
                          device=None) -> dict:
    """HF state dict -> the port's parameter tree on ``device`` (default
    CUDA; asking for it without a card raises): matrix
    weights and embeddings in ``dtype`` (default ``cfg.dtype``), norms and
    biases fp32, blocks stacked ``[L, ...]``."""
    spec = FAMILY_SPECS.get(model_type)
    if spec is None:
        raise ValueError(f"unsupported model_type {model_type!r}; supported: "
                         f"{sorted(FAMILY_SPECS)}")
    return convert_with_spec(sd, cfg, spec, dtype=dtype, device=device)


def build_hf_engine(model_name_or_path: str,
                    engine_config: Optional[RaggedInferenceEngineConfig] = None, dtype=None,
                    device=None) -> InferenceEngineV2:
    """HF checkpoint -> a ready ``InferenceEngineV2`` on ``device`` (default
    CUDA), computing in ``dtype`` (default the config's bf16). A model the
    serving modules refuse (on CUDA: a head dim or group size the paged
    kernels are not built for) raises before any weight is read."""
    ckpt = HuggingFaceCheckpointEngine(model_name_or_path)
    cfg, model_type = transformer_config_from_hf(ckpt.model_config())
    if dtype is not None:
        cfg.dtype = dtype
    dev = resolve_device(device)
    engine_config = engine_config or RaggedInferenceEngineConfig()
    check_modules(cfg, engine_config, use_kernels=dev.type == "cuda")
    params = convert_hf_state_dict(ckpt.state_dict(), cfg, model_type, device=dev)
    return InferenceEngineV2(TransformerLM(cfg, params, device=dev), engine_config, device=dev)

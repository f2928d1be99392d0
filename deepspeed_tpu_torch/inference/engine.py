"""InferenceEngine (v1): generation over a preallocated KV cache.

Counterpart of ``deepspeed_tpu/inference/engine.py``. ``generate`` runs one
prefill through ``models.transformer.forward_with_cache`` and then one
decode step per new token, in a Python loop (the JAX package compiles the
same prefill and a ``lax.scan`` of decode steps into one program): each
step's token is chosen on the device and written into a preallocated
``[B, new]`` tensor, and the host reads the tokens once, after the loop. On
the card the cache's attention runs through the paged kernels
(``cached_attention_route``).

Tensor parallelism (``tensor_parallel.tp_size`` above 1, the reference's
``engine.py:32-43``): the engine builds ``MeshConfig(data=-1, model=tp)``
over the initialised process group (or keeps a mesh of that model size),
the model becomes this rank's shards (``TransformerLM.shard_tensor_parallel``:
rank 0's weights, broadcast and sliced leaf by leaf; a model built with
the plan stays as it is), the cache holds this rank's kv heads, and every
layer runs the paged kernels on this rank's heads. The logits are gathered
over the model group (only the last position's in ``generate``), so every
rank picks the same tokens.

Not ported: quantized weights (A7), checkpoint loading (A9); their configs
are refused (``inference/config.py``). ``enable_cuda_graph`` is accepted and
does nothing, as in the JAX package.
"""

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from .. import comm
from ..models.transformer import (V1_BLOCK, _forward_with_cache, _whole_logits,
                                  cached_attention_route, forward, init_kv_cache, layers,
                                  resolve_device, tensor_parallel)
from ..parallel import groups
from ..parallel.mesh import MeshConfig
from .config import DeepSpeedInferenceConfig


def _on(params, device):
    """The parameter tree with every tensor on ``device`` (no copy for those
    already there)."""
    return {g: ([{n: t.to(device) for n, t in layer.items()} for layer in leaves]
                if isinstance(leaves, (list, tuple)) else
                {n: t.to(device) for n, t in leaves.items()}) for g, leaves in params.items()}


class InferenceEngine:

    def __init__(self, model, config: Optional[DeepSpeedInferenceConfig] = None, params=None,
                 device=None):
        """``model``: a ``models.TransformerLM`` (the engine runs a copy of
        its ``config`` with the compute dtype; the model's own is left as it
        is); ``params``: its parameter tree (default: the model's own),
        stacked or per-layer, weights cast to the compute dtype where they
        are used. ``device`` defaults to CUDA; parameters elsewhere are
        copied there. On the card, a cache the paged kernels do not take
        (``cached_attention_route``, at this rank's head counts) raises
        here. At ``tp_size`` above 1 ``params`` is the whole tree, the same
        on every rank, and this rank's slices of it are served; without it
        the model is split in place (module docstring)."""
        self.module = model
        self._config = config or DeepSpeedInferenceConfig()
        self.device = resolve_device(device)
        cfg = self.model_config = dataclasses.replace(model.config,
                                                      dtype=self._config.compute_dtype)
        self.tp = self._tensor_parallel(model, params)
        if self.tp is not None and params is not None:
            from ..models.convert import tensor_parallel_shards

            params = tensor_parallel_shards(params, self.tp)
        nq, nkv, _ = self.tp.heads(cfg) if self.tp is not None else (cfg.num_heads,
                                                                    cfg.num_kv_heads, 0)
        cached_attention_route(cfg.attention_impl, self.device.type, cfg.dtype, nq, nkv,
                               cfg.head_dim, V1_BLOCK)
        params = _on(model.params() if params is None else params, self.device)
        # per-layer views of a stacked tree, taken once: the forward walks a
        # list, and writes into the stacked tensors stay visible
        self.params = dict(params, blocks=layers(params["blocks"], self.model_config.num_layers))
        self._model_profile_enabled = False
        self._use_cuda_events = False
        self._model_times = []

    def _tensor_parallel(self, model, params):
        """The plan at ``tp_size`` above 1 (None at 1): the mesh's model
        group of that size, built over the world where the mesh has another;
        the model split into this rank's shards unless ``params`` is
        given."""
        tp_size = int(self._config.tensor_parallel.tp_size)
        if tp_size == 1:
            if getattr(model, "tp", None) is not None:
                raise ValueError(f"the model holds tensor-parallel shards ({model.tp}); serve it "
                                 f"at tp_size {model.tp.size}")
            return None
        world = comm.get_world_size()
        if world % tp_size:
            raise ValueError(f"tensor_parallel.tp_size={tp_size} does not divide the world size "
                             f"{world} (init_distributed first)")
        if groups.get_model_parallel_world_size() != tp_size:
            groups.initialize_mesh(MeshConfig(data=-1, model=tp_size), self.device.type)
        tp = tensor_parallel(self.model_config, groups.get_model_parallel_group())
        if params is None:
            model.shard_tensor_parallel(tp)
        return tp

    # ------------------------------------------------------------------
    @torch.no_grad()
    def forward(self, input_ids):
        """Token ids [B, S] -> fp32 logits [B, S, V] through the plain
        forward (flash attention on the card)."""
        ids = (input_ids if torch.is_tensor(input_ids) else
               torch.as_tensor(np.asarray(input_ids))).to(self.device).long()
        if not self._model_profile_enabled:
            return forward(self.model_config, self.params, ids, self.tp)
        if self._use_cuda_events:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = forward(self.model_config, self.params, ids, self.tp)
            end.record()
            self._model_times.append((start, end))
        else:
            t0 = time.perf_counter()
            out = forward(self.model_config, self.params, ids, self.tp)
            self._model_times.append(time.perf_counter() - t0)
        return out

    __call__ = forward

    # ------------------------------------------------------------------
    def profile_model_time(self, use_cuda_events: bool = True):
        """Record each later ``forward``'s time: CUDA events on the card
        (when ``use_cuda_events``), the host's clock after the forward's
        work on the CPU."""
        self._model_profile_enabled = True
        self._use_cuda_events = bool(use_cuda_events) and self.device.type == "cuda"

    def model_times(self):
        """The recorded forwards' times in seconds, drained on read."""
        if not self._model_profile_enabled:
            raise AssertionError("model profiling is not enabled; call profile_model_time()")
        times, self._model_times = self._model_times, []
        if self._use_cuda_events:
            if times:
                times[-1][1].synchronize()
            times = [s.elapsed_time(e) / 1e3 for s, e in times]
        return times

    # ------------------------------------------------------------------
    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens: int = 32, temperature: float = 0.0,
                 top_k: int = 0, eos_token_id: Optional[int] = None, seed: int = 0):
        """Greedy (``temperature == 0``) or sampled generation. input_ids:
        [B, S] (no padding). Returns numpy ``[B, S + max_new_tokens]``; with
        ``eos_token_id``, each row is filled with it after its first one.

        The cache is allocated at ``S + max_new_tokens`` rounded up to a
        multiple of 128, the identity table's block, so that on the card the
        paged kernels take it. Both routes mask every position past the
        query's, so the extra positions change no result. Sampling draws
        from a ``torch.Generator`` on the device seeded with ``seed``: the
        same seed gives the same stream (not the JAX package's threefry
        stream)."""
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
        prompt = np.asarray(input_ids)
        B, S = prompt.shape
        smax = -(-(S + max_new_tokens) // V1_BLOCK) * V1_BLOCK
        cfg, dev, tp = self.model_config, self.device, self.tp
        cache = init_kv_cache(cfg, B, smax, device=dev, tp=tp)
        gen = torch.Generator(device=dev).manual_seed(seed) if temperature else None
        out = torch.empty((B, max_new_tokens), dtype=torch.int32, device=dev)

        def last_logits(ids):  # the last position's, whole on every rank
            logits, _ = _forward_with_cache(cfg, self.params, ids, cache, tp)
            return _whole_logits(logits[:, -1], tp)

        out[:, 0] = _select(last_logits(torch.tensor(prompt)), gen, temperature, top_k)
        for i in range(1, max_new_tokens):
            out[:, i] = _select(last_logits(out[:, i - 1:i]), gen, temperature, top_k)
        out = out.cpu().numpy()
        if eos_token_id is not None:  # after the loop, on the host (engine.py:147-153)
            for b in range(B):
                hits = np.flatnonzero(out[b] == eos_token_id)
                if hits.size:
                    out[b, hits[0] + 1:] = eos_token_id
        return np.concatenate([prompt, out], axis=1)

    # ------------------------------------------------------------------
    def load_checkpoint(self, path, template=None):
        raise NotImplementedError("InferenceEngine.load_checkpoint is not ported to the PyTorch "
                                  "package yet (ROADMAP A9); pass params= instead")

    def eval(self):
        return self

    @property
    def config(self):
        return self._config


def _select(logits, generator, temperature: float, top_k: int):
    """The next token of each row of fp32 ``logits`` [B, V], on the device:
    the argmax at temperature 0; else a draw from softmax(logits /
    temperature), restricted to the ``top_k`` largest when ``top_k > 0``, by
    the Gumbel-max rule (argmax of logits plus Gumbel noise from
    ``generator``), as ``jax.random.categorical`` draws."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits / temperature
    if top_k and top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, torch.full_like(logits, -1e30), logits)
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
    return torch.argmax(logits + gumbel, dim=-1).to(torch.int32)

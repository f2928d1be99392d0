"""InferenceEngine (v1): generation over a preallocated KV cache.

Counterpart of ``deepspeed_tpu/inference/engine.py``. ``generate`` runs one
prefill through ``models.transformer.forward_with_cache`` and then one
decode step per new token, in a Python loop (the JAX package compiles the
same prefill and a ``lax.scan`` of decode steps into one program): each
step's token is chosen on the device and written into a preallocated
``[B, new]`` tensor, and the host reads the tokens once, after the loop. On
the card the cache's attention runs through the paged kernels
(``cached_attention_route``).

Not ported: tensor parallelism (A3b), quantized weights (A7), checkpoint
loading (A9); their configs are refused (``inference/config.py``).
``enable_cuda_graph`` is accepted and does nothing, as in the JAX package.
"""

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..models.transformer import (V1_BLOCK, cached_attention_route, forward, forward_with_cache,
                                  init_kv_cache, layers, resolve_device)
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
        (``cached_attention_route``) raises here."""
        self.module = model
        self._config = config or DeepSpeedInferenceConfig()
        self.device = resolve_device(device)
        cfg = self.model_config = dataclasses.replace(model.config,
                                                      dtype=self._config.compute_dtype)
        cached_attention_route(cfg.attention_impl, self.device.type, cfg.dtype, cfg.num_heads,
                               cfg.num_kv_heads, cfg.head_dim, V1_BLOCK)
        params = _on(model.params() if params is None else params, self.device)
        # per-layer views of a stacked tree, taken once: the forward walks a
        # list, and writes into the stacked tensors stay visible
        self.params = dict(params, blocks=layers(params["blocks"], self.model_config.num_layers))
        self._model_profile_enabled = False
        self._use_cuda_events = False
        self._model_times = []

    # ------------------------------------------------------------------
    @torch.no_grad()
    def forward(self, input_ids):
        """Token ids [B, S] -> fp32 logits [B, S, V] through the plain
        forward (flash attention on the card)."""
        ids = (input_ids if torch.is_tensor(input_ids) else
               torch.as_tensor(np.asarray(input_ids))).to(self.device).long()
        if not self._model_profile_enabled:
            return forward(self.model_config, self.params, ids)
        if self._use_cuda_events:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = forward(self.model_config, self.params, ids)
            end.record()
            self._model_times.append((start, end))
        else:
            t0 = time.perf_counter()
            out = forward(self.model_config, self.params, ids)
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
        cfg, dev = self.model_config, self.device
        cache = init_kv_cache(cfg, B, smax, device=dev)
        gen = torch.Generator(device=dev).manual_seed(seed) if temperature else None
        out = torch.empty((B, max_new_tokens), dtype=torch.int32, device=dev)
        logits, cache = forward_with_cache(cfg, self.params, torch.tensor(prompt), cache)
        out[:, 0] = _select(logits[:, -1], gen, temperature, top_k)
        for i in range(1, max_new_tokens):
            logits, cache = forward_with_cache(cfg, self.params, out[:, i - 1:i], cache)
            out[:, i] = _select(logits[:, -1], gen, temperature, top_k)
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

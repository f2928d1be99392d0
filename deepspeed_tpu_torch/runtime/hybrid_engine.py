"""Hybrid engine: one model that trains and generates (RLHF rollouts).

Counterpart of ``deepspeed_tpu/runtime/hybrid_engine.py``. ``generate``
flips the engine to eval mode, refreshes the inference view of the current
weights when the step counter moved since the last refresh, runs the v1
``InferenceEngine.generate`` on that view and flips back.

The view is a stacked serving tree of the fp32 masters: matrix weights and
embeddings in the compute dtype (bf16 when the config enables it, else
fp32, as the JAX package chooses), norm scales and biases in fp32, in
buffers allocated at the first ``generate`` and rewritten in place at each
refresh. The JAX package casts the masters where they are used; casting
them once per step rounds them the same way and spares every decode step
the casts (``chip_smoke.py``'s hybrid phase times both). ``initialize`` returns this
engine when the config's ``hybrid_engine.enabled`` is true.
"""

import time
from typing import Optional

import torch

from .. import comm
from ..models.convert import _takes_serving_dtype
from ..models.transformer import V1_BLOCK, cached_attention_route
from .engine import DeepSpeedEngine


class DeepSpeedHybridEngine(DeepSpeedEngine):
    """Training engine + ``generate()``. The model must be a trainable
    ``models.TransformerLM``."""

    def __init__(self, *args, **kwargs):
        world = comm.get_world_size()
        if world > 1:
            raise NotImplementedError(
                f"the hybrid engine at world size {world}: its bf16 view of ZeRO-sharded masters "
                f"needs a gather (ROADMAP A1, left open)")
        super().__init__(*args, **kwargs)
        # on the card the rollouts' cache must suit the paged kernels: say so
        # now, not at the first generate after hours of training
        cfg = self.module.config
        cached_attention_route(cfg.attention_impl, self.device.type,
                               self._inference_config().compute_dtype, cfg.num_heads,
                               cfg.num_kv_heads, cfg.head_dim, V1_BLOCK)
        self._inference_engine = None
        self._inference_params_step = -1
        self._view_pairs = []  # (view slot, master) of every weight
        self._latency = []

    # ------------------------------------------------------------------
    def _inference_config(self):
        from ..inference.config import DeepSpeedInferenceConfig

        he = self.config.hybrid_engine_config
        return DeepSpeedInferenceConfig(dtype="bfloat16" if self.bfloat16_enabled else "float32",
                                        tensor_parallel={"tp_size": he.inference_tp_size})

    def _build_view(self, dtype):
        """Allocate the stacked view of the masters (``convert``'s dtype
        rule) and pair each slot with its master."""
        view, pairs = {}, []
        for group, leaves in self.module.params().items():
            per_layer = isinstance(leaves, (list, tuple))  # blocks -> stacked [L, ...]
            view[group] = {}
            for name, first in (leaves[0] if per_layer else leaves).items():
                dt = dtype if _takes_serving_dtype(group, name) else torch.float32
                shape = (len(leaves), *first.shape) if per_layer else first.shape
                buf = view[group][name] = torch.empty(shape, dtype=dt, device=self.device)
                pairs.extend(zip(buf, [layer[name] for layer in leaves]) if per_layer
                             else [(buf, first)])
        self._view_pairs = pairs
        return view

    @torch.no_grad()
    def _write_view(self):
        """Cast the current masters into the view, in place."""
        for slot, master in self._view_pairs:
            slot.copy_(master)

    def _refresh_inference_engine(self):
        """Build the inference engine over the view at the first call; later,
        rewrite the view only when the step counter moved since the last
        write."""
        from ..inference.engine import InferenceEngine

        step = int(self.state["step"])
        if self._inference_engine is None:
            cfg = self._inference_config()
            view = self._build_view(cfg.compute_dtype)
            self._write_view()
            self._inference_engine = InferenceEngine(self.module, cfg, params=view,
                                                     device=self.device)
        elif self._inference_params_step != step:
            self._write_view()
        self._inference_params_step = step

    def generate(self, input_ids, max_new_tokens: int = 32, temperature: float = 0.0,
                 top_k: int = 0, eos_token_id: Optional[int] = None, **kwargs):
        """Rollouts on the current weights (numpy ``[B, S + new]``). Safe to
        interleave with ``train_batch``; the engine's train / eval mode is
        restored afterwards."""
        was_training = self._train_mode
        self.eval()
        try:
            self._refresh_inference_engine()
            t0 = time.perf_counter()
            out = self._inference_engine.generate(input_ids, max_new_tokens=max_new_tokens,
                                                  temperature=temperature, top_k=top_k,
                                                  eos_token_id=eos_token_id, **kwargs)
            # the tokens are on the host: the device work has finished
            self._latency.append(time.perf_counter() - t0)
        finally:
            if was_training:
                self.train()
        return out

    def generate_latency(self):
        """Seconds per ``generate`` call."""
        return list(self._latency)

    # ------------------------------------------------------------------
    # LoRA fuse / unfuse (hybrid_engine.py:84-94)
    # ------------------------------------------------------------------
    @staticmethod
    def fuse_lora_weight(base_kernel, lora_a, lora_b, scaling: float = 1.0):
        """W' = W + scaling * A @ B."""
        return base_kernel + scaling * lora_a @ lora_b

    @staticmethod
    def unfuse_lora_weight(fused_kernel, lora_a, lora_b, scaling: float = 1.0):
        return fused_kernel - scaling * lora_a @ lora_b

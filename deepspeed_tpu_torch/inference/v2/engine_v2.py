"""InferenceEngineV2: continuous-batching ragged inference engine.

Counterpart of ``deepspeed_tpu/inference/v2/engine_v2.py:58-580,1431-1468``.
The serving loop is host-driven: the caller (``DynamicSplitFuseScheduler``)
hands ``put`` whatever mix of prefill chunks and decode steps it admitted;
``decode`` runs a multi-step greedy horizon. The forward runs eagerly (the
TPU package's per-bucket compiled programs have no counterpart), and the
only host-to-device traffic per forward is one packed descriptor upload.
Within a ``decode`` horizon each step's argmax stays on the device and feeds
the next step: the host waits once per horizon.

Not in this slice: sampled and speculative decoding, the prefix cache, the
monitor / goodput / health / roofline hooks. Configs that enable them are
refused; ``probe_prefix``/``acquire_prefix`` report "no hit".
"""

from typing import Iterable, List, Optional, Tuple

import numpy as np
import torch

from ...models.transformer import refuse_moe_serving, refuse_sparse_serving, resolve_device
from .config_v2 import RaggedInferenceEngineConfig
from .model_implementations.flat_model import ragged_forward
from .modules.heuristics import build_modules
from .ragged.kv_cache import _resolve_kv_dtype
from .ragged.ragged_manager import DSStateManager
from .ragged.ragged_wrapper import RaggedBatchWrapper, unpack_descriptors
from .scheduling_utils import SchedulingError, SchedulingResult


def _params_device(params) -> Optional[torch.device]:
    for leaves in params.values():
        for t in leaves.values():
            return t.device
    return None


class InferenceEngineV2:

    def __init__(self, model, config: Optional[RaggedInferenceEngineConfig] = None, params=None,
                 device=None):
        """``model``: a ``models.TransformerLM``; ``params``: its parameter
        tree (default: the model's own). ``device`` defaults to CUDA;
        parameters elsewhere are copied there."""
        self.config = config or RaggedInferenceEngineConfig()
        self.module = model
        self.model_config = model.config
        mc, ic = self.model_config, self.config
        refuse_moe_serving(mc)
        refuse_sparse_serving(mc)
        if getattr(ic.speculative, "enabled", False):
            raise NotImplementedError("speculative decoding is not ported to the PyTorch "
                                      "package yet; set speculative.mode='off'")
        self.device = resolve_device(device)
        self._modules = build_modules(mc, ic, use_kernels=self.device.type == "cuda")

        if params is None:
            params = model.params()
        if _params_device(params) != self.device:
            params = {g: {n: t.to(self.device) for n, t in leaves.items()}
                      for g, leaves in params.items()}
        self.params = params

        bs = ic.kv_block_size
        max_context = ic.state_manager.max_context
        model_max = getattr(mc, "max_seq_len", None)
        if model_max is not None and max_context > model_max:
            max_context = model_max
        self._max_context = max_context
        self._max_blocks_per_seq = -(-max_context // bs)
        if ic.num_kv_blocks in ("auto", 0, None):
            self.num_kv_blocks = self._auto_kv_blocks(mc, ic, max_context)
        else:
            self.num_kv_blocks = int(ic.num_kv_blocks)
        self.state_manager = DSStateManager(
            mc.num_layers, mc.num_kv_heads, mc.head_dim,
            max_tracked_sequences=ic.state_manager.max_tracked_sequences,
            num_blocks=self.num_kv_blocks, block_size=bs, dtype=ic.kv_dtype, device=self.device,
            prefix_cache_config=ic.prefix_cache)
        self.batch = RaggedBatchWrapper(
            max_ragged_batch_size=ic.state_manager.max_ragged_batch_size,
            max_ragged_sequence_count=ic.state_manager.max_ragged_sequence_count,
            max_blocks_per_seq=self._max_blocks_per_seq, block_size=bs)
        # the decode horizon packs exactly one token per sequence, so its
        # wrapper uses the SAME bucket table for tokens and sequences
        self._decode_batch = RaggedBatchWrapper(
            max_ragged_batch_size=self.batch.max_seqs,
            max_ragged_sequence_count=self.batch.max_seqs,
            max_blocks_per_seq=self._max_blocks_per_seq, block_size=bs,
            token_buckets=self.batch.seq_buckets, seq_buckets=self.batch.seq_buckets)

    # ------------------------------------------------------------------
    def _auto_kv_blocks(self, mc, ic, max_context: int) -> int:
        """Size the KV pool from the device's free memory after params:
        blocks = kv_memory_fraction x free / bytes_per_block, clamped to at
        least one max-context sequence and to the tracked-sequence demand.
        On the CPU the demand is capped at a 2 GiB host budget."""
        bs = ic.kv_block_size
        dt_bytes = torch.empty((), dtype=_resolve_kv_dtype(ic.kv_dtype)).element_size()
        per_block = 2 * mc.num_layers * mc.num_kv_heads * mc.head_dim * bs * dt_bytes
        if dt_bytes == 1:  # int8 KV: fp32 scales per (token, head) ride along
            per_block += 2 * mc.num_layers * mc.num_kv_heads * bs * 4
        min_blocks = -(-max_context // bs) + 1
        want_blocks = ic.state_manager.max_tracked_sequences * -(-max_context // bs)
        if self.device.type != "cuda":
            cap = max(min_blocks, (2 * 2**30) // per_block)
            return max(min_blocks, min(want_blocks, cap))
        free, _ = torch.cuda.mem_get_info(self.device)
        # memory the caching allocator holds but no tensor uses is free too
        free += torch.cuda.memory_reserved(self.device) - torch.cuda.memory_allocated(self.device)
        blocks = int(free * ic.kv_memory_fraction) // per_block
        return max(min_blocks, min(blocks, want_blocks))

    def can_schedule(self, uids: Iterable[int], lengths: Iterable[int]) -> SchedulingResult:
        """Admission control: sequence, token and KV-block budgets for the
        proposed batch."""
        uids, lengths = list(uids), list(lengths)
        sm = self.config.state_manager
        if len(set(uids)) != len(uids):
            return SchedulingResult.BatchSequenceLimitExceeded
        if len(uids) > sm.max_ragged_sequence_count:
            return SchedulingResult.BatchSequenceLimitExceeded
        n_new = sum(1 for u in uids if self.state_manager.get_sequence(u) is None)
        if self.state_manager.n_tracked_sequences + n_new > sm.max_tracked_sequences:
            return SchedulingResult.EngineSequenceLimitExceeded
        if sum(lengths) > sm.max_ragged_batch_size:
            return SchedulingResult.TokenLimitExceeded
        bs = self.config.kv_block_size
        blocks_needed = 0
        for u, n in zip(uids, lengths):
            seq = self.state_manager.get_sequence(u)
            total = n + (seq.seen_tokens if seq is not None else 0)
            if total > self._max_context:
                return SchedulingResult.KVCacheLimitExceeded
            blocks_needed += max(0, -(-total // bs)
                                 - (seq.cur_allocated_blocks if seq is not None else 0))
        if blocks_needed > self.state_manager.available_blocks:
            return SchedulingResult.KVCacheLimitExceeded
        return SchedulingResult.Success

    # ------------------------------------------------------------------
    def _forward(self, packed: torch.Tensor, t_bucket: int, s_bucket: int,
                 token_ids: Optional[torch.Tensor] = None, pos_offset: int = 0) -> torch.Tensor:
        """One ragged forward over the engine's pools (updated in place).
        ``token_ids``/``pos_offset`` override the packed tokens and advance
        the packed positions (the decode horizon). Returns fp32 logits."""
        ids, seq_idx, pos, valid, tables, last_idx = unpack_descriptors(
            packed, t_bucket, s_bucket, self._max_blocks_per_seq)
        if token_ids is not None:
            ids = token_ids
        if pos_offset:
            pos = pos + pos_offset
        pools = self.state_manager.kv_cache.pools()
        scales = {"k_scale": pools[2], "v_scale": pools[3]} if len(pools) == 4 else {}
        with torch.no_grad():
            return ragged_forward(self.model_config, self.config.kv_block_size, self.params, ids,
                                  seq_idx, pos, valid, tables, last_idx, pools[0], pools[1],
                                  modules=self._modules, **scales)

    def _upload(self, rb) -> torch.Tensor:
        return torch.from_numpy(rb.packed()).to(self.device)

    def put(self, batch_uids: List[int], batch_tokens: List[np.ndarray], do_checks: bool = True,
            sample: Optional[str] = None, block: bool = True):
        """Run one ragged forward. ``batch_tokens[i]`` are the new tokens of
        sequence ``batch_uids[i]`` (whole prompt or chunk for prefill, one
        token for decode). Returns last-token logits [len(batch_uids), vocab]
        or, with ``sample='greedy'``, the argmax token ids taken on the
        device. ``block=False`` returns the device tensor without waiting."""
        if sample not in (None, "greedy"):
            raise NotImplementedError(f"sample={sample!r}: only logits (None) and 'greedy' are "
                                      "ported to the PyTorch package yet")
        batch_uids = list(batch_uids)
        batch_tokens = [np.asarray(t, np.int32).reshape(-1) for t in batch_tokens]
        if any(t.size == 0 for t in batch_tokens):
            raise ValueError("put(): zero-length token chunk "
                             f"(uids {[u for u, t in zip(batch_uids, batch_tokens) if t.size == 0]})")
        if do_checks:
            result = self.can_schedule(batch_uids, [t.size for t in batch_tokens])
            if result is not SchedulingResult.Success:
                raise SchedulingError(result)

        self.batch.clear()
        descs = []
        for uid, toks in zip(batch_uids, batch_tokens):
            seq = self.state_manager.get_sequence(uid)
            if seq is None:
                seq, _ = self.state_manager.create_sequence_with_prefix(uid, toks)
            self.state_manager.allocate_blocks(seq, toks.size)
            seq.pre_forward(toks.size)
            self.batch.insert_sequence(seq, toks)
            descs.append(seq)
        rb = self.batch.finalize()
        logits = self._forward(self._upload(rb), rb.token_ids.shape[0], rb.block_tables.shape[0])
        for seq in descs:
            seq.post_forward()
        out = logits[:rb.n_seqs]
        if sample == "greedy":
            out = torch.argmax(out, dim=-1).to(torch.int32)
        return out.cpu().numpy() if block else out

    # ------------------------------------------------------------------
    def decode(self, batch_uids: List[int], first_tokens, n_steps: int, block: bool = True,
               eos_token_ids=None):
        """Run ``n_steps`` greedy decode steps for sequences already tracked
        by the engine, each step's argmax fed back as the next token on the
        device. KV blocks for the whole horizon are reserved up front.
        Returns token ids [len(batch_uids), n_steps].

        ``eos_token_ids`` (blocking mode only): a scalar, or a per-sequence
        list with ``None`` entries. A sequence that hits its eos mid-horizon
        has the KV materialized past the eos rolled back."""
        uids = list(batch_uids)
        S = len(uids)
        if len(set(uids)) != len(uids) or S > self.batch.max_seqs:
            raise SchedulingError(SchedulingResult.BatchSequenceLimitExceeded)
        first = [np.asarray(t, np.int32).reshape(-1) for t in first_tokens]
        if any(t.size != 1 for t in first):
            raise ValueError("decode() takes exactly one next token per sequence")
        seqs = []
        for uid in uids:
            seq = self.state_manager.get_sequence(uid)
            if seq is None:
                raise SchedulingError(SchedulingResult.EngineSequenceLimitExceeded)
            if seq.seen_tokens + n_steps > self._max_context:
                raise SchedulingError(SchedulingResult.KVCacheLimitExceeded)
            seqs.append(seq)
        if sum(s.blocks_needed(n_steps) for s in seqs) > self.state_manager.available_blocks:
            raise SchedulingError(SchedulingResult.KVCacheLimitExceeded)
        for seq in seqs:
            self.state_manager.allocate_blocks(seq, n_steps)
            seq.pre_forward(n_steps)
        self._decode_batch.clear()
        for seq, toks in zip(seqs, first):
            # tables cover the whole horizon; positions advance per step
            self._decode_batch.insert_sequence(seq, toks)
        rb = self._decode_batch.finalize()
        s_bucket = rb.token_ids.shape[0]
        packed = self._upload(rb)
        toks = packed[:s_bucket]
        out = torch.empty((s_bucket, n_steps), dtype=torch.int32, device=self.device)
        for t in range(n_steps):
            logits = self._forward(packed, s_bucket, s_bucket, token_ids=toks, pos_offset=t)
            toks = torch.argmax(logits, dim=-1).to(torch.int32)
            out[:, t] = toks
        out = out[:S]
        if not block:
            for seq in seqs:
                seq.post_forward()
            return out
        out = out.cpu().numpy()
        if eos_token_ids is None or isinstance(eos_token_ids, (int, np.integer)):
            eos_list = [eos_token_ids] * S
        else:
            eos_list = list(eos_token_ids)
            if len(eos_list) != S:
                raise ValueError("eos_token_ids must match batch_uids")
        for seq, row, eos in zip(seqs, out, eos_list):
            start = seq.seen_tokens
            seq.post_forward()
            if eos is not None:
                hit = np.nonzero(row == eos)[0]
                if hit.size and int(hit[0]) + 1 < n_steps:
                    # horizon overshoot: the caller keeps row[:hit+1]; the
                    # KV past the eos is garbage, so its blocks go back now
                    self.state_manager.rollback_to(seq, start + 1 + int(hit[0]))
        return out

    # ------------------------------------------------------------------
    def query(self, uid: Optional[int] = None):
        """Sequence / engine state introspection."""
        return self.state_manager.query(uid)

    def flush(self, uid: int) -> None:
        """Finish a sequence and release its KV blocks."""
        self.state_manager.flush_sequence(uid)

    def probe_prefix(self, prompt_tokens):
        """Pure prefix lookup: ``(n_cached_tokens, n_shared_full_blocks,
        n_tree_only, match)``. No prefix cache in this slice: never a hit."""
        return 0, 0, 0, None

    def acquire_prefix(self, uid: int, prompt_tokens, match=None) -> Tuple[int, int]:
        """Create the sequence for ``uid`` (the scheduler's admission entry).
        Returns ``(n_cached_tokens, n_shared_full_blocks)``: (0, 0) without a
        prefix cache. Roll back an abandoned acquisition with ``flush(uid)``."""
        self.state_manager.create_sequence_with_prefix(uid, prompt_tokens, match=match)
        return 0, 0

    @property
    def max_context(self) -> int:
        """Per-sequence context ceiling in tokens (prompt + generation)."""
        return self._max_context

    @property
    def free_blocks(self) -> int:
        return self.state_manager.free_blocks

    @property
    def available_blocks(self) -> int:
        return self.state_manager.available_blocks

"""Dynamic SplitFuse serving scheduler.

Counterpart of ``deepspeed_tpu/inference/v2/scheduler.py`` without the
speculative paths: every forward carries a bounded token budget filled with
all runnable DECODE steps first, then chunks of pending prefills, so long
prompts never stall decode latency. Admission reserves a request's whole
lifetime of KV blocks (prompt + max_new_tokens), so an admitted request can
always run to completion. When the queue drains to pure decode the loop
switches to the engine's multi-step ``decode`` (one host wait per horizon).
Nothing is dropped silently: un-runnable work raises with the stalled uids
named, and partial generations stay readable via ``results``.
"""

from typing import Dict, List, Optional

import numpy as np

from .scheduling_utils import SchedulingResult


class _Request:
    __slots__ = ("uid", "prompt", "max_new_tokens", "eos_token_id", "fed", "generated", "done",
                 "charged_blocks")

    def __init__(self, uid, prompt, max_new_tokens, eos_token_id):
        self.uid = uid
        self.prompt = np.asarray(prompt, np.int32).reshape(-1)
        self.max_new_tokens = int(max_new_tokens)
        self.eos_token_id = eos_token_id
        self.fed = 0  # prompt tokens already given to the engine
        self.generated: List[int] = []
        self.done = False
        self.charged_blocks = 0  # lifetime KV reservation charged at admission

    @property
    def prefilling(self) -> bool:
        return self.fed < self.prompt.size

    @property
    def total_tokens(self) -> int:
        return self.prompt.size + self.max_new_tokens


class DynamicSplitFuseScheduler:
    """Continuous-batching loop over :class:`InferenceEngineV2`.

    ``token_budget`` bounds the tokens per forward (clamped to the engine's
    ``max_ragged_batch_size``; must be positive). ``submit`` enqueues
    requests; ``step`` runs one composed forward; ``run`` drives to
    completion and returns ``{uid: generated token list}``."""

    DECODE_HORIZON = 32  # max device steps per multi-step decode call

    def __init__(self, engine, token_budget: Optional[int] = None):
        self.engine = engine
        if getattr(getattr(engine.config, "speculative", None), "enabled", False):
            raise NotImplementedError("speculative scheduling is not ported to the PyTorch "
                                      "package yet")
        sm = engine.config.state_manager
        if token_budget is None:
            token_budget = sm.max_ragged_batch_size
        if token_budget <= 0:
            raise ValueError(f"token_budget must be positive, got {token_budget}")
        self.token_budget = min(int(token_budget), sm.max_ragged_batch_size)
        self.max_seqs = sm.max_ragged_sequence_count
        self._pending: List[_Request] = []  # not yet tracked by the engine
        self._active: Dict[int, _Request] = {}
        self._results: Dict[int, List[int]] = {}
        self._reserved_blocks = 0  # KV blocks promised to active requests
        self.stats = {"prefill_tokens_fed": 0, "prefill_tokens_skipped": 0}

    def submit(self, uid: int, prompt, max_new_tokens: int = 32, eos_token_id=None):
        if uid in self._active or any(r.uid == uid for r in self._pending):
            raise ValueError(f"uid {uid} already queued")
        req = _Request(uid, prompt, max_new_tokens, eos_token_id)
        if req.prompt.size == 0:
            raise ValueError(f"uid {uid}: empty prompt")
        if req.max_new_tokens <= 0:
            raise ValueError(f"uid {uid}: max_new_tokens must be positive, "
                             f"got {req.max_new_tokens}")
        if req.total_tokens > self.engine.max_context:
            raise ValueError(f"uid {uid}: prompt {req.prompt.size} + max_new_tokens "
                             f"{req.max_new_tokens} exceeds the engine max_context "
                             f"{self.engine.max_context}")
        self._pending.append(req)

    @property
    def has_work(self) -> bool:
        return bool(self._pending or self._active)

    @property
    def finished(self):
        """Uids whose generation is complete (eos or max_new_tokens)."""
        return frozenset(self._results)

    @property
    def results(self) -> Dict[int, List[int]]:
        """Generations so far: finished requests complete, active partial."""
        out = dict(self._results)
        for uid, req in self._active.items():
            out[uid] = list(req.generated)
        return out

    def cancel(self, uid: int) -> bool:
        """Abort a request now: a pending one is dropped, an active one is
        finished in place (KV released, tokens so far kept in ``results``).
        Returns False for unknown uids."""
        for i, req in enumerate(self._pending):
            if req.uid == uid:
                self._pending.pop(i)
                self._results[uid] = req.generated
                return True
        req = self._active.get(uid)
        if req is None:
            return False
        self._finish(req)
        return True

    def _blocks_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.engine.config.kv_block_size)

    def _finish(self, req: _Request):
        req.done = True
        seq = self.engine.state_manager.get_sequence(req.uid)
        if seq is not None:
            # a decode horizon materializes KV past the last token an early-
            # finished (eos) or cancelled request keeps: rewind it first
            known = req.fed + max(0, len(req.generated) - 1)
            if seq.seen_tokens > known:
                self.engine.state_manager.rollback_to(seq, known, final=True)
        self.engine.flush(req.uid)
        self._reserved_blocks -= req.charged_blocks
        self._active.pop(req.uid, None)
        self._results[req.uid] = req.generated

    def _try_admit(self, req: _Request, batch_uids: List[int], batch_lengths: List[int],
                   budget: int) -> bool:
        """Admission reserves the request's WHOLE lifetime of KV blocks and
        validates CUMULATIVELY against the batch composed so far, so a
        combination that passes here is never refused by ``put``."""
        if len(batch_uids) >= self.max_seqs:
            return False
        sm = self.engine.config.state_manager
        if self.engine.state_manager.n_tracked_sequences >= sm.max_tracked_sequences:
            return False
        n_cached, shared, tree_only, match = self.engine.probe_prefix(req.prompt)
        need = self._blocks_for(req.total_tokens) - shared
        first = min(budget, req.prompt.size - n_cached)
        if first <= 0:
            return False
        supply = self.engine.available_blocks - tree_only + self._owned_blocks()
        if self._reserved_blocks + need > supply:
            return False
        if self.engine.can_schedule(batch_uids + [req.uid],
                                    batch_lengths + [first]) is not SchedulingResult.Success:
            return False
        n_cached, shared = self.engine.acquire_prefix(req.uid, req.prompt, match=match)
        req.fed = n_cached
        req.charged_blocks = self._blocks_for(req.total_tokens) - shared
        self._reserved_blocks += req.charged_blocks
        self.stats["prefill_tokens_skipped"] += n_cached
        self._active[req.uid] = req
        return True

    def _owned_blocks(self) -> int:
        """Blocks active sequences allocated themselves."""
        sm = self.engine.state_manager
        return sum(s.cur_allocated_blocks
                   for s in (sm.get_sequence(u) for u in self._active) if s is not None)

    def _append_token(self, req: _Request, tok: int) -> None:
        req.generated.append(tok)
        hit_eos = req.eos_token_id is not None and tok == req.eos_token_id
        if len(req.generated) >= req.max_new_tokens or hit_eos:
            self._finish(req)

    def _decode_burst(self, decoding: List[_Request]) -> int:
        """Pure-decode steady state: the engine's multi-step decode. The
        horizon quantizes DOWN to a power of two (1..32), as in the TPU
        package, so the streams match it step for step."""
        horizon = min(min(r.max_new_tokens - len(r.generated) for r in decoding),
                      self.DECODE_HORIZON)
        horizon = 1 << (horizon.bit_length() - 1)
        uids = [r.uid for r in decoding]
        first = [np.asarray([r.generated[-1]], np.int32) for r in decoding]
        eos = [r.eos_token_id for r in decoding]
        toks = np.asarray(self.engine.decode(uids, first, horizon, eos_token_ids=eos))
        for req, row in zip(decoding, toks):
            for tok in row.tolist():
                self._append_token(req, int(tok))
                if req.done:
                    break  # eos/max_new inside the burst: drop the tail
        return len(decoding) * horizon

    def step(self) -> int:
        """Compose and run ONE engine call: all runnable decodes first, then
        prefill chunks up to the token budget. Returns tokens processed
        (0 = nothing runnable)."""
        decoding = [r for r in self._active.values() if not r.prefilling and not r.done]
        prefilling = [r for r in self._active.values() if r.prefilling]
        if decoding and not prefilling and not self._pending and len(decoding) <= self.max_seqs:
            return self._decode_burst(decoding)

        uids: List[int] = []
        chunks: List[np.ndarray] = []
        budget = self.token_budget
        for req in decoding[:min(budget, self.max_seqs)]:
            uids.append(req.uid)
            chunks.append(np.asarray([req.generated[-1]], np.int32))
            budget -= 1

        def add_prefill(req):
            nonlocal budget
            if budget <= 0 or len(uids) >= self.max_seqs:
                return False
            take = min(budget, req.prompt.size - req.fed)
            uids.append(req.uid)
            chunks.append(req.prompt[req.fed:req.fed + take])
            req.fed += take
            budget -= take
            self.stats["prefill_tokens_fed"] += take
            return True

        for req in prefilling:
            add_prefill(req)
        # FIFO-preferred admission with head-of-line skip-ahead
        i = 0
        while i < len(self._pending) and budget > 0 and len(uids) < self.max_seqs:
            req = self._pending[i]
            if self._try_admit(req, uids, [c.size for c in chunks], budget):
                self._pending.pop(i)
                add_prefill(req)
            else:
                i += 1
        if not uids:
            return 0
        toks = self.engine.put(uids, chunks, sample="greedy")
        for uid, tok in zip(uids, np.asarray(toks).reshape(-1)):
            req = self._active[uid]
            if req.prefilling:
                continue  # mid-prompt chunk: the "next token" is still prompt
            self._append_token(req, int(tok))
        return sum(c.size for c in chunks)

    def run(self, max_steps: int = 100_000) -> Dict[int, List[int]]:
        """Drive to completion. Raises (partial generations kept in
        ``results``) if work remains but nothing is runnable."""
        steps = 0
        while self.has_work and steps < max_steps:
            if self.step() == 0:
                stalled = [r.uid for r in self._pending] + list(self._active)
                raise RuntimeError(f"scheduler stalled with unrunnable requests {stalled}: "
                                   "no pending request can be admitted (shrink them, raise "
                                   "the KV pool, or drain active work); partial generations "
                                   "remain in .results")
            steps += 1
        if self.has_work:
            raise RuntimeError(f"max_steps={max_steps} exhausted with work remaining "
                               f"({len(self._pending)} pending, {len(self._active)} active); "
                               "partial generations remain in .results")
        return dict(self._results)

"""Sampling for the ragged serving engine: temperature and top-p decoding.

Counterpart of ``deepspeed_tpu/inference/v2/sampling.py:38-151``.

* :class:`SamplingParams`: the per-request knobs (``temperature``,
  ``top_p``, ``seed``), validated once at submission. Temperature 0 is the
  exact greedy argmax, not a small-temperature limit.
* The draws, on the device with no host read. Each sampled row takes the
  Gumbel-max of its temperature-scaled, top-p-filtered logits: ``argmax(
  filtered + g)`` with ``g = -log(-log(u))``, which is distributed as the
  softmax of ``filtered``. The uniforms ``u`` are a counter-based hash of
  ``(seed, absolute position of the drawn token, vocabulary index)`` in
  torch integer ops, so a stream depends on the request's seed and the
  token's position only: never on the batch's composition or order, nor on
  whether ``put`` or a ``decode`` horizon drew it. The JAX package keys
  threefry the same way (``fold_in(PRNGKey(seed), position)``); the bits
  differ, the distribution and the determinism contract do not.
"""

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch


@dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling knobs. ``temperature == 0`` is exact greedy;
    ``top_p`` keeps the smallest nucleus whose mass reaches it (the top
    token always); ``seed`` keys the request's stream (None: derived from
    the request uid)."""

    temperature: float = 0.0
    top_p: float = 1.0
    seed: Optional[int] = None

    def validate(self) -> "SamplingParams":
        t = float(self.temperature)
        if not np.isfinite(t) or t < 0.0 or t > 100.0:
            raise ValueError(f"temperature must be in [0, 100], got {self.temperature!r}")
        p = float(self.top_p)
        if not np.isfinite(p) or not 0.0 < p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p!r}")
        if self.seed is not None:
            s = int(self.seed)
            if not -2**31 <= s < 2**31:
                raise ValueError(f"seed must fit int32, got {self.seed!r}")
        return self

    @property
    def greedy(self) -> bool:
        return float(self.temperature) <= 0.0


def pack_sampling(params: Sequence[Optional[SamplingParams]], uids: Sequence[int],
                  s_bucket: int):
    """Per-row knobs as float32 ``[s_bucket, 2]`` (temperature, top_p) and
    int32 ``[s_bucket]`` seeds. ``None`` entries are greedy rows
    (temperature 0); an unset seed derives from the uid."""
    f = np.zeros((s_bucket, 2), np.float32)
    f[:, 1] = 1.0
    seeds = np.zeros(s_bucket, np.int32)
    for i, (sp, uid) in enumerate(zip(params, uids)):
        if sp is None:
            continue
        f[i, 0] = float(sp.temperature)
        f[i, 1] = float(sp.top_p)
        seeds[i] = np.int32((int(uid) * 2654435761) & 0x7FFFFFFF) if sp.seed is None \
            else np.int32(int(sp.seed))
    return f, seeds


def all_greedy(params) -> bool:
    """True when no row needs a draw (no params, or every entry None or
    temperature 0): the caller keeps the argmax path."""
    return params is None or all(sp is None or sp.greedy for sp in params)


def pack_rows(params, uids, s_bucket: int, ctr0) -> np.ndarray:
    """Everything a sampled forward needs per row in ONE int32 vector (one
    upload): ``[temperature bits][top_p bits][seed][ctr0]``, each
    ``s_bucket`` long; ``ctr0`` is the position of the first token drawn."""
    f, seeds = pack_sampling(params, uids, s_bucket)
    ctr = np.zeros(s_bucket, np.int32)
    ctr[:len(ctr0)] = ctr0
    return np.concatenate([f[:, 0].view(np.int32), f[:, 1].view(np.int32), seeds, ctr])


def unpack_rows(packed: torch.Tensor, s_bucket: int):
    """Inverse of :func:`pack_rows` on the device: (temps, top_ps, seeds,
    ctr0), views of ``packed``."""
    S = s_bucket
    return (packed[:S].view(torch.float32), packed[S:2 * S].view(torch.float32),
            packed[2 * S:3 * S], packed[3 * S:4 * S])


# ---------------------------------------------------------------------------
# device-side draws
# ---------------------------------------------------------------------------

_MASK = 0xFFFFFFFF
_COLUMNS = {}  # (vocab, device) -> the column hashes, made once


def _mix32(x):
    """A 32-bit integer finalizer (two xorshift-multiply rounds; constants
    from the hash-prospector search): every input bit moves every output
    bit. ``x``: int64 in [0, 2^32). Both multipliers are below 2^31, so no
    int64 product overflows and the low 32 bits are exact."""
    x = x ^ (x >> 16)
    x = (x * 0x21F0AAAD) & _MASK
    x = x ^ (x >> 15)
    x = (x * 0x735A2D97) & _MASK
    return x ^ (x >> 15)


def unit_float(h):
    """32-bit hashes -> float32 in the open interval (0, 1): the top 23 bits
    and a half, over 2^23. Both ends are exact float32 values (1 - 2^-24 is
    the largest below 1), so ``-log(-log(u))`` is always finite; with 24
    bits the top value would round to 1.0 and the Gumbel noise to +inf."""
    return ((h >> 9).float() + 0.5) * (1.0 / (1 << 23))


def uniforms(seeds, ctrs, vocab: int):
    """``[S, vocab]`` float32 uniforms in (0, 1), a pure function of each
    row's ``(seed, ctr)`` and the column index."""
    key = (int(vocab), seeds.device)
    col = _COLUMNS.get(key)
    if col is None:
        col = _COLUMNS[key] = _mix32(torch.arange(vocab, device=seeds.device,
                                                  dtype=torch.int64) ^ 0x1B873593)
    k1 = _mix32(_mix32((seeds.long() & _MASK) ^ 0x2545F491) ^ (ctrs.long() & _MASK))
    k2 = _mix32(k1 ^ 0x5851F42D)
    return unit_float(_mix32(_mix32(col[None, :] ^ k1[:, None]) ^ k2[:, None]))


def filter_top_p(logits, top_p):
    """Mask ``logits`` (last axis = vocab) outside the smallest nucleus
    whose probability mass reaches ``top_p`` (broadcastable over the leading
    axes). A token is kept while the mass before it is below ``top_p``, so
    the top token always is; ties with the smallest kept value are kept."""
    sorted_l = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_l, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    top_p = torch.as_tensor(top_p, dtype=logits.dtype, device=logits.device)
    keep = (cum - probs) < top_p[..., None]
    kept_min = torch.where(keep, sorted_l, torch.full_like(sorted_l, float("inf")))
    kept_min = kept_min.amin(dim=-1, keepdim=True)
    return torch.where(logits >= kept_min, logits, torch.full_like(logits, float("-inf")))


def _filtered(logits, temps, top_ps):
    """Temperature-scaled, top-p-filtered fp32 logits; ``temps`` / ``top_ps``
    broadcast over the leading axes ([S] against [S, ..., V])."""
    extra = logits.dim() - 1 - temps.dim() + 1
    t = temps.reshape(tuple(temps.shape) + (1, ) * extra)
    p = top_ps.reshape(tuple(top_ps.shape) + (1, ) * (extra - 1))
    scaled = logits.float() / torch.clamp(t, min=1e-6)
    return filter_top_p(scaled, p)


def sample_tokens(logits, temps, top_ps, seeds, ctrs):
    """One token per row of ``logits [S, V]``: the argmax where
    ``temps <= 0``, else the Gumbel-max draw over the filtered distribution
    keyed by ``(seed, ctr)``, ctr the drawn token's absolute position.
    Device ops only. Returns int32 ``[S]``."""
    greedy = torch.argmax(logits, dim=-1)
    filt = _filtered(logits, temps, top_ps)
    g = -torch.log(-torch.log(uniforms(seeds, ctrs, logits.shape[-1])))
    sampled = torch.argmax(filt + g, dim=-1)
    return torch.where(temps <= 0.0, greedy, sampled).to(torch.int32)

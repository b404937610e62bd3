"""Token samplers and logit processors (``repro/sampling/samplers.py``).

Processors are (B, V) -> (B, V) functions composed by ``process_logits``.
A sampled token is ``argmax(processed + gumbel)``: the draw
``jax.random.categorical`` makes, with the Gumbel noise passed in. The
noise comes from a source object (``GumbelNoise`` by default), so a test
can hand the port the reference's own draws and compare tokens one for
one; ``noise=None`` makes the draw deterministic (``argmax(processed)``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.config import SamplingConfig

NEG_INF = -1e30


def apply_temperature(logits, temperature: float):
    return logits if temperature <= 0.0 else logits / temperature


def apply_top_k(logits, k: int):
    """Keep exactly the k highest logits per row; ties at the kth value go
    to the lower token ids (the reference's ``lax.top_k`` rule), so exactly
    k survive."""
    V = logits.shape[-1]
    if k <= 0 or k >= V:
        return logits
    flat = logits.reshape(-1, V)
    idx = torch.sort(flat, dim=-1, descending=True, stable=True).indices[:, :k]
    keep = torch.zeros_like(flat, dtype=torch.bool).scatter_(1, idx, True)
    return torch.where(keep.reshape(logits.shape), logits,
                       torch.full_like(logits, NEG_INF))


def apply_top_p(logits, p: float):
    if p >= 1.0 or p <= 0.0:
        return logits
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    cutoff_mask = cum - probs > p       # keep until the mass exceeds p
    cutoff = torch.where(cutoff_mask, torch.full_like(sorted_logits, np.inf),
                         sorted_logits).amin(dim=-1, keepdim=True)
    return torch.where(logits < cutoff, torch.full_like(logits, NEG_INF),
                       logits)


def apply_min_p(logits, min_p: float):
    if min_p <= 0.0:
        return logits
    probs = torch.softmax(logits, dim=-1)
    top = probs.amax(dim=-1, keepdim=True)
    return torch.where(probs < min_p * top, torch.full_like(logits, NEG_INF),
                       logits)


def apply_repetition_penalty(logits, token_counts, penalty: float):
    """HF-style: seen tokens' positive logits / penalty, negative ones
    * penalty. token_counts: (B, V) counts of emitted tokens."""
    if penalty == 1.0:
        return logits
    pen = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(token_counts > 0, pen, logits)


def process_logits(logits, cfg: SamplingConfig, token_counts=None,
                   bias=None):
    """Compose the processors in the reference's order. ``bias`` is the
    CAMD Eq. 16 mixture guidance ((B, V) additive logits)."""
    if token_counts is not None:
        logits = apply_repetition_penalty(logits, token_counts,
                                          cfg.repetition_penalty)
    if bias is not None:
        logits = logits + bias
    logits = apply_temperature(logits, cfg.temperature)
    logits = apply_top_k(logits, cfg.top_k)
    logits = apply_top_p(logits, cfg.top_p)
    return apply_min_p(logits, cfg.min_p)


def _draw(proc, noise):
    return torch.argmax(proc if noise is None else proc + noise, dim=-1)


def sample_token(logits, cfg: SamplingConfig, token_counts=None, bias=None,
                 greedy=None, noise=None):
    """Returns (token (B,) int64, logprob (B,)): the logprob of the chosen
    token under the processed distribution (S_gen, Eq. 7). ``greedy``:
    optional (B,) bool rows that take the raw argmax. ``noise``: (B, V)
    Gumbel draws, or None for a deterministic draw."""
    proc = process_logits(logits, cfg, token_counts, bias)
    logp = torch.log_softmax(proc, dim=-1)
    sampled = _draw(proc, noise)
    arg = torch.argmax(logits, dim=-1)
    if greedy is None:
        tok = sampled if cfg.temperature > 0 else arg
    else:
        tok = torch.where(greedy, arg, sampled)
    return tok, logp.gather(-1, tok[:, None])[:, 0]


def sample_token_batch(logits, cfg: SamplingConfig, bias=None, greedy=None,
                       noise=None):
    """n first tokens from ONE shared logits row (1, V) with n noise rows
    ``noise`` (n, V): processing runs once, only the draw is per row —
    identical per row to n ``sample_token`` calls. ``greedy``: optional
    (1,) bool. Returns (tokens (n,), logprobs (n,))."""
    proc = process_logits(logits, cfg, None, bias)            # (1, V)
    logp = torch.log_softmax(proc, dim=-1)[0]
    n = 1 if noise is None else noise.shape[0]
    sampled = _draw(proc.expand(n, -1), noise)
    arg = torch.argmax(logits, dim=-1).expand(n)
    if greedy is None:
        tok = sampled if cfg.temperature > 0 else arg
    else:
        tok = torch.where(greedy.expand(n), arg, sampled)
    return tok, logp[tok]


def gumbel(u):
    """Gumbel(0, 1) draws from uniforms in (0, 1)."""
    tiny = torch.finfo(u.dtype).tiny
    return -torch.log(-torch.log(torch.clamp(u, min=tiny)))


class GumbelNoise:
    """Default noise source: Gumbel draws from ``torch.Generator``s seeded
    by (seed, stream, counter) on the target device. Decode noise for
    global step t depends only on (seed, t) — the counterpart of
    ``decode_step_key`` (``samplers.py:88``) — so token streams do not
    depend on how many steps each macro launch covers. Admission noise
    (the first token of each candidate) follows its own counter."""

    def __init__(self, seed: int, device):
        self.seed = int(seed)
        self.device = torch.device(device)
        self._admissions = 0

    def _uniform(self, stream: int, counter: int, shape):
        s = np.random.SeedSequence([self.seed, stream, counter])
        g = torch.Generator(device=self.device)
        g.manual_seed(int(s.generate_state(1, np.uint64)[0] >> 1))
        return torch.rand(shape, generator=g, device=self.device)

    def first(self, n: int, vocab: int):
        """(n, V) noise for the first tokens of n admitted candidates."""
        self._admissions += 1
        return gumbel(self._uniform(0, self._admissions, (n, vocab)))

    def step(self, t: int, batch: int, vocab: int):
        """(B, V) noise for global decode step ``t``."""
        return gumbel(self._uniform(1, t, (batch, vocab)))

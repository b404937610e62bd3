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


def speculative_accept(logits, draft, cfg: SamplingConfig, *, token_counts,
                       bias, greedy, eos_id, n_tok, limit, active,
                       noise=None, uniform=None,
                       greedy_static: bool = False):
    """Accept a prefix of a drafted token block, the target distribution
    kept (Leviathan-style rejection against a deterministic draft;
    ``repro/sampling/samplers.py:149``).

    The verify forward fed ``[d_0, .., d_{K-1}]``: ``d_0`` the pending
    last token, ``d_1..`` = ``draft``; ``logits[:, i]`` is the target's
    next-token distribution after ``d_i``, and position i emits one token.
    Greedy rows take the raw argmax and go on while it equals the next
    draft. Sampled rows accept ``d_{i+1}`` when ``uniform[i] < p(d)``
    under the processed distribution, else draw from the residual (p with
    the draft masked) with the Gumbel row ``noise[i]``: the draws of
    global decode steps ``step0 + i`` a plain step would read (the
    all-greedy path takes neither). Emission stops after the first
    rejection, a missing draft (-1), EOS or the per-slot ``limit``; the
    repetition-penalty counts fold in the accepted prefix as it grows.

    logits: (B, K, V) fp32; draft: (B, K-1) int, -1 = none; noise:
    (K, B, V); uniform: (K, B). Returns (tokens (B, K), logps (B, K),
    emit (B, K) bool, counts (B, V), n_tok' (B,), stopped (B,)); tokens
    past the first non-emitting position are padding. ``greedy_static``
    (every row greedy) takes the vectorised prefix scan, with the same
    tokens and logprobs."""
    B, K, V = logits.shape
    if greedy_static:
        return _speculative_accept_greedy(
            logits, draft, cfg, token_counts=token_counts, bias=bias,
            eos_id=eos_id, n_tok=n_tok, limit=limit, active=active)
    cols = torch.arange(V, device=logits.device)
    none = torch.full((B,), -1, dtype=draft.dtype, device=draft.device)
    alive, counts, n = active, token_counts, n_tok
    stopped = torch.zeros_like(active)
    toks, lps, emits = [], [], []
    for i in range(K):
        lg = logits[:, i]
        proc = process_logits(lg, cfg, counts, bias)
        logp = torch.log_softmax(proc, dim=-1)
        arg = torch.argmax(lg, dim=-1)
        d = draft[:, i] if i < K - 1 else none
        has_d = d >= 0
        d_safe = d.clamp_min(0).long()
        # the residual reduces to the processed distribution where there
        # is no draft, which covers the block's last, free position too
        p_d = torch.softmax(proc, dim=-1).gather(1, d_safe[:, None])[:, 0]
        acc = has_d & (uniform[i] < p_d)
        drop = (cols[None, :] == d_safe[:, None]) & has_d[:, None]
        resampled = _draw(torch.where(drop, torch.full_like(proc, NEG_INF),
                                      proc), noise[i])
        tok = torch.where(greedy, arg, torch.where(acc, d_safe, resampled))
        lps.append(logp.gather(1, tok[:, None])[:, 0])
        cont = torch.where(greedy, has_d & (arg == d), acc)
        emit = alive
        n = n + emit.to(n.dtype)
        stop = emit & ((tok == eos_id) | (n >= limit))
        stopped = stopped | stop
        alive = alive & cont & ~stop
        counts = counts.scatter_add(1, tok[:, None],
                                    emit.to(counts.dtype)[:, None])
        toks.append(tok)
        emits.append(emit)
    return (torch.stack(toks, 1), torch.stack(lps, 1), torch.stack(emits, 1),
            counts, n, stopped)


def _speculative_accept_greedy(logits, draft, cfg: SamplingConfig, *,
                               token_counts, bias, eos_id, n_tok, limit,
                               active):
    """All-greedy ``speculative_accept`` as one prefix scan
    (``samplers.py:240``): greedy tokens are raw argmaxes, so the chain
    only decides where emission stops, and the counts at position i are
    ``counts0 + exclusive-cumsum(emitted one-hots)``."""
    B, K, V = logits.shape
    toks = torch.argmax(logits, dim=-1)                       # (B, K)
    d = torch.cat([draft.long(), toks.new_full((B, 1), -1)], dim=1)
    cont = (d >= 0) & (toks == d)
    pos_i = torch.arange(K, device=logits.device)[None, :]
    stop_cond = (toks == eos_id) | (n_tok[:, None] + pos_i + 1 >=
                                    limit[:, None])
    blocked = torch.cumsum((~(cont & ~stop_cond)).to(torch.int32), dim=1)
    emit = active[:, None] & torch.cat(
        [torch.ones_like(active)[:, None], blocked[:, :-1] == 0], dim=1)
    emitf = emit.to(token_counts.dtype)
    oh = torch.zeros((B, K, V), dtype=token_counts.dtype,
                     device=logits.device).scatter_(2, toks[..., None],
                                                    emitf[..., None])
    pre = torch.cumsum(oh, dim=1) - oh                        # exclusive
    proc = process_logits(logits, cfg, token_counts[:, None] + pre,
                          None if bias is None else bias[:, None])
    lps = torch.log_softmax(proc, dim=-1).gather(-1, toks[..., None])[..., 0]
    return (toks, lps, emit, token_counts + oh.sum(1),
            n_tok + emit.sum(1).to(n_tok.dtype), (emit & stop_cond).any(1))


def gumbel(u):
    """Gumbel(0, 1) draws from uniforms in (0, 1)."""
    tiny = torch.finfo(u.dtype).tiny
    return -torch.log(-torch.log(torch.clamp(u, min=tiny)))


class GumbelNoise:
    """Default noise source: Gumbel draws from ``torch.Generator``s seeded
    by (seed, stream, counter) on the target device. Decode noise for
    global step t (Gumbel rows, and a speculative step's acceptance
    uniforms) depends only on (seed, t) — the counterpart of
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

    def uniform(self, t: int, batch: int):
        """(B,) uniforms for the acceptance draws of global decode step
        ``t`` (speculative decoding), on a stream of their own."""
        return self._uniform(2, t, (batch,))

"""Synthetic data pipeline, a numpy copy of ``repro/data/synthetic.py``:
the same seed gives the same arrays.

``lm_batches`` produces a learnable autoregressive stream (arithmetic-chain
compositions mixed with token-copy spans) so the example scripts train a
~100M model whose loss actually falls. ``evidence_batch`` supplies the
stubbed modality-frontend embeddings for VLM/audio architectures.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np

# token layout inside the synthetic vocab:
#   0 PAD, 1 EOS, 2 BOS, 3 SEP, 4 QRY; digits start at OFF.
PAD, EOS, BOS, SEP, QRY = 0, 1, 2, 3, 4
OFF = 8


def _chain_example(rng: np.random.Generator, seq: int, base: int,
                   max_chain: int = 3) -> np.ndarray:
    """BOS x0 [op a1 op a2 ...] QRY answer SEP ... repeated to fill seq.

    Each link applies (x + a) mod base. chain_len=0 is pure copy (easy);
    longer chains are compositionally harder — the difficulty gradient the
    CAMD experiments rely on.
    """
    out = []
    while len(out) < seq + 1:
        k = int(rng.integers(0, max_chain + 1))
        x = int(rng.integers(0, base))
        toks = [BOS, OFF + x]
        for _ in range(k):
            a = int(rng.integers(0, base))
            toks.append(OFF + base + a)       # operand tokens live in a 2nd band
            x = (x + a) % base
        toks += [QRY, OFF + x, SEP]
        out.extend(toks)
    return np.asarray(out[:seq + 1], np.int32)


def _copy_example(rng: np.random.Generator, seq: int, vocab: int) -> np.ndarray:
    span = rng.integers(OFF, vocab, size=max(seq // 4, 4))
    reps = int(np.ceil((seq + 1) / len(span)))
    return np.tile(span, reps)[:seq + 1].astype(np.int32)


def lm_batches(vocab: int, batch: int, seq: int, *, seed: int = 0,
               base: Optional[int] = None, max_chain: int = 3,
               evidence: Optional[Dict] = None) -> Iterator[Dict]:
    """Infinite iterator of {tokens, labels(, evidence)} numpy batches."""
    rng = np.random.default_rng(seed)
    base = base or min(32, (vocab - OFF) // 2)
    while True:
        rows = []
        for b in range(batch):
            if rng.random() < 0.7:
                rows.append(_chain_example(rng, seq, base, max_chain))
            else:
                rows.append(_copy_example(rng, seq, vocab))
        arr = np.stack(rows)
        out = {"tokens": arr[:, :-1], "labels": arr[:, 1:]}
        if evidence is not None:
            out["evidence"] = evidence_batch(
                rng, batch, evidence["num_tokens"], evidence["dim"])
        yield out


def evidence_batch(rng: np.random.Generator, batch: int, num_tokens: int,
                   dim: int) -> np.ndarray:
    """Stub modality frontend: unit-norm 'patch/frame' embeddings."""
    ev = rng.standard_normal((batch, num_tokens, dim)).astype(np.float32)
    return ev / (np.linalg.norm(ev, axis=-1, keepdims=True) + 1e-8)

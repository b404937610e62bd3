"""Oracle tasks for validating the paper's claims without proprietary
benchmarks, a numpy copy of ``repro/data/tasks.py``: the same seed gives
the same arrays.

``ChainTask``      — model-in-the-loop: arithmetic-chain VQA-style prompts
                     whose compositional depth controls real per-trial
                     success probability; answers are oracle-checkable.
``SimulatedDecoder`` — pure simulation: instances draw a per-trial success
                     probability s ~ G (heavy / stretched / light tail per
                     Theorem 4.2) and candidates are correct w.p. s. This
                     reproduces the paper's Fig. 2 / Fig. 4 sweeps at scale
                     (thousands of instances) at negligible cost.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.data.synthetic import BOS, OFF, QRY, SEP


@dataclasses.dataclass
class ChainTask:
    """Arithmetic-chain QA with oracle answers."""
    base: int = 32
    max_chain: int = 8

    def sample(self, rng: np.random.Generator, chain_len: Optional[int] = None
               ) -> Tuple[np.ndarray, int, int]:
        """Returns (prompt tokens ending in QRY, answer_token, chain_len).
        chain_len=0 is a pure copy (easy)."""
        k = chain_len if chain_len is not None \
            else int(rng.integers(0, self.max_chain + 1))
        x = int(rng.integers(0, self.base))
        toks = [BOS, OFF + x]
        for _ in range(k):
            a = int(rng.integers(0, self.base))
            toks.append(OFF + self.base + a)
            x = (x + a) % self.base
        toks.append(QRY)
        return np.asarray(toks, np.int32), OFF + x, k

    def check(self, prompt: np.ndarray, generated: np.ndarray) -> bool:
        """Oracle: first generated token must be the chain result."""
        x = int(prompt[1]) - OFF
        for t in prompt[2:-1]:
            x = (x + (int(t) - OFF - self.base)) % self.base
        return len(generated) > 0 and int(generated[0]) == OFF + x


class SimulatedDecoder:
    """Simulates the (MLLM + sampler) pair as seen by CAMD.

    Per instance i: s_i ~ G (tail class configurable). Each trial emits a
    candidate that is correct w.p. s_i; wrong candidates pick one of
    ``n_wrong`` failure modes with Zipf weights (hard instances have
    *consistent* wrong modes — the regime where self-consistency fails and
    evidence-weighted scoring matters). Observable score = evidence quality
    correlated with correctness via ``score_gap``; embeddings cluster by
    emitted answer.
    """

    def __init__(self, *, tail: str = "heavy", alpha: float = 0.5,
                 n_wrong: int = 6, emb_dim: int = 16, score_gap: float = 1.0,
                 score_noise: float = 0.5, tokens_per_sample: int = 64,
                 seed: int = 0):
        self.tail, self.alpha = tail, alpha
        self.n_wrong = n_wrong
        self.emb_dim = emb_dim
        self.score_gap = score_gap
        self.score_noise = score_noise
        self.tokens_per_sample = tokens_per_sample
        self.rng = np.random.default_rng(seed)
        # answer prototypes in embedding space: index 0 = correct answer
        self._proto = self.rng.standard_normal((n_wrong + 1, emb_dim))
        self._proto /= np.linalg.norm(self._proto, axis=-1, keepdims=True)

    def sample_difficulty(self, n: int) -> np.ndarray:
        u = self.rng.uniform(1e-12, 1.0, size=n)
        if self.tail == "heavy":
            return u ** (1.0 / self.alpha)
        if self.tail == "stretched":
            z = np.exp(-1.0)
            return np.clip((-np.log(u * z)) ** -1.0, 0.0, 1.0)
        if self.tail == "light":
            return 0.2 + 0.7 * u
        raise ValueError(self.tail)

    def trial(self, s: float, k: int = 1) -> Dict[str, np.ndarray]:
        """k candidates for an instance of difficulty s."""
        correct = self.rng.random(k) < s
        wrong_mode = 1 + self.rng.zipf(2.0, size=k).clip(1, self.n_wrong) - 1
        answer = np.where(correct, 0, wrong_mode)
        emb = self._proto[answer] + 0.05 * self.rng.standard_normal(
            (k, self.emb_dim))
        score = (self.score_gap * correct.astype(np.float64)
                 + self.score_noise * self.rng.standard_normal(k))
        lengths = np.full(k, self.tokens_per_sample, np.int32)
        return {"correct": correct, "answer": answer, "emb": emb,
                "score": score, "lengths": lengths}

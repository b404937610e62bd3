"""Traffic-level scheduling policies for the serving engine (numpy only).

The port's copy of ``repro/serving/scheduler.py``, chunked-prefill
ordering (``prefill_order``) and the per-shard admission telemetry of
mesh serving (``admitted_per_shard``) included.

CAMD's compute-allocation logic (more samples for hard instances, fewer
for easy) historically lived only *inside* a request — the round-based
coverage stop in ``core.controller``. Across requests, admission was
plain FIFO slot-filling, so under multi-request traffic easy requests
hog decode slots while the heavy tail queues: exactly the
compute-difficulty mismatch the paper exists to fix.

This module lifts coverage-awareness to the traffic level. The engine
delegates every admission decision (which queued request gets free
slots, which pending round runs next, how many candidates, and each
candidate's token limit) to a ``Scheduler``:

``fifo``
    The seam policy: reproduces the pre-refactor engine loop decision
    for decision, so its token streams are bit-identical to the
    pre-scheduler engine (pinned by the differential test suite).

``coverage``
    Between macro-step launches, ranks pending work by posterior
    coverage deficit ``max(0, (1 - delta) - p_star)`` plus the expected
    marginal gain of one more round (``posterior.expected_improvement_
    stop``'s EI, the paper's rule (iii)), ages queued work so nothing
    starves, and declines rounds whose expected gain no longer pays for
    their tokens. With a ``global_budget`` it enforces a *stream-wide*
    token budget by worst-case commitment accounting: a candidate is
    only admitted with a per-candidate token ``limit`` the remaining
    budget can cover, so the budget is a hard invariant, not advisory.

Both policies speak to the engine through the small ``SchedulerContext``
facade, so they are unit-testable against fakes (see
``tests/test_scheduler_properties.py``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class NewWork:
    """A prefilled queued request awaiting first admission.

    ``prompt_len`` and ``evidence_entropy`` are difficulty *priors*: a
    new request has no posterior yet (no candidates, no p_star), so the
    coverage policy ranks unobserved work by what the prompt alone
    reveals — longer prompts carry more conditioning to satisfy, and a
    diffuse prompt-to-evidence attachment (high normalized entropy of
    the token-evidence alignment) marks grounding ambiguity. Both
    default to 0 so fakes and non-coverage policies are unaffected."""
    uid: int
    arrival: int                 # submit order (FIFO tiebreak)
    want: int                    # candidates the mode wants per round
    prompt_len: int = 0          # tokens in the prompt (difficulty prior)
    evidence_entropy: float = 0.0  # normalized [0,1] alignment entropy


@dataclasses.dataclass
class PrefillWork:
    """A queued request mid chunked prefill (or awaiting its first
    chunk). The engine asks the policy to order these each turn; the
    chunk-token budget goes to the top-ranked jobs first."""
    uid: int
    arrival: int                 # submit order (FIFO tiebreak)
    prompt_len: int              # total prompt tokens
    prefilled: int = 0           # chunk tokens already in the page pool
    evidence_entropy: float = 0.0


@dataclasses.dataclass
class RoundWork:
    """A request whose last round completed and wants another."""
    uid: int
    arrival: int
    want: int
    rounds: int                  # rounds already completed
    p_star: float                # latest posterior coverage estimate
    delta: float                 # target residual risk (1 - coverage)
    best_score: float
    scores: List[float]          # all candidate scores seen so far
    mean_len: float              # mean tokens per finished candidate


class SchedulerContext:
    """What a policy may observe and do. The engine implements this
    (``_EngineSchedContext``); property tests implement fakes.

    Under mesh serving (``num_shards > 1``) slots and KV pages are
    partitioned across data shards: slot ``s`` lives on shard
    ``s // (slots / num_shards)`` and only that shard's pages back it.
    Policies stay shard-oblivious: ``affordable`` is the shard-local
    capacity gate (the engine walks the free slots an admission of
    ``want`` candidates would take, in the order ``admit_*`` assigns
    them, and counts the longest prefix each slot's own shard can
    fund)."""

    max_new: int
    num_shards: int = 1

    def free_slots(self) -> int:
        raise NotImplementedError

    def queued_new(self) -> List[NewWork]:
        """Prefilled queued requests, arrival order."""
        raise NotImplementedError

    def pending_rounds(self) -> List[RoundWork]:
        """Requests with ``pending_round`` set, table order."""
        raise NotImplementedError

    def affordable(self, uid: int, want: int, limit: int) -> int:
        """Paged-pool admission gate (non-paged engines: ``want``)."""
        raise NotImplementedError

    def admit_new(self, uid: int, take: int, limit: int) -> None:
        raise NotImplementedError

    def admit_round(self, uid: int, take: int, limit: int) -> None:
        raise NotImplementedError

    def finish_request(self, uid: int) -> None:
        """Finalize a request with the candidates it already has
        (coverage policy's EI-decline)."""
        raise NotImplementedError


class Scheduler:
    """Base: worst-case token-budget accounting shared by all policies.

    ``committed`` is the sum of live candidates' token *limits* (the
    most they can still emit); ``spent`` is what finished candidates
    actually emitted. Admission only proceeds when
    ``spent + committed + take * limit <= global_budget``, and a
    finished candidate releases its whole limit, so

        spent <= global_budget            (the stream-wide invariant)

    holds at every instant — an early-stopped easy candidate's unspent
    commitment immediately funds queued work. ``global_budget=0``
    disables budgeting entirely (the bit-identity configuration).

    Speculative decoding does not change this accounting: a slot may
    *verify* up to spec_k tokens per device step, but the device-side
    limit check truncates emission at exactly the granted ``limit``
    (over-drafted tokens past the limit are discarded before they
    count), and frontier staging for the wider per-launch advance is
    capped at the slot's own commitment. The worst case the admission
    check reserves against — ``limit`` emitted tokens per candidate —
    is therefore identical with speculation on or off.
    """

    name = "base"

    def __init__(self, *, global_budget: int = 0):
        self.global_budget = int(global_budget)
        self.committed = 0
        self.spent = 0
        self.admitted_candidates = 0
        self.declined_rounds = 0
        self.cancelled_candidates = 0
        # mesh serving: admitted candidates by the data shard of their
        # slot, so that skewed placement shows without a device readback
        self.admitted_per_shard: Dict[int, int] = {}

    # -- budget ---------------------------------------------------------
    def remaining(self) -> Optional[int]:
        if not self.global_budget:
            return None
        return self.global_budget - self.spent - self.committed

    def grant(self, want: int, max_new: int) -> Tuple[int, int]:
        """Largest (take, per-candidate limit) the budget covers.

        Limits are never granted below 2: a candidate emits one token at
        admission and at least one decode step runs before the on-device
        limit check, so ``limit=1`` would overshoot its commitment."""
        if not self.global_budget:
            return want, max_new
        rem = self.remaining()
        if want <= 0 or rem < 2:
            return 0, 0
        take = min(want, rem // 2)            # >= 2 tokens per candidate
        limit = min(max_new, rem // take)
        return take, limit

    def commit(self, take: int, limit: int):
        self.committed += take * limit
        self.admitted_candidates += take

    def on_finish(self, uid: int, n_tokens: int, limit: int):
        """A candidate finished having emitted ``n_tokens <= limit``."""
        self.committed -= limit
        self.spent += n_tokens
        assert self.committed >= 0, (uid, n_tokens, limit)

    def on_cancel(self, uid: int, n_tokens: int, limit: int):
        """A live candidate was aborted mid-flight: its worst-case
        commitment is refunded exactly like a finish, and the tokens it
        did emit count as spent — the compute is burned either way, so
        the ``spent <= global_budget`` invariant is unchanged."""
        self.on_finish(uid, n_tokens, limit)
        self.cancelled_candidates += 1

    def reset_stats(self) -> None:
        """Zero telemetry counters for engine reuse across bench cells.

        Budget LEDGERS (``spent``/``committed``) are accounting state —
        resetting them would let a reused engine overspend its stream
        budget — so they survive; only observability counters reset."""
        self.admitted_candidates = 0
        self.declined_rounds = 0
        self.cancelled_candidates = 0
        self.admitted_per_shard = {}

    def note_shard_admission(self, shards) -> None:
        """Engine callback: one entry per admitted candidate, the data
        shard of the slot it landed on."""
        for s in shards:
            self.admitted_per_shard[int(s)] = \
                self.admitted_per_shard.get(int(s), 0) + 1

    def exhausted(self) -> bool:
        """No admission can ever be funded again (terminal-drain check:
        only meaningful when nothing is live, i.e. committed == 0).
        Mirrors ``grant``'s minimum viable grant of 2 tokens."""
        rem = self.remaining()
        return rem is not None and rem < 2

    def stats(self) -> Dict[str, float]:
        s = {
            "policy": self.name,
            "global_budget": self.global_budget,
            "spent": self.spent,
            "committed": self.committed,
            "admitted_candidates": self.admitted_candidates,
            "declined_rounds": self.declined_rounds,
            "cancelled_candidates": self.cancelled_candidates,
        }
        if self.admitted_per_shard:
            s["admitted_per_shard"] = {
                str(k): v for k, v in sorted(self.admitted_per_shard.items())}
        return s

    # -- policy ---------------------------------------------------------
    def schedule(self, ctx: SchedulerContext) -> None:
        raise NotImplementedError

    def prefill_order(self, items: List[PrefillWork]) -> List[PrefillWork]:
        """Order chunked-prefill jobs for the per-turn chunk-token budget.
        Base/fifo: arrival order, so the head-of-line request's prefill
        completes first and fifo's admission order (and token streams)
        match the unchunked engine's."""
        return sorted(items, key=lambda w: w.arrival)


class FifoScheduler(Scheduler):
    """The pre-refactor engine loop, verbatim: queued requests first (in
    arrival order, head-of-line blocking on paged backpressure), then
    pending rounds in request-table order. With ``global_budget=0`` the
    decisions — and therefore the token streams — are bit-identical to
    the pre-scheduler engine."""

    name = "fifo"

    def schedule(self, ctx: SchedulerContext) -> None:
        while ctx.free_slots() > 0:
            queued = ctx.queued_new()
            if not queued:
                break
            head = queued[0]
            take = min(head.want, ctx.free_slots())
            take, limit = self.grant(take, ctx.max_new)
            if take > 0:
                take = ctx.affordable(head.uid, take, limit)
            if take <= 0:
                break                      # wait, keep queue order
            self.commit(take, limit)
            ctx.admit_new(head.uid, take, limit)
        for item in ctx.pending_rounds():
            if ctx.free_slots() <= 0:
                break
            take = min(item.want, ctx.free_slots())
            take, limit = self.grant(take, ctx.max_new)
            if take > 0:
                take = ctx.affordable(item.uid, take, limit)
            if take <= 0:
                continue
            self.commit(take, limit)
            ctx.admit_round(item.uid, take, limit)


class CoverageScheduler(Scheduler):
    """Coverage-aware continuous batching.

    Priority of a pending round = coverage deficit + EI of one more
    sample + aging; priority of a new request = ``new_request_priority``
    + ``difficulty_weight`` * difficulty-prior + aging, where the prior
    ranks *unobserved* requests by prompt length and evidence-alignment
    entropy (see ``NewWork``/``_difficulty``) instead of sharing one
    flat prior. The default puts new requests above any continuing round
    (deficit <= 1 and EI is clamped to 1): a request's FIRST round buys
    far more residual-risk reduction than a hard request's n-th, so
    under budget pressure breadth beats depth — the saved depth comes
    from declining low-gain rounds, not from starving the queue. Aging
    grows without bound with every pass an item is skipped, so every
    queued item is eventually the top-priority item — the no-starvation
    guarantee the property suite pins down.

    Rounds whose expected marginal gain no longer pays for their tokens
    (``posterior.expected_improvement_stop``, the paper's rule (iii))
    are *declined*: the request finalizes with the candidates it has,
    and the tokens it would have burned fund the heavy tail instead.

    Under a global budget the policy also **fair-shares width**: when the
    remaining budget cannot fund a full-width round for every pending
    work item, per-item candidate counts shrink (down to 1) so the
    budget covers *every* request shallowly rather than the queue prefix
    deeply — residual risk concentrates in unserved requests far more
    than in narrow rounds. This is the traffic-level analogue of the
    paper's coverage argument and is what beats FIFO at equal budget on
    heavy-tailed traffic (see ``benchmarks/bench_serve.py``).
    """

    name = "coverage"

    def __init__(self, *, global_budget: int = 0, aging_rate: float = 0.25,
                 new_request_priority: float = 2.5, ei_weight: float = 1.0,
                 ei_cost_per_token: float = 1e-4, min_rounds: int = 1,
                 decline_low_gain: bool = True,
                 difficulty_weight: float = 0.5,
                 difficulty_len_scale: float = 64.0):
        super().__init__(global_budget=global_budget)
        self.aging_rate = aging_rate
        self.new_request_priority = new_request_priority
        self.ei_weight = ei_weight
        self.ei_cost_per_token = ei_cost_per_token
        self.min_rounds = min_rounds
        self.decline_low_gain = decline_low_gain
        self.difficulty_weight = difficulty_weight
        self.difficulty_len_scale = difficulty_len_scale
        self._wait: Dict[Tuple[str, int], int] = {}
        self.max_wait_seen = 0

    # -- priorities -----------------------------------------------------
    def _ei(self, item: RoundWork) -> Tuple[float, bool]:
        """Expected improvement of one more sample and whether the
        paper's rule-(iii) stop (EI below its token cost) triggers.

        Closed-form host-float mirror of
        ``posterior.expected_improvement_stop`` (normal approximation of
        the score distribution) — this runs between every macro-step
        launch, so it must not pay per-call jax dispatch."""
        scores = np.asarray(item.scores, np.float64)
        if scores.size < 2:
            return 1.0, False              # too little evidence to stop
        std = max(float(scores.std()), 1e-6)
        z = (float(scores.mean()) - item.best_score) / std
        phi = math.exp(-0.5 * z * z) / math.sqrt(2.0 * math.pi)
        Phi = 0.5 * (1.0 + math.erf(z / math.sqrt(2.0)))
        ei = std * (z * Phi + phi)
        stop = ei < self.ei_cost_per_token * max(item.mean_len, 1.0)
        return ei, stop

    def _difficulty(self, w: NewWork) -> float:
        """Prompt-level difficulty prior in [0, 1) for *unobserved*
        requests (no posterior yet). Saturating prompt-length term —
        ``len_scale`` tokens is the half-difficulty point — averaged
        with the normalized evidence-alignment entropy computed at
        prefill (0 for text-only requests). Harder ranks first: a hard
        request's first round buys more residual-risk reduction, and
        admitting it early gives its later rounds time inside the same
        budget window."""
        lp = w.prompt_len / (w.prompt_len + self.difficulty_len_scale) \
            if w.prompt_len > 0 else 0.0
        ent = min(max(w.evidence_entropy, 0.0), 1.0)
        return 0.5 * (lp + ent)

    def _priority(self, kind: str, item, ei: float = 0.0) -> float:
        wait = self._wait.get((kind, item.uid), 0)
        age = self.aging_rate * wait
        if kind == "new":
            return self.new_request_priority \
                + self.difficulty_weight * self._difficulty(item) + age
        deficit = max(0.0, (1.0 - item.delta) - item.p_star)
        return deficit + self.ei_weight * min(ei, 1.0) + age

    # -- policy ---------------------------------------------------------
    def schedule(self, ctx: SchedulerContext) -> None:
        items: List[Tuple[str, object, float]] = []
        for w in ctx.queued_new():
            items.append(("new", w, self._priority("new", w)))
        for r in ctx.pending_rounds():
            ei, stop = self._ei(r)
            if self.decline_low_gain and r.rounds >= self.min_rounds \
                    and stop:
                self.declined_rounds += 1
                self._wait.pop(("round", r.uid), None)
                ctx.finish_request(r.uid)
                continue
            items.append(("round", r, self._priority("round", r, ei)))
        items.sort(key=lambda t: (-t[2], t[1].arrival))
        left = len(items)
        for kind, w, _prio in items:
            key = (kind, w.uid)
            if ctx.free_slots() <= 0:
                self._bump(key)
                continue
            take = min(w.want, ctx.free_slots())
            rem = self.remaining()
            share = None
            if rem is not None:
                # fair-share width AND depth: don't let this item's round
                # starve the items behind it of even a shallow round —
                # cap its candidate count and its per-candidate token
                # limit to this item's share of the remaining budget
                fair = max(1, rem // max(left * ctx.max_new, 1))
                take = min(take, fair)
                share = max(2, rem // max(left, 1))
            left -= 1
            take, limit = self.grant(take, ctx.max_new)
            if share is not None and take > 0:
                limit = max(2, min(limit, share // take))
            if take > 0:
                take = ctx.affordable(w.uid, take, limit)
            if take <= 0:
                self._bump(key)
                continue
            self._wait.pop(key, None)
            self.commit(take, limit)
            if kind == "new":
                ctx.admit_new(w.uid, take, limit)
            else:
                ctx.admit_round(w.uid, take, limit)

    def prefill_order(self, items: List[PrefillWork]) -> List[PrefillWork]:
        """Coverage ranking of partially prefilled work: the difficulty
        prior plus prefill progress, so a nearly complete prefill finishes
        ahead of a barely started one of equal difficulty. Arrival breaks
        ties."""
        def rank(w: PrefillWork) -> float:
            progress = w.prefilled / w.prompt_len if w.prompt_len else 0.0
            return self.difficulty_weight * self._difficulty(w) + progress

        return sorted(items, key=lambda w: (-rank(w), w.arrival))

    def _bump(self, key):
        self._wait[key] = self._wait.get(key, 0) + 1
        self.max_wait_seen = max(self.max_wait_seen, self._wait[key])

    def reset_stats(self) -> None:
        super().reset_stats()
        # the aging state (_wait) is POLICY state, not telemetry — the
        # no-starvation guarantee must survive a stats reset
        self.max_wait_seen = 0

    def stats(self) -> Dict[str, float]:
        s = super().stats()
        s["max_wait_seen"] = self.max_wait_seen
        return s


POLICIES = {"fifo": FifoScheduler, "coverage": CoverageScheduler}


def make_scheduler(policy, *, global_budget: int = 0, **kw) -> Scheduler:
    """``policy`` is a name from ``POLICIES`` or an instance (tests)."""
    if isinstance(policy, Scheduler):
        return policy
    if policy not in POLICIES:
        raise ValueError(f"unknown scheduler policy {policy!r}; "
                         f"choose from {sorted(POLICIES)}")
    return POLICIES[policy](global_budget=global_budget, **kw)

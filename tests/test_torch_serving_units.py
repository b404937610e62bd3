"""The port's numpy copies of the page pool and the traffic schedulers,
held against the JAX package's originals.

Both are pure host code, so the same random operation sequences go
through both implementations: the port's single-shard pool without a
prefix cache must hand out the same page ids and keep the same counts as
the reference pool, and the fifo and coverage schedulers must make the
same admission decisions on the same simulated traffic.
"""
import numpy as np
import pytest

pytest.importorskip("hypothesis")
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.serving import page_pool as jpool
from repro.serving import scheduler as jsched
from repro_torch.serving import page_pool as tpool
from repro_torch.serving import scheduler as tsched
from torch_ranks import _one_torch_thread  # noqa: F401

OPS = st.lists(st.tuples(st.sampled_from(["alloc", "share", "free",
                                          "stage", "return"]),
                         st.integers(0, 5)), min_size=1, max_size=60)


@settings(max_examples=60, deadline=None)
@given(ops=OPS, num_pages=st.integers(2, 24))
def test_page_pool_copy_matches_reference(ops, num_pages):
    ref, port = jpool.PagePool(num_pages, 4), tpool.PagePool(num_pages, 4)
    held, staged = [], []          # the same holds on both pools
    for op, n in ops:
        if op in ("alloc", "stage"):
            fn = "alloc" if op == "alloc" else "stage_frontier"
            try:
                a = getattr(ref, fn)(n)
            except jpool.PagePoolError:
                with pytest.raises(tpool.PagePoolError):
                    getattr(port, fn)(n)
                continue
            assert getattr(port, fn)(n) == a
            (held if op == "alloc" else staged).extend(a)
        elif op == "share" and held:
            pages = held[:n + 1]
            ref.share(pages)
            port.share(pages)
            held.extend(pages)
        elif op == "free" and held:
            pages, held[:] = held[:n + 1], held[n + 1:]
            ref.free(pages)
            port.free(pages)
        elif op == "return" and staged:
            pages, staged[:] = staged[:n + 1], staged[n + 1:]
            ref.return_frontier(pages)
            port.return_frontier(pages)
        ref.check()
        port.check()
        for key in ("in_use", "free", "max_in_use", "frontier_staged",
                    "frontier_returned", "frontier_peak_stage"):
            assert port.stats()[key] == ref.stats()[key], key


class FakeEngine:
    """Model-free slots, queue and rounds, driven only by the scheduler's
    decisions (so two schedulers that decide alike log alike)."""

    def __init__(self, mod, seed, *, slots, n_reqs, want, rounds, cap):
        self.mod, self.rng = mod, np.random.default_rng(seed)
        self.max_new, self.free, self.cap = 8, slots, cap
        self.queue = [mod.NewWork(uid=i, arrival=i, want=want,
                                  prompt_len=int(self.rng.integers(1, 99)))
                      for i in range(n_reqs)]
        self.rounds_left = {i: rounds[i % len(rounds)]
                            for i in range(n_reqs)}
        self.pending, self.live, self.log = {}, [], []
        self.scores = {i: [] for i in range(n_reqs)}

    def free_slots(self):
        return self.free

    def queued_new(self):
        return list(self.queue)

    def pending_rounds(self):
        return list(self.pending.values())

    def affordable(self, uid, want, limit):
        return want if self.cap is None else min(want, self.cap)

    def _spawn(self, kind, uid, take, limit):
        self.free -= take
        self.log.append((kind, uid, take, limit))
        self.live += [(uid, int(self.rng.integers(1, limit + 1)), limit)
                      for _ in range(take)]

    def admit_new(self, uid, take, limit):
        self.queue = [w for w in self.queue if w.uid != uid]
        self._spawn("new", uid, take, limit)

    def admit_round(self, uid, take, limit):
        self.pending.pop(uid)
        self._spawn("round", uid, take, limit)

    def finish_request(self, uid):
        self.log.append(("finish", uid))
        self.pending.pop(uid, None)

    def drain(self, sched):
        """Finish every live candidate, then open the next rounds."""
        for uid, n, limit in self.live:
            sched.on_finish(uid, n, limit)
            self.free += 1
            self.scores[uid].append(float(self.rng.normal()))
        done = {uid for uid, _, _ in self.live}
        self.live = []
        for uid in sorted(done):
            self.rounds_left[uid] -= 1
            if self.rounds_left[uid] > 0:
                s = self.scores[uid]
                self.pending[uid] = self.mod.RoundWork(
                    uid=uid, arrival=uid, want=2,
                    rounds=len(s), p_star=float(self.rng.random()),
                    delta=0.05, best_score=max(s), scores=list(s),
                    mean_len=4.0)


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 10_000), policy=st.sampled_from(
    ["fifo", "coverage"]), slots=st.integers(1, 6),
    n_reqs=st.integers(1, 6), budget=st.sampled_from([0, 20, 60]),
    cap=st.sampled_from([None, 1, 3]),
    rounds=st.lists(st.integers(1, 3), min_size=1, max_size=4))
def test_schedulers_copy_decide_as_reference(seed, policy, slots, n_reqs,
                                              budget, cap, rounds):
    sims = []
    for mod in (jsched, tsched):
        sched = mod.make_scheduler(policy, global_budget=budget)
        eng = FakeEngine(mod, seed, slots=slots, n_reqs=n_reqs, want=2,
                         rounds=rounds, cap=cap)
        for _ in range(12):
            sched.schedule(eng)
            eng.drain(sched)
        assert budget == 0 or sched.spent <= budget
        sims.append((eng.log, sched.spent, sched.committed,
                     sched.admitted_candidates, sched.declined_rounds))
    assert sims[0] == sims[1]

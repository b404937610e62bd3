"""Shard-local admission under pool pressure: the port at dp 2 against the
JAX engine on a 2-device mesh.

On an adequate pool sharding changes nothing
(``test_torch_serving_sharded.py``); on a tight one, shard-local capacity
binds and the admission order departs from a single device's. That case
needs the reference's own sharded engine, which needs two devices: it
runs in a subprocess with two forced host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=2``, as
``tests/test_sharding.py`` runs its mesh), on the golden harness's tiny
model, four CAMD requests of 12-token prompts and a pool of 12 pages (5
allocatable a shard; a prompt holds one page of its shard, a candidate
needs two more). There the admissions differ from a single device's
(shard 0, which the ascending slot walk reaches first, carries most of
them, and a round gets one candidate where one device would give two).
The port at dp 2, on the reference's weights and Gumbel draws, must make
the same admissions in the same order (request and slots), count the
same candidates per shard, give the same streams and end with the same
pool stats, per-shard counters included.
"""
import json
import subprocess
import sys

import numpy as np
import torch

from repro_torch import config as tconfig
from test_torch_engine_camd import _one_torch_thread  # noqa: F401
from torch_ranks import ROOT, subprocess_env
from test_torch_serving_sharded import (_golden_requests, model3,  # noqa
                                        port_engine, _conserved, _streams)

KW = dict(mode="camd", impl="paged", macro_steps=8)
N_REQ = 4
NUM_PAGES = 12
PLEN = 12

SNIPPET = r"""
import importlib.util, json, os
import jax, numpy as np
from repro.config import PagedKVConfig
from repro.launch.mesh import make_serve_mesh
spec = importlib.util.spec_from_file_location(
    "make_golden_fifo", os.path.join("tests", "data", "make_golden_fifo.py"))
gold = importlib.util.module_from_spec(spec)
spec.loader.exec_module(gold)
assert jax.device_count() == 2, jax.devices()
cfg, model, params = gold.tiny_model()
eng = gold.make_engine(model, params, mesh=make_serve_mesh(2),
                       paged_kv=PagedKVConfig(page_size=8, num_pages=%d),
                       **%r)
admitted = []
admit = eng._admit
def spy(req, slot_ids, limit=None):
    admitted.append([int(req.uid), [int(s) for s in slot_ids]])
    return admit(req, slot_ids, limit=limit)
eng._admit = spy
gold.submit(eng, cfg, n=%d, plen=%d)
res = sorted(eng.run(), key=lambda r: r.uid)
eng.pool.check()
streams = [{"uid": r.uid, "tokens": np.asarray(r.tokens).tolist(),
            "tokens_spent": r.tokens_spent, "rounds": r.rounds,
            "n_candidates": r.n_candidates,
            "candidates": sorted(np.asarray(c["tokens"]).tolist()
                                 for c in r.candidates)} for r in res]
print(json.dumps({"admitted": admitted, "streams": streams,
                  "sched": eng.sched_stats(), "pool": eng.pool.stats(),
                  "reserved": int(eng._reserved)}))
""" % (NUM_PAGES, KW, N_REQ, PLEN)


def test_pressure_admissions_equal_two_device_reference(model3):
    r = subprocess.run([sys.executable, "-c", SNIPPET], cwd=ROOT,
                       env=subprocess_env(2),
                       capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stderr[-3000:]
    ref = json.loads(r.stdout.strip().splitlines()[-1])

    eng = port_engine(model3[3], dp=2, paged_kv=tconfig.PagedKVConfig(
        page_size=8, num_pages=NUM_PAGES), **KW)
    admitted = []
    admit = eng._admit

    def spy(req, slot_ids, limit=None):
        admitted.append([int(req.uid), [int(s) for s in slot_ids]])
        return admit(req, slot_ids, limit=limit)

    eng._admit = spy
    for req in _golden_requests(model3[0], N_REQ, PLEN):
        eng.submit(req)
    with torch.inference_mode():
        streams = _streams(eng.run())
    assert admitted == ref["admitted"]
    # the tight pool queued work: some admission took fewer candidates
    # than a round asks for, or left a shard idle while slots were free
    assert any(len(slots) < 2 for _, slots in admitted)
    ss = eng.sched_stats()
    assert ss["admitted_per_shard"] == ref["sched"]["admitted_per_shard"]
    assert set(ss["admitted_per_shard"]) == {"0", "1"}
    assert {k: ss[k] for k in ("admitted_candidates", "spent",
                               "declined_rounds")} == \
        {k: ref["sched"][k] for k in ("admitted_candidates", "spent",
                                      "declined_rounds")}
    assert streams == ref["streams"]
    assert json.loads(json.dumps(eng.pool.stats())) == ref["pool"]
    assert ref["reserved"] == 0
    _conserved(eng)
    assert np.all([len(s["candidates"]) > 0 for s in streams])

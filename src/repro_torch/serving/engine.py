"""Slot-scheduled batched serving engine with CAMD adaptive decoding.

The port of ``repro/serving/engine.py``: decoder-only attention stacks,
the recurrent (SSD) and hybrid (RG-LRU + local attention) ones, and
encoder-decoder stacks. A fixed decode batch of ``slots``; each slot holds one candidate
generation of some request. When a request reaches coverage its slots
free and refill from the queue, so CAMD's adaptive allocation falls out of
slot scheduling.

Decode runs either as the legacy per-token loop (``macro_steps=0``: one
step, one host sync, eager on every device) or as macro-steps: a body of
K device steps with one host sync per launch. The body keeps the
reference ``while_loop``'s exit rule (stop after the step in which any
slot finishes, or when no slot is active) on the device: iterations past
that point run masked — no slot state changes, no position advances, no
frontier page consumed — so a launch ends in exactly the state the
reference's loop exits with, without a host round trip per step.

On a CUDA device each macro launch replays one CUDA graph of the body,
the counterpart of the reference's one compiled ``while_loop``: all K
decode + sample + CAMD-aggregate steps, frontier pulls included. The
graph is captured once per engine, at its first macro launch, after one
fully masked eager warm-up launch on a side stream (which loads every
kernel and changes no state a later step does not rewrite alike); a
failed capture raises. A replay reads and writes fixed addresses, so the
body updates ``EngineState`` and its cache in place, reads its Gumbel
noise from a static (K, B, V) buffer the host fills before each launch
(``_fill_noise``), its frontier from a static (B, F) buffer and its
evidence rows from a static (B, Ne, d) buffer. Kernel launch counts
(``ops.LAUNCHES``) gain the capture's per-kernel counts at every replay.
On the CPU the same body runs eagerly.

Paged KV (impls ``paged``/``paged_cuda``) lives in a shared page pool
(``PagePool``): candidates share their request's full prompt pages and copy
the partial tail page; before each launch the host stages every live
slot's next pages into a (B, F) frontier the device advances the block
table through, and unconsumed pages go back afterwards.

Sampling noise comes from ``noise`` (default ``GumbelNoise``): decode
noise for global step t depends on (seed, t) only, so token streams do not
depend on ``macro_steps``.

Speculative decoding (``spec_k`` > 1, macro-steps only, all-attention
full-context decoders) replaces the macro body by the reference's
speculative one (``_macro_step_spec``): each iteration drafts up to
spec_k - 1 tokens a slot from a device-resident n-gram table of the
slot's fed tokens (``EngineState.hist``), verifies the block in one
``Model.decode_block`` forward (plain ``sdpa`` on every impl, as the
reference verifies) and commits the accepted prefix through
``speculative_accept``: greedy streams equal the plain loop's, sampled
ones keep its distribution. An iteration consumes the noise of spec_k
global steps. ``spec_mode`` "coverage" narrows a candidate's verify width
as its request's posterior coverage deficit closes; "fixed" keeps it. On
the card the speculative body is the engine's one captured graph.

Multimodal requests (models with evidence tokens) carry precomputed
``evidence`` rows or an ``image``, which the model's vision tower encodes
at submit time, memoised by the image's content hash. The evidence rows
prefill ahead of the prompt; every decode step adds the generated token's
mean cosine against the request's (projected, normalised) evidence rows
to ``align_sum``, the incremental S_align of the candidate score; with
``xmodal_rescore`` each finished candidate's S_align is recomputed
instead by the cross-modal score (paper Eq. 8-9, kernel K4).

An encoder-decoder model (seamless-m4t-large-v2) is a "kv" model with no
layer to page: it serves on the dense impls only, each request
prefilled alone (no buckets, prefix cache, chunks or speculation, as in
the reference). Its evidence feeds the encoder, not the prompt span;
the prefill row's cross K/V move into the slot with the rest of the
row, and the captured decode step reads them from the engine's cache.

Recurrent and hybrid models (``Model.state_kind`` "recurrent" or
"hybrid") serve on the dense impls only: they have no layer to page. Each
request is prefilled alone (their right-padded bucketed prefill is not
bit for bit a per-row one), and its prompt state, every cache leaf of its
row (SSD state and conv tails, RG-LRU h and conv tails, the local layers'
rings), moves into a row of a fixed-stride ``StateArena`` of
2 * slots + 4 rows, ``model.make_cache(rows, cache_len)`` on the device,
until its request finishes or is cancelled; candidates are seeded from
that row. Prefill-ahead is bounded by the arena's free rows
(``sizing_stalls`` counts the deferrals), and ``arena_stats`` reports
the resident state bytes.

Paged engines store KV in the param dtype (``kv_dtype`` "auto"), in
fp32 or bf16, or quantized to int8 or fp8-e4m3 with one fp32 scale per
(page, slot, kv head): prompt spans are quantized once at seeding and
decode quantizes each new row on write; the ``paged_cuda`` impl
dequantizes inside the paged decode kernel (K1).

Paged engines on all-attention full-context decoders may keep a
cross-request prefix cache (``prefix_cache``): each request's key stream
(its prompt, or for an image request ``ne`` pseudo-tokens from the
image's content hash ahead of the prompt) is hashed page by page, its
full prompt pages are registered under those keys, and a later request
whose stream starts with cached pages holds them and prefills only its
suffix, attending to the cached K/V (dequantized for int8/fp8 pools) as
context. A hit on an image request must cover the whole image span.
Cached pages nobody else holds are evicted least-recently-used under
pool pressure or a ``kv_byte_budget``. Chunked prefill (``prefill_chunk``)
streams a long prompt into the pool in page-aligned chunks through the
same suffix path, at most ``prefill_chunk_budget`` tokens between two
decode launches, the jobs ordered by the policy's ``prefill_order``; the
first chunk of an image request carries the whole image span. Other
engines quietly run without both, as the reference does. Prefills,
chunks and page writes all run between launches, outside the captured
graph, and write the pools in place.

Impls: ``torch`` / ``paged`` run plain PyTorch attention and scoring,
``cuda`` / ``paged_cuda`` the hand-written kernels; the suffix attention
of a prefix hit or a later chunk runs plain ``sdpa`` on every impl, as
the reference's does (its flash kernel takes no context).

Requests may arrive and leave mid-flight: ``pump`` drives one serving
iteration at a time (an admission pass when work arrived, then one
launch), ``cancel`` aborts a request (queued work at once, running slots
at the next step boundary, deactivated and pointed at the quarantine page
in place, so the captured graph keeps its addresses), and with
``stream_tokens`` each launch's new tokens ride its one host sync into
``stream_events``; ``serving/frontend.py`` builds the asyncio front-end
on these hooks.

Mesh serving (``mesh=``, ``launch.mesh.make_serve_mesh``) partitions the
engine into ``dp`` data shards, dp the product of the mesh's data axes:
slot s belongs to shard ``s // slots_per_shard``, the page pool splits
into dp equal page-id ranges (``PagePool(num_shards=dp)``, the pool
rounded up to a multiple of dp, one quarantine page a shard) and a
recurrent engine's state arena into dp row ranges. Every page a slot
writes (its CoW tail, its frontier and legacy-loop pages) comes from its
own shard, idle rows point at their own shard's quarantine page, page
reservations are kept per shard and admission is shard-local
(``_paged_affordable`` funds each candidate from its slot's shard). The
engine keeps the rule table's specs of its tensors (``state_specs``,
``param_specs``, ``distributed/sharding.py``). On a one-process mesh
(``make_serve_mesh``) the shards are logical: the tensors stay whole on
the one device, the counterpart of the reference's forced host devices,
and a mesh over several devices or with a ``"model"`` axis above 1
raises ``NotImplementedError``. ``prefill_shards=k`` disaggregates
prefill from decode: prompt and chunk pages go to the least-loaded of
shards 0..k-1 and slots on every shard read them. Sharding is placement
only: streams equal the unsharded engine's while shard-local capacity
does not bind.

On a rank mesh (``launch.mesh.make_rank_mesh``: one process a position
of a ``(dp, model)`` mesh over ``torch.distributed``) each rank holds
its model shard (the model is cut for the rank: heads, MLP columns,
vocabulary rows), its data shard's slot rows ``[d * B / dp, ...)`` of
every state leaf and its shard's page range of the pools, and runs a
full copy of the host controller over all B slots: every rank makes the
same admissions, page choices and CAMD decisions. Prefill runs every
request on every data rank (at the rank's heads), so that each rank
samples every candidate's first token and can seed any of its slots.
The shared prompt pages of a request whose candidates span shards lie
on one shard (the reference reads them across shards, where GSPMD
gathers them): a rank copies those its slots read into mirror pages
past its page range (``_mirror``), written from its own prefill row and
held while its slots hold them. Block tables and the frontier carry
rank-local page ids. The macro body's exit flags are OR-ed over the
data group each step, its per-slot outputs gathered over the data group
before the host reads them, and each rank draws its rows of the global
noise, so a rank samples what one device samples from the same logits.
On a NCCL group the body is captured as one graph with its collectives;
on a gloo group (named by the caller) it runs eagerly, since gloo stages
through the host. Image requests: every model group encodes each
submitted image at submit time through the rank's cut of the tower, so
every rank holds the same evidence and memo counters; a rank stages its
own slots' evidence rows. With ``xmodal_rescore`` every rank runs K4 on
each finished candidate from the same inputs and takes rank 0's S_align
(``_xmodal_scores``). An MoE model's layers route the global batch on
every rank, as one device routes it: a decode step's MoE gathers its
slot rows over the data group, runs the rank's experts on its cut of
their width and sums the partial outputs back to the rank's rows
(``models/moe.py``); on a NCCL group those collectives are part of the
captured body too. A recurrent or hybrid model's state arena keeps its
host allocator global and alike on every rank; shard s's rows live on
data rank s only (``_arena_row0``, ``_arena_own``), at the rank's
widths (its SSD heads, RG-LRU channels and query heads beside a kv
head held whole). Every data rank prefills every request, and the
row's data rank keeps it. A slot seeded from a row on another shard
gets it from that shard's data rank, broadcast over the data group at
admission into a mirror row past the rank's block, held while the
rank's slots of the request live (``_fetch_row``). Speculation, the
prefix cache, chunked prefill and prefill shards over more than one
rank raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.config import CAMDConfig, PagedKVConfig, SamplingConfig
from repro_torch.core import controller as ctrl
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import ops, ref
from repro_torch.models import attention as attn_lib
from repro_torch.models import transformer as tf_lib
from repro_torch.models.model import check_rank_supported
from repro_torch.sampling.samplers import (GumbelNoise, sample_token,
                                           sample_token_batch,
                                           speculative_accept)
from repro_torch.serving.page_pool import PagePool, prefix_page_keys
from repro_torch.serving.state_arena import StateArena
from repro_torch.serving.scheduler import (NewWork, PrefillWork, RoundWork,
                                           SchedulerContext, make_scheduler)

IMPLS = ("torch", "cuda", "paged", "paged_cuda")
_MODEL_IMPL = {"torch": "torch", "cuda": "cuda", "paged": "torch",
               "paged_cuda": "cuda"}


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray                      # (L,) int32
    evidence: Optional[np.ndarray] = None   # (Ne, De) frontend embeddings
    image: Optional[np.ndarray] = None      # (H, W, C) raw image, encoded
                                            # into evidence at submit


@dataclasses.dataclass
class Result:
    uid: int
    tokens: np.ndarray                      # best candidate's generation
    n_candidates: int
    tokens_spent: int
    rounds: int
    p_star: float
    best_score: float
    stopped_early: bool
    candidates: List[Dict[str, Any]]        # per-candidate records
    cancelled: bool = False                 # aborted via ServeEngine.cancel


@dataclasses.dataclass
class EngineState:
    """Per-slot device state (updated in place by the decode step)."""
    cache: Dict[str, torch.Tensor]
    last_token: torch.Tensor   # (B,) int64
    token_counts: torch.Tensor  # (B, V) fp32
    sum_lp: torch.Tensor       # (B,)
    n_tok: torch.Tensor        # (B,) int32
    prev_h: torch.Tensor       # (B, d) unit hidden of the previous token
    sum_coh: torch.Tensor      # (B,)
    sum_emb: torch.Tensor      # (B, d)
    align_sum: torch.Tensor    # (B,) running token-evidence alignment
    active: torch.Tensor       # (B,) bool
    out_buf: torch.Tensor      # (B, max_new) int64
    bias: torch.Tensor         # (B, V) CAMD mixture guidance
    greedy: torch.Tensor       # (B,) bool
    limit: torch.Tensor        # (B,) int32 per-candidate token limit
    hist: torch.Tensor         # (B, H) int64 token fed at each cache
                               # position (-1: none, or evidence), the
                               # n-gram draft table; H = cache_len with
                               # speculation, else 1
    spec_k: torch.Tensor       # (B,) int32 per-slot verify width


# one side stream per device for every engine's warm-up and capture, so
# that the per-stream state libraries keep (cuBLAS's workspace) is made once
_CAPTURE_STREAMS: Dict[int, torch.cuda.Stream] = {}


def _capture_stream(device) -> torch.cuda.Stream:
    index = torch.device(device).index or 0
    if index not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[index] = torch.cuda.Stream(device)
    return _CAPTURE_STREAMS[index]


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


_AS_RANKS = ("serve it as ranks: launch.mesh.make_rank_mesh under "
             "torch.distributed (python -m torch.distributed.run "
             "--nproc-per-node N -m repro_torch.launch.serve --mesh "
             "dp,model; ROADMAP.md Queue 1 item 5)")


def _mesh_dp(mesh, device: torch.device) -> int:
    """The data-shard count of a serving mesh: a rank mesh's dp, or that
    of a one-process mesh whose every position is ``device``. A
    one-process mesh over several devices, or with a model axis above 1,
    raises ``NotImplementedError``."""
    world = getattr(mesh, "world", None)
    if world is not None:
        if (world.device.type, world.device.index or 0) != \
                (device.type, device.index or 0):
            raise ValueError(f"the rank's device {world.device} is not the "
                             f"model's {device}")
        return world.dp
    model = mesh.shape.get("model", 1)
    if model > 1:
        raise NotImplementedError(
            f"a one-process serving mesh with model={model}: "
            f"{_AS_RANKS}")
    devices = getattr(mesh, "devices", None)
    if devices is None:
        raise ValueError("a mesh of shape only names no device to serve on")
    distinct = {torch.device(d) for d in devices}
    if len(distinct) > 1:
        raise NotImplementedError(
            f"a one-process serving mesh over {len(distinct)} devices: "
            f"{_AS_RANKS}")
    (dev,) = distinct
    if (dev.type, dev.index or 0) != (device.type, device.index or 0):
        raise ValueError(f"the mesh's device {dev} is not the model's "
                         f"{device}")
    return max(1, int(np.prod([mesh.shape[a] for a in shd.dp_axes(mesh)],
                              dtype=np.int64)))


class ServeEngine:
    def __init__(self, model, *, slots: int = 8, cache_len: int = 512,
                 sampling: SamplingConfig = SamplingConfig(),
                 camd: CAMDConfig = CAMDConfig(), mode: str = "camd",
                 n_candidates: int = 8, eos_id: int = 1,
                 max_new_tokens: int = 64, impl: str = "torch",
                 paged_kv: PagedKVConfig = PagedKVConfig(),
                 macro_steps: int = 8, bucket_prefill: bool = True,
                 prefill_bucket_min: int = 16, sched_policy="fifo",
                 global_budget: int = 0, prefix_cache: bool = False,
                 prefill_chunk: int = 0, prefill_chunk_budget: int = 0,
                 prefill_shards: int = 0, mesh=None, spec_k: int = 0,
                 spec_mode: str = "coverage", spec_ngram: int = 2,
                 xmodal_rescore: bool = False, seed: int = 0, noise=None):
        if mode not in ("camd", "best_of_n", "self_consistency", "greedy"):
            raise ValueError(f"unknown mode {mode!r}")
        if impl not in IMPLS:
            raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
        if macro_steps < 0:
            raise ValueError("macro_steps must be >= 0")
        if spec_mode not in ("coverage", "fixed"):
            raise ValueError(f"unknown spec_mode {spec_mode!r}")
        if spec_ngram < 1:
            raise ValueError("spec_ngram must be >= 1")
        # speculative decoding: spec_k <= 1 keeps the plain one-token step
        self.spec = spec_k > 1
        self.spec_k = spec_k if self.spec else 0
        self.spec_mode = spec_mode
        self.spec_ngram = spec_ngram
        if self.spec and macro_steps < 1:
            raise ValueError("speculative decoding runs inside the macro "
                             "body (macro_steps >= 1)")
        if self.spec and not model.supports_speculative:
            raise ValueError(f"{model.cfg.name}: speculative verification "
                             "needs an all-attention full-context decoder")
        self.model = model
        self.cfg = model.cfg
        self.device = model.device
        # mesh serving: slots partition contiguously over dp data shards
        self.mesh = mesh
        self.world = getattr(mesh, "world", None)
        self.dp = 1 if mesh is None else _mesh_dp(mesh, self.device)
        if slots % self.dp:
            raise ValueError(f"slots {slots} must divide across {self.dp} "
                             "data shards")
        self.slots_per_shard = slots // self.dp
        self.B = slots
        # the slot rows this process holds: a rank its data shard's
        # [row0, row0 + B_local), one process all of them
        self.B_local = slots if self.world is None else self.slots_per_shard
        self.row0 = 0 if self.world is None else \
            self.world.coords[0] * self.B_local
        self._rows = slice(self.row0, self.row0 + self.B_local)
        if self.world is not None:
            self._check_rank_engine(model, spec_k > 1, prefix_cache,
                                    prefill_chunk > 0, prefill_shards > 0)
        # a gloo group stages every collective through the host, which a
        # CUDA graph cannot capture: its macro body runs eagerly. A NCCL
        # group makes its communicators now, by one eager collective each,
        # before a capture records collectives
        self._eager_body = self.world is not None and \
            self.world.backend == "gloo"
        if self.world is not None and not self._eager_body:
            self.world.warm()
        self.V = self.cfg.vocab_size
        self.d = self.cfg.d_model
        self.cache_len = cache_len
        self.sampling = sampling
        self.camd = camd
        self.mode = mode
        self.n_candidates = 1 if mode == "greedy" else n_candidates
        self.eos_id = eos_id
        self.max_new = max_new_tokens
        self.impl = impl
        self.macro_steps = macro_steps
        self.paged = impl.startswith("paged")
        self._model_impl = _MODEL_IMPL[impl]
        # "kv" slots own attention KV only, "recurrent" ones fixed-size
        # state only, "hybrid" ones both; recurrent and hybrid prompt
        # state lives in the state arena, never in pages
        self.state_kind = model.state_kind
        if self.paged and not model.has_pageable_layers:
            raise ValueError(
                f"impl={impl!r} pages full-context attention KV, but "
                f"{self.cfg.name} ({self.state_kind}) has no pageable "
                "layers — serve it with impl='torch'/'cuda' (fixed-stride "
                "state rows are arena-managed, not paged)")
        # the prefix cache and chunked prefill need paged KV on an
        # all-attention full-context decoder; elsewhere they are off
        self.prefix_cache = bool(prefix_cache) and self.paged and \
            model.supports_prefix_cache
        self.kv_dtype = paged_kv.kv_dtype
        if not self.paged and self.kv_dtype != "auto":
            raise ValueError(f"kv_dtype={self.kv_dtype!r} needs a paged impl")
        if self.paged:
            # fails fast on an unknown name
            attn_lib.kv_storage_dtype(self.kv_dtype, model.param_dtype)
            ps = paged_kv.page_size
            if cache_len % ps:
                raise ValueError(f"cache_len {cache_len} must be a multiple "
                                 f"of page_size {ps}")
            self.page_size = ps
            self.pages_per_slot = cache_len // ps
            # one quarantine page a shard; a given pool size rounds up to a
            # multiple of the shard count
            num_pages = paged_kv.num_pages or \
                slots * self.pages_per_slot + self.dp
            num_pages += -num_pages % self.dp
            self.pool = PagePool(num_pages, ps, prefix_cache=self.prefix_cache,
                                 num_shards=self.dp,
                                 kv_byte_budget=paged_kv.kv_byte_budget)
            self._slot_pages: List[List[int]] = [[] for _ in range(slots)]
            self._slot_pos = np.zeros(slots, np.int64)
            self._slot_limit = np.zeros(slots, np.int64)
            # pages a running candidate may still allocate are reserved at
            # admission, so an admitted candidate can always finish; a
            # slot's future pages come from its own shard, so the ledger
            # is kept per shard
            self._slot_reserved = np.zeros(slots, np.int64)
            self._reserved_sh = np.zeros(self.dp, np.int64)
            # each slot's own shard's quarantine page
            self._slot_quarantine = np.asarray(
                [self.pool.quarantine_page(self._slot_shard(s))
                 for s in range(slots)], np.int32)
            # the pages this process's pool tensors hold: a rank its
            # shard's range, then mirror pages for the prompt pages its
            # slots read on other shards (each slot at most a prompt's
            # full pages); one process every page
            rank = self.world is not None
            self._page0 = self.pool.page_offset(self.row0 //
                                                self.slots_per_shard)
            self._own_pages = self.pool.pages_per_shard if rank else \
                num_pages
            n_mirror = self.slots_per_shard * (self.pages_per_slot - 1) \
                if rank and self.dp > 1 else 0
            self._mirror: Dict[int, int] = {}     # global page -> local id
            self._mirror_refs: Dict[int, int] = {}
            self._n_mirror = n_mirror
            self._mirror_free = list(range(self._own_pages + n_mirror - 1,
                                           self._own_pages - 1, -1))
            self._slot_mirrors: Dict[int, List[int]] = {}
            self.mirror_peak = 0
            # the most page boundaries one slot crosses in K steps (each
            # committing up to spec_k tokens), plus the boundary the first
            # step may land on
            adv = max(macro_steps, 1) * max(self.spec_k, 1)
            self._frontier_width = min(max(1, -(-adv // ps) + 1),
                                       self.pages_per_slot)
            # chunk sizes round up to whole pages
            self.chunked = prefill_chunk > 0 and model.supports_prefix_cache
            self.chunk = -(-int(prefill_chunk) // ps) * ps \
                if self.chunked else 0
            self.chunk_budget = int(prefill_chunk_budget) or self.chunk
            # prefill/decode disaggregation: prompt and chunk pages on the
            # first ``prefill_shards`` shards (0: the admitting slot's)
            self.prefill_shards = int(prefill_shards)
            shd.prefill_shard_ids(self.dp, self.prefill_shards)  # validates
        else:
            if prefill_shards:
                raise ValueError("prefill/decode disaggregation needs a "
                                 "paged impl")
            self.pool = None
            self.chunked = False
            self.chunk = self.chunk_budget = 0
            self.prefill_shards = 0
        self.noise = noise if noise is not None else \
            GumbelNoise(seed, self.device)
        self._t = 0                      # global decode step counter
        self.has_evidence = bool(self.cfg.num_evidence_tokens)
        # image frontend: submit-time tower encode, memoised by the
        # sha256 of the image bytes in a FIFO of 64 entries; the digest
        # also keys the request's pseudo-tokens in the prefix cache
        self._image_feats: Dict[bytes, np.ndarray] = {}
        self._image_digest: Dict[int, bytes] = {}
        self.image_encodes = 0
        self.image_feat_hits = 0
        self.image_encode_s = 0.0       # wall seconds of the tower encodes
        # recompute each finished candidate's S_align by the cross-modal
        # score (Eq. 8-9) instead of the incremental aggregate
        self.xmodal_rescore = bool(xmodal_rescore) and self.has_evidence
        # candidates rescored by the cross-modal score (one K4 call each)
        # and, over ranks, those whose own S_align differed from rank 0's
        self.xmodal_rescored = 0
        self.xmodal_parted = 0
        # (B_local, Ne, d) normalised evidence rows of the request of each
        # slot this process holds, refreshed in place whenever admissions
        # change (``_gather_evid``)
        self._evid = torch.zeros(
            (self.B_local, self.cfg.num_evidence_tokens, self.d),
            device=self.device) if self.has_evidence else None

        self._queue: List[Request] = []
        self._slot_req = np.full(slots, -1, np.int64)
        self._slot_cand = np.full(slots, -1, np.int64)
        self._slot_lim = np.full(slots, max_new_tokens, np.int64)
        # host mirror of each slot's verify width (frontier staging sizes a
        # slot's worst-case advance with it)
        self._slot_spec = np.ones(slots, np.int64)
        self._reqs: Dict[int, Dict[str, Any]] = {}
        self._next_cand = 0
        self._dtype = model.param_dtype
        self.scheduler = make_scheduler(sched_policy,
                                        global_budget=global_budget)
        self._arrival: Dict[int, int] = {}
        self._submit_seq = 0
        self.starved_uids: List[int] = []
        self.prefill_calls = 0
        self.prefill_tokens = 0
        # chunked prefill: uid -> in-flight job {"req", "pos", "pages"}; a
        # job's request stays queued until its final chunk makes it a
        # request record. ``_chunk_left`` is the turn's chunk-token budget.
        self._chunking: Dict[int, Dict[str, Any]] = {}
        self._chunk_progress = False
        self._chunk_left = self.chunk_budget
        self.chunk_calls = 0
        self.chunk_tokens = 0
        self.bucket_prefill = bool(bucket_prefill) and \
            model.supports_bucketed_prefill
        self.prefill_bucket_min = prefill_bucket_min
        rings = tf_lib.ring_lens(self.cfg, cache_len)
        self._min_ring = min(rings) if rings else cache_len
        self.state = self._blank_state()
        # recurrent and hybrid prompt rows: a bounded device buffer of
        # whole cache rows, managed by the arena (engine.py:401-412), in
        # one row range a shard
        self.arena = None
        self._arena_buf = None
        if self.state_kind != "kv" and not self.paged:
            per_shard = 2 * self.slots_per_shard + 4
            self.arena = StateArena(per_shard * self.dp, num_shards=self.dp)
            # the rows this process's buffer holds: a rank its shard's
            # block, then a mirror row for each request whose row lies on
            # another shard while its slots here hold it (at most a slot's
            # worth); one process every row
            rank = self.world is not None
            self._arena_row0 = self.row0 // self.slots_per_shard * \
                per_shard if rank else 0
            self._arena_own = per_shard if rank else self.arena.num_rows
            self._n_row_mirror = self.slots_per_shard \
                if rank and self.dp > 1 else 0
            self._row_mirror: Dict[int, int] = {}   # global row -> local
            self._row_mirror_refs: Dict[int, int] = {}
            self._row_mirror_free = list(range(
                self._arena_own + self._n_row_mirror - 1,
                self._arena_own - 1, -1))
            self._slot_row_mirror: Dict[int, int] = {}
            self.row_mirror_peak = 0
            self.row_fetches = 0
            self._arena_buf = model.make_cache(
                self._arena_own + self._n_row_mirror, cache_len, self._dtype)
        self.state_specs = self.param_specs = self.arena_specs = None
        if mesh is not None:
            self._install_mesh(mesh)
        if self.paged:
            # the pool enforces the byte budget from the engine's bytes a
            # page
            self.pool.set_bytes_per_page(self._bytes_per_page())
        self._greedy_row = torch.tensor([mode == "greedy"],
                                        device=self.device)
        # the macro body's static inputs: each global step's Gumbel noise
        # and, speculating, acceptance uniforms (none in greedy mode), and
        # the paged slots' staged pages, for the rows this process holds
        n_noise = max(macro_steps, 1) * max(self.spec_k, 1)
        self._noise_buf = None if mode == "greedy" else \
            torch.zeros((n_noise, self.B_local, self.V), device=self.device)
        self._unif_buf = torch.zeros((n_noise, self.B_local),
                                     device=self.device) \
            if self.spec and mode != "greedy" else None
        self._frontier = torch.zeros((self.B_local, self._frontier_width),
                                     dtype=torch.int32, device=self.device) \
            if self.paged else None
        # the card's captured macro body: graph, its output tensors and
        # the kernel launches one replay makes
        self._graph = None
        self._graph_out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self._graph_launches: Dict[str, int] = {}
        # telemetry: device decode steps, macro launches, decode-loop host
        # synchronizations, tokens generated
        self.total_steps = 0
        self.total_tokens = 0
        self.macro_launches = 0
        self.host_syncs = 0
        # speculation telemetry: drafts proposed, drafts accepted
        self.spec_drafted = 0
        self.spec_accepted = 0
        # graph telemetry: graphs captured, seconds spent warming up and
        # capturing, the warm-up's kernel launches (kept out of
        # ``ops.LAUNCHES``), and the device steps the macro launches ran,
        # masked iterations included (K a launch, against ``total_steps``)
        self._graphs_captured = 0
        self._capture_s = 0.0
        self._warmup_launches: Dict[str, int] = {}
        self._steps_launched = 0
        # async front-end plumbing: opt-in per-launch token streaming (its
        # readbacks ride the launch's one sync), a completion feed drained
        # between launches, cancellations applied at step boundaries, and
        # whether the first admission pass ran (``pump``'s first call runs
        # the one ``run`` starts with)
        self.stream_tokens = False
        self.stream_events: List[Tuple[int, int, np.ndarray]] = []
        self._slot_streamed = np.zeros(slots, np.int64)
        self._newly_done: List[int] = []
        self._cancels: set = set()
        self.cancelled_requests = 0
        self._begun = False

    # ------------------------------------------------------------------
    def _sync(self, tensors) -> List[np.ndarray]:
        """Decode-loop host readback: one counted synchronization. The
        arrays are copies, never views of the live state (which a CPU
        tensor's ``numpy()`` would give)."""
        self.host_syncs += 1
        return [t.to("cpu", copy=True).numpy() for t in tensors]

    def _any_live(self) -> bool:
        return bool((self._slot_req >= 0).any())

    # -- ranks ------------------------------------------------------------
    def _check_rank_engine(self, model, spec, prefix_cache, chunked,
                           prefill_shards) -> None:
        """What a rank engine refuses: a model family no rank holds yet
        (encoder-decoder; decoder-only stacks of attention, SSD and
        RG-LRU blocks with dense or MoE MLPs are served, a recurrent or
        hybrid one on the dense impls, as on one device), a model not cut
        for this rank's world, and over more than one rank the features
        that need a sink page a shard or reads of another rank's pages
        (ROADMAP.md Queue 1 item 5's later steps)."""
        world = self.world
        check_rank_supported(model.cfg, world)
        if model.world is not None and model.world is not world:
            raise ValueError("the model is cut for another rank world")
        if model.world is None and world.model > 1:
            raise ValueError(f"a model axis of {world.model} serves a model "
                             "cut for the rank: build_model(cfg, ..., "
                             "world=mesh.world)")
        if world.size == 1:
            return
        for what, step, on in (
                ("speculative decoding", "step 5, speculation over ranks",
                 spec),
                ("the prefix cache", "step 6, the prefix cache and "
                 "disaggregated prefill across ranks", prefix_cache),
                ("chunked prefill", "step 6, the prefix cache and "
                 "disaggregated prefill across ranks", chunked),
                ("prefill shards", "step 6, the prefix cache and "
                 "disaggregated prefill across ranks", prefill_shards)):
            if on:
                raise NotImplementedError(
                    f"{what} over {world.size} ranks is not ported yet "
                    f"(ROADMAP.md Queue 1 item 5, {step})")

    def _own(self, slots) -> Tuple[np.ndarray, np.ndarray]:
        """The slots of ``slots`` whose rows this process holds: (their
        positions in ``slots``, their local rows)."""
        s = np.asarray(slots, np.int64)
        j = np.nonzero((s >= self.row0) & (s < self.row0 + self.B_local))[0]
        return j, s[j] - self.row0

    def _all_rows(self, t: torch.Tensor) -> torch.Tensor:
        """Every slot's rows of a per-slot tensor: on a rank mesh the data
        group's blocks, gathered in slot order; else ``t``."""
        return t if self.world is None else self.world.all_gather_data(t)

    def _data_any(self, *flags: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """0-dim bool flags, each OR-ed over the data group on a rank mesh
        (one collective for all); else the flags."""
        if self.world is None:
            return flags
        t = torch.stack(flags).to(torch.int32)
        self.world.any_data(t)
        return tuple(t > 0)

    def _local_pages(self, pages, held_only: bool = False) -> np.ndarray:
        """Pool indices of global page ids in this process's pool tensors
        (int32, the array's shape): a rank's own range shifted to 0, a
        mirrored page its mirror's index; one process, the ids
        themselves. A page held nowhere here raises, or gives -1 with
        ``held_only``."""
        g = np.asarray(pages, np.int64)
        loc = g - self._page0
        for i in np.nonzero(((loc < 0) | (loc >= self._own_pages)).ravel())[0]:
            page = int(g.ravel()[i])
            if page not in self._mirror and not held_only:
                raise RuntimeError(f"page {page} is not held by this rank")
            loc.ravel()[i] = self._mirror.get(page, -1)
        return loc.astype(np.int32)

    def _hold_mirrors(self, s: int, pages: List[int], info) -> None:
        """Slot ``s`` (this rank's) reads the request's prompt pages
        ``pages``: those on another shard get a mirror page here, written
        from the request's prefill row at first use, and held until the
        slot lets go (``_drop_mirrors``)."""
        new = False
        for g in pages:
            if 0 <= g - self._page0 < self._own_pages:
                continue
            if g not in self._mirror:
                self._mirror[g] = self._mirror_free.pop()
                new = True
            self._mirror_refs[g] = self._mirror_refs.get(g, 0) + 1
            self._slot_mirrors.setdefault(s, []).append(g)
        self.mirror_peak = max(self.mirror_peak, len(self._mirror))
        if new:
            # prompt page i holds the row's positions [i * ps, ...)
            self._write_pages(info["cache_row"], pages, 0)

    def _drop_mirrors(self, s: int) -> None:
        for g in self._slot_mirrors.pop(s, ()):
            self._mirror_refs[g] -= 1
            if not self._mirror_refs[g]:
                del self._mirror_refs[g]
                self._mirror_free.append(self._mirror.pop(g))

    def _whole_cache(self, batch: int) -> Dict[str, Tuple[int, ...]]:
        """The shapes of a dense cache of ``batch`` rows over every rank
        (every kv head, SSD head and RG-LRU channel; one kv head once):
        ``make_cache`` at the config's widths on the meta device."""
        cache = tf_lib.make_cache(self.cfg, batch, self.cache_len,
                                  self._dtype, "meta")
        return {k: tuple(t.shape) for k, t in cache.items()}

    def _whole_shapes(self) -> EngineState:
        """A rank's state as the shapes of the whole tensors over every
        rank (B slot rows, every page, every kv head): what the rule table
        specs."""
        dense = None if self.paged else self._whole_cache(self.B)

        def whole(name, t):
            if dense is not None:
                return dense[name]
            shape = list(t.shape)
            if name in ("pos", "block_table"):
                shape[0] = self.B
            else:                 # pools (n, P, ps, Hkv, hd), their scales
                shape[1] = self.pool.num_pages + int(self.spec)
                shape[3] = self.cfg.num_kv_heads
            return tuple(shape)

        st = self.state
        return EngineState(
            cache={k: whole(k, t) for k, t in st.cache.items()},
            **{f.name: (self.B,) + tuple(getattr(st, f.name).shape[1:])
               for f in dataclasses.fields(st) if f.name != "cache"})

    # -- mesh placement ---------------------------------------------------
    def _install_mesh(self, mesh) -> None:
        """The rule table's specs of the engine's tensors (``engine.py:
        466-498``): the decode batch and every per-slot leaf on the data
        axes, the paged pools on their page axis, the arena's rows like
        slot rows, the parameters replicated, or tensor-parallel on a
        model axis. Shard s owns slot rows ``[s * slots_per_shard, ...)``,
        pages ``[s * pool.pages_per_shard, ...)`` and arena rows ``[s *
        arena.rows_per_shard, ...)``. One process keeps the tensors whole
        on its device. A rank holds its blocks of the whole tensors the
        specs are of: the model was cut by ``param_specs`` at its build,
        the state is allocated as the rank's slot rows (``B_local``) and
        page range (``_own_pages``, and its mirror pages past it); its
        pools and dense caches hold its kv heads, where the table
        replicates a pool's heads. Checks that every sharded dim divides
        by its axes."""
        state = self.state if self.world is None else self._whole_shapes()
        self.state_specs = shd.engine_state_specs(self.cfg, state, mesh)
        self.param_specs = shd.serve_param_specs(
            self.cfg, self.model.param_shapes(), mesh)
        leaves = [(f"cache.{k}", v, self.state_specs["cache"][k])
                  for k, v in state.cache.items()]
        leaves += [(f, getattr(state, f), spec)
                   for f, spec in self.state_specs.items() if f != "cache"]
        if self._arena_buf is not None:
            arena = self._arena_buf if self.world is None else \
                self._whole_cache(self.arena.num_rows)
            self.arena_specs = shd.cache_specs(self.cfg, arena, mesh)
            leaves += [(f"arena.{k}", v, self.arena_specs[k])
                       for k, v in arena.items()]
        for name, t, spec in leaves:
            shape = shd._shape(t)
            for dim, axes in enumerate(spec):
                if axes is not None and shape[dim] % shd._axsize(mesh, axes):
                    raise ValueError(f"{name}: dim {dim} of {shape} does not "
                                     f"divide over {axes}")

    def _slot_shard(self, s: int) -> int:
        """The data shard owning slot ``s`` (contiguous partition)."""
        return s // self.slots_per_shard

    @property
    def _reserved(self) -> int:
        """Page reservations of running candidates, over all shards."""
        return int(self._reserved_sh.sum())

    def _shard_headroom(self, s: int) -> int:
        """Pages shard ``s`` could fund right now: free and cache-evictable
        pages of its range minus the reservations charged to it."""
        return self.pool.free_pages_in(s) + self.pool.evictable(s) \
            - int(self._reserved_sh[s])

    def _blank_state(self) -> EngineState:
        """The state of the slot rows this process holds (a rank's data
        shard's), its pools holding its pages (``_own_pages`` and the
        mirrors past them)."""
        B, V, d, dev = self.B_local, self.V, self.d, self.device
        if self.paged:
            # a speculating engine's pool tensors hold one more page than
            # the page pool hands out: the sink of the verify blocks'
            # dropped writes, which no row reads (a quarantine page is read
            # by its shard's idle rows, whose hidden states an MoE layer
            # routes beside the live ones)
            cache = self.model.make_paged_cache(
                B, self.cache_len, self._dtype, page_size=self.page_size,
                num_pages=self._own_pages + self._n_mirror + int(self.spec),
                kv_dtype=self.kv_dtype)
            # idle rows point at their own shard's quarantine page
            cache["block_table"].copy_(torch.as_tensor(self._local_pages(
                self._slot_quarantine[self._rows]), device=dev)[:, None]
                .expand(B, self.pages_per_slot))
        else:
            cache = self.model.make_cache(B, self.cache_len, self._dtype)

        def zeros(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        return EngineState(
            cache=cache, last_token=zeros(B, dtype=torch.long),
            token_counts=zeros(B, V), sum_lp=zeros(B),
            n_tok=zeros(B, dtype=torch.int32), prev_h=zeros(B, d),
            sum_coh=zeros(B), sum_emb=zeros(B, d), align_sum=zeros(B),
            active=zeros(B, dtype=torch.bool),
            out_buf=zeros(B, self.max_new, dtype=torch.long),
            bias=zeros(B, V), greedy=zeros(B, dtype=torch.bool),
            limit=torch.full((B,), self.max_new, dtype=torch.int32,
                             device=dev),
            hist=torch.full((B, self.cache_len if self.spec else 1), -1,
                            dtype=torch.long, device=dev),
            spec_k=torch.ones(B, dtype=torch.int32, device=dev))

    # ------------------------------------------------------------------
    def _decode_step(self, noise, go=None) -> torch.Tensor:
        """One decode + sample + CAMD-aggregate step over all slots, in
        place: every tensor of the state keeps its storage, as a graph
        replay needs. ``go``: optional 0-dim bool tensor; when False the
        step is masked (no slot state changes, positions stay). Returns
        the (B,) bool mask of slots whose candidate finished in this
        step."""
        st = self.state
        logits, hidden, _ = self.model.decode_step(
            st.last_token, st.cache, impl=self._model_impl, go=go)
        if go is not None:               # a masked step keeps its position
            st.cache["pos"].sub_((~go).to(torch.int32))
        tok, lp = sample_token(logits.float(), self.sampling,
                               st.token_counts, st.bias, greedy=st.greedy,
                               noise=noise)
        act = st.active if go is None else st.active & go
        actf = act.float()
        h32 = hidden.float()
        hn = h32 / (torch.linalg.vector_norm(h32, dim=-1, keepdim=True)
                    + 1e-8)
        st.sum_lp += lp * actf
        coh = (hn * st.prev_h).sum(-1)
        st.sum_coh += coh * actf * (st.n_tok > 0).float()
        st.sum_emb += h32 * actf[:, None]
        if self.has_evidence:
            # mean over all of the gathered row's evidence, zero padding
            # rows included, as the reference (engine.py:652-659)
            st.align_sum += torch.einsum(
                "bnd,bd->bn", self._evid, self._unit_embed(tok)).mean(-1) \
                * actf
        st.token_counts[torch.arange(self.B_local, device=self.device),
                        tok] += actf
        write = (torch.arange(self.max_new, device=self.device)[None, :] ==
                 st.n_tok[:, None]) & act[:, None]
        torch.where(write, tok[:, None], st.out_buf, out=st.out_buf)
        st.n_tok += act.to(torch.int32)
        done = act & ((tok == self.eos_id) | (st.n_tok >= st.limit))
        torch.where(act, tok, st.last_token, out=st.last_token)
        torch.where(act[:, None], hn, st.prev_h, out=st.prev_h)
        st.active &= ~done
        return done

    def _macro_step(self) -> Tuple[torch.Tensor, ...]:
        """The macro body: K decode steps with the reference's early exit
        kept on the device (see the module docstring), iteration i
        drawing ``_noise_buf[i]``. Paged slots pull their next page from
        the staged ``_frontier`` row when their write position crosses a
        page boundary. It makes no host sync and rebinds no state, so the
        card captures it whole. Returns (done of the last real step,
        number of real steps) as device tensors; a speculating engine runs
        ``_macro_step_spec`` instead."""
        if self.spec:
            return self._macro_step_spec()
        K = max(self.macro_steps, 1)
        st, B, dev = self.state, self.B_local, self.device
        # the exit rule reads every slot: on a rank mesh its flags are
        # OR-ed over the data group
        (go,) = self._data_any(st.active.any())
        steps = torch.zeros((), dtype=torch.int32, device=dev)
        done_out = torch.zeros(B, dtype=torch.bool, device=dev)
        rows = torch.arange(B, device=dev)
        if self.paged:
            frontier = self._frontier
            fidx = torch.zeros(B, dtype=torch.long, device=dev)
            F = frontier.shape[1]
        for i in range(K):
            if self.paged:
                pos = st.cache["pos"].long()
                bt = st.cache["block_table"]
                need = st.active & go & (pos % self.page_size == 0)
                li = torch.clamp(pos // self.page_size, 0, bt.shape[1] - 1)
                page = frontier.gather(1, fidx.clamp(0, F - 1)[:, None])[:, 0]
                bt[rows, li] = torch.where(need, page, bt[rows, li])
                fidx += need.long()
            noise = None if self._noise_buf is None else self._noise_buf[i]
            done = self._decode_step(noise, go)
            steps += go.to(torch.int32)
            torch.where(go, done, done_out, out=done_out)
            live, ended = self._data_any(st.active.any(), done.any())
            go = go & live & ~ended
        return done_out, steps

    def _macro_step_spec(self) -> Tuple[torch.Tensor, ...]:
        """The speculative macro body (``engine.py:799-938``): K
        iterations, each drafting up to spec_k - 1 tokens a slot
        (``_ngram_draft``, cut to the slot's own width), feeding positions
        up to ``limit - n_tok`` (``valid``), verifying the block in one
        ``Model.decode_block`` forward, accepting a prefix
        (``speculative_accept``, on the noise of global steps t0 + i *
        spec_k ..), then folding the CAMD aggregates over the emitted
        tokens, writing them to ``out_buf`` and the fed ones to ``hist``,
        and advancing ``pos`` by the count emitted. The reference's exit
        rule runs as masked iterations, as in the plain body: they change
        no state and write no KV. A paged slot's logical pages [pos // ps,
        (pos + spec_k - 1) // ps] map to ``_frontier[s, li - li0]``, li0
        fixed at the launch's start: a pure function of pos, so a partial
        acceptance maps the same entries again. In place and with no host
        sync, as the graph needs. Returns (done of the last real
        iteration, real iterations, drafts proposed, drafts accepted) as
        device tensors."""
        K, Kb = max(self.macro_steps, 1), self.spec_k
        st, B, dev = self.state, self.B, self.device
        go = st.active.any()
        steps, drafted, accepted = (torch.zeros((), dtype=torch.int32,
                                                device=dev) for _ in range(3))
        done_out = torch.zeros(B, dtype=torch.bool, device=dev)
        blk = torch.arange(Kb, device=dev)[None, :]
        out_col = torch.arange(self.max_new, device=dev)[None, :]
        hist_col = torch.arange(st.hist.shape[1], device=dev)[None, :]
        if self.paged:
            ps, bt = self.page_size, st.cache["block_table"]
            li = torch.arange(bt.shape[1], device=dev)[None, :]
            fr_idx = li - (-(-st.cache["pos"].long() // ps))[:, None]
            F = self._frontier.shape[1]
            in_frontier = (fr_idx >= 0) & (fr_idx < F)
            fr_page = self._frontier.gather(1, fr_idx.clamp(0, F - 1))
        for i in range(K):
            act = st.active & go
            pos = st.cache["pos"].long()
            if self.paged:
                need = act[:, None] & in_frontier & \
                    (li >= (pos // ps)[:, None]) & \
                    (li <= ((pos + Kb - 1) // ps)[:, None])
                torch.where(need, fr_page, bt, out=bt)
            draft = self._ngram_draft(st.hist, pos, st.last_token)
            draft = torch.where(blk[:, :-1] < (st.spec_k - 1)[:, None],
                                draft, -1)
            tokens = torch.cat([st.last_token[:, None], draft.clamp_min(0)],
                               dim=1)
            valid = act[:, None] & (blk < (st.limit - st.n_tok)[:, None])
            logits, hidden, _ = self.model.decode_block(
                tokens, st.cache, valid, impl=self._model_impl,
                drop_page=self.pool.num_pages if self.paged else 0)
            gumbel, unif = (None if buf is None else buf[i * Kb:(i + 1) * Kb]
                            for buf in (self._noise_buf, self._unif_buf))
            toks, lps, emit, counts, n_tok, stopped = speculative_accept(
                logits.float(), draft, self.sampling,
                token_counts=st.token_counts, bias=st.bias,
                greedy=st.greedy, eos_id=self.eos_id, n_tok=st.n_tok,
                limit=st.limit, active=act, noise=gumbel, uniform=unif,
                greedy_static=self.mode == "greedy")
            emitf = emit.float()
            n_emit = emit.sum(1)
            last = (n_emit - 1).clamp_min(0)[:, None]
            h32 = hidden.float()
            hn = h32 / (torch.linalg.vector_norm(h32, dim=-1, keepdim=True)
                        + 1e-8)
            # the CAMD aggregates over the emitted prefix
            st.sum_lp += (lps * emitf).sum(1)
            prev = torch.cat([st.prev_h[:, None], hn[:, :-1]], dim=1)
            coh_w = torch.cat([emitf[:, :1] * (st.n_tok > 0).float()[:, None],
                               emitf[:, 1:]], dim=1)
            st.sum_coh += ((hn * prev).sum(-1) * coh_w).sum(1)
            st.sum_emb += (h32 * emitf[..., None]).sum(1)
            if self.has_evidence:
                st.align_sum += (torch.einsum(
                    "bnd,bkd->bkn", self._evid, self._unit_embed(toks))
                    .mean(-1) * emitf).sum(1)
            # emitted tokens land at out_buf[n_tok, n_tok + n_emit), the
            # fed ones [last, toks[:-1]] at hist[pos, pos + n_emit)
            fed = torch.cat([st.last_token[:, None], toks[:, :-1]], dim=1)
            for buf, col, start, vals in (
                    (st.out_buf, out_col, st.n_tok.long(), toks),
                    (st.hist, hist_col, pos, fed)):
                j = col - start[:, None]
                jc = j.clamp(0, Kb - 1)
                hit = (j >= 0) & (j < Kb) & emit.gather(1, jc)
                torch.where(hit, vals.gather(1, jc), buf, out=buf)
            done = act & stopped
            st.cache["pos"] += n_emit.to(torch.int32)   # 0 where inactive
            torch.where(act, toks.gather(1, last)[:, 0], st.last_token,
                        out=st.last_token)
            torch.where(act[:, None], hn.gather(1, last[..., None].expand(
                -1, 1, hn.shape[-1]))[:, 0], st.prev_h, out=st.prev_h)
            st.token_counts.copy_(counts)
            st.n_tok.copy_(n_tok)
            st.active &= ~done
            drafted += ((draft >= 0) & act[:, None]).sum().to(torch.int32)
            accepted += (last[:, 0] * act).sum().to(torch.int32)
            steps += go.to(torch.int32)
            torch.where(go, done, done_out, out=done_out)
            go = go & st.active.any() & ~done.any()
        return done_out, steps, drafted, accepted

    def _ngram_draft(self, hist, pos, last) -> torch.Tensor:
        """Device-side n-gram draft (``engine.py:750``), vectorised over
        slots. ``hist[b, p]`` is the token fed at cache position p (-1:
        none, or evidence). Finds an earlier position j whose context
        ending at ``hist[j]`` matches the suffix ending at the pending
        token ``last``, deepest context (``spec_ngram`` tokens) first and
        backing off to a 1-gram, and proposes the spec_k - 1 tokens that
        followed it; within a depth the most recent match whose followers
        are all known wins over a fresher partial one. Returns (B,
        spec_k - 1) int64, -1 where there is no proposal. Gathers and
        maxima only: capturable."""
        B, H = hist.shape
        n_draft = self.spec_k - 1
        idx = torch.arange(H, device=hist.device)[None, :]
        pos = pos.long()[:, None]
        # j < pos - 1: the latest fed position has no known follower, and
        # its match would shadow an older one that has
        m = (hist == last[:, None]) & (idx < pos - 1)
        full = idx + n_draft < pos

        def pick(m):
            j_full = torch.where(m & full, idx, -1).amax(1)
            j_any = torch.where(m, idx, -1).amax(1)
            return torch.where(j_full >= 0, j_full, j_any)

        j = pick(m)                                   # the 1-gram match
        for g in range(1, self.spec_ngram):
            # the context token g steps before the pending one
            ctx = hist.gather(1, (pos - g).clamp(0, H - 1))
            prev = torch.nn.functional.pad(hist, (g, 0), value=-2)[:, :H]
            m = m & (idx >= g) & (pos >= g) & (prev == ctx) & (ctx >= 0)
            jg = pick(m)
            j = torch.where(jg >= 0, jg, j)           # a deeper match wins
        src = j[:, None] + torch.arange(1, n_draft + 1,
                                        device=hist.device)[None, :]
        ok = (j >= 0)[:, None] & (src < pos)
        return torch.where(ok, hist.gather(1, src.clamp(0, H - 1)), -1)

    def _coverage_k(self, p_star) -> int:
        """A candidate's verify width, 1..spec_k (``engine.py:733``): in
        "coverage" mode it narrows toward 1 as the request's posterior
        coverage deficit closes (``p_star`` None before the first round:
        the full width)."""
        if not self.spec:
            return 1
        if self.spec_mode != "coverage":
            return self.spec_k
        deficit = max(0.0, (1.0 - self.camd.delta) - (p_star or 0.0))
        frac = min(1.0, deficit / max(1e-9, 1.0 - self.camd.delta))
        return 1 + int(round((self.spec_k - 1) * frac))

    def _fill_noise(self, t0: int) -> None:
        """Stage the next launch's noise: ``_noise_buf[i]`` takes the draw
        of global step t0 + i, masked iterations' included, as an eager
        loop would draw them; a speculating engine's launch spans K *
        spec_k steps, each with its acceptance uniforms in
        ``_unif_buf[i]``."""
        if self._noise_buf is None:
            return
        for i in range(self._noise_buf.shape[0]):
            self._noise_buf[i].copy_(
                self.noise.step(t0 + i, self.B, self.V)[self._rows])
            if self._unif_buf is not None:
                self._unif_buf[i].copy_(
                    self.noise.uniform(t0 + i, self.B)[self._rows])

    def _macro_launch(self) -> Tuple[torch.Tensor, ...]:
        """One macro launch of the staged body: eager on the CPU and on a
        gloo rank, a replay of the captured graph on the card (captured at
        the first launch). Returns ``_macro_step``'s outputs."""
        self._fill_noise(self._t)
        if self.device.type != "cuda" or self._eager_body:
            return self._macro_step()
        if self._graph is None:
            self._capture()
        self._graph.replay()
        for name, n in self._graph_launches.items():
            ops.LAUNCHES[name] += n
        return self._graph_out

    @torch.no_grad()
    def _capture(self) -> None:
        """Capture the macro body as one CUDA graph on a side stream,
        after one eager warm-up launch there that loads every kernel
        library and lets cuBLAS and the allocator set up, under
        ``set_sync_debug_mode("error")`` so that a host sync in the body
        raises. The warm-up runs with every slot inactive, so all its
        iterations are masked: the only writes it makes are each row's
        K/V at its current position, which the next real step writes
        again with the same values (the speculative body's go to its sink
        page, or rewrite a dense ring's own values). Its kernel launches
        go to ``_warmup_launches``; the capture's, which launch nothing, become
        the per-replay counts. On a rank mesh (NCCL) the body's collectives
        are captured with it (the engine warmed each group's communicator
        when it was built). Raises if the capture fails."""
        t0 = time.perf_counter()
        st = self.state
        main = torch.cuda.current_stream(self.device)
        side = _capture_stream(self.device)
        active = st.active.clone()
        st.active.zero_()
        side.wait_stream(main)
        before = dict(ops.LAUNCHES)
        mode = torch.cuda.get_sync_debug_mode()
        with torch.cuda.stream(side):
            torch.cuda.set_sync_debug_mode("error")
            try:
                self._macro_step()
            finally:
                torch.cuda.set_sync_debug_mode(mode)
        self._warmup_launches = self._launches_since(before)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            out = self._macro_step()
        self._graph_launches = self._launches_since(before)
        main.wait_stream(side)
        st.active.copy_(active)
        self._graph, self._graph_out = graph, out
        self._graphs_captured += 1
        self._capture_s += time.perf_counter() - t0

    @staticmethod
    def _launches_since(before: Dict[str, int]) -> Dict[str, int]:
        """Take the kernel launches counted since ``before`` back out of
        ``ops.LAUNCHES``; returns them by kernel."""
        made = {k: ops.LAUNCHES[k] - n for k, n in before.items()
                if ops.LAUNCHES[k] > n}
        ops.LAUNCHES.update(before)
        return made

    def _unit_embed(self, tok) -> torch.Tensor:
        """fp32 token embeddings over their norms (+1e-8)."""
        e = self.model.embed(tok).float()
        return e / (torch.linalg.vector_norm(e, dim=-1, keepdim=True) + 1e-8)

    def _step_noise(self, t: int):
        """The legacy loop's noise for global step ``t``."""
        if self.mode == "greedy":
            return None
        return self.noise.step(t, self.B, self.V)[self._rows]

    # ------------------------------------------------------------------
    def submit(self, req: Request):
        if req.uid in self._reqs or any(r.uid == req.uid
                                        for r in self._queue):
            raise ValueError(f"duplicate request uid {req.uid}")
        if req.image is not None and req.evidence is None:
            self._encode_image(req)
        if req.evidence is not None:
            want = (self.cfg.num_evidence_tokens,
                    self.cfg.evidence_dim or self.d)
            if not self.has_evidence or np.shape(req.evidence) != want:
                raise ValueError(
                    f"request {req.uid}: evidence of shape "
                    f"{np.shape(req.evidence)}, but {self.cfg.name} takes "
                    f"{want if self.has_evidence else 'none'}")
        self._arrival[req.uid] = self._submit_seq
        self._submit_seq += 1
        self._queue.append(req)

    def _encode_image(self, req: Request) -> None:
        """Vision-tower encode at submit time (``engine.py:963``): the
        image becomes the request's evidence. Features are memoised by the
        image's content hash, so a repeated image costs a dict lookup."""
        if self.cfg.vision is None:
            raise ValueError(
                f"request {req.uid} carries an image but {self.cfg.name} "
                "has no vision tower (cfg.vision is None)")
        img = np.ascontiguousarray(np.asarray(req.image, np.float32))
        digest = hashlib.sha256(img.tobytes()).digest()
        self._image_digest[req.uid] = digest
        feats = self._image_feats.get(digest)
        if feats is None:
            t0 = time.perf_counter()
            with torch.inference_mode():
                feats = self.model.encode_image(
                    torch.as_tensor(img, device=self.device)[None])[0]
            feats = feats.float().cpu().numpy()
            self.image_encode_s += time.perf_counter() - t0
            self.image_encodes += 1
            self._image_feats[digest] = feats
            while len(self._image_feats) > 64:      # FIFO memo
                self._image_feats.pop(next(iter(self._image_feats)))
        else:
            self.image_feat_hits += 1
        req.evidence = feats

    def _prefix_token_stream(self, req: Request) -> Optional[np.ndarray]:
        """The request's key stream for the prefix cache, one int64 per
        cache position (``engine.py:992``): the prompt, or for an image
        request ``ne`` pseudo-tokens from the image's digest ahead of it.
        None for a request with raw evidence (no content key)."""
        if req.evidence is None:
            return np.asarray(req.prompt, np.int64)
        digest = self._image_digest.get(req.uid)
        if digest is None:
            return None
        ne = self.cfg.num_evidence_tokens
        rep = (digest * (ne * 8 // len(digest) + 1))[:ne * 8]
        pseudo = np.frombuffer(rep, np.int64).copy()
        return np.concatenate([pseudo, np.asarray(req.prompt, np.int64)])

    # -- paged cache plumbing ------------------------------------------
    def _write_pages(self, row, pages: List[int], start: int,
                     broadcast: bool = False):
        """Copy prefill KV of a 1-row dense cache into pool pages, every
        layer at once: consecutive page-sized spans from ``start``, or with
        ``broadcast`` the one span at ``start`` into every page (the
        identical CoW tail copies of a round's candidates). Quantized
        pools take the span quantized once, values and scales, and then
        broadcast, so the copies are bit-identical
        (``repro/serving/engine.py:1268-1310``). A rank writes the pages
        it holds (its range, its mirrors) and skips the rest."""
        local = self._local_pages(pages, held_only=True)
        keep = np.nonzero(local >= 0)[0]
        if not len(keep):
            return
        n, ps = len(keep), self.page_size
        pg = torch.as_tensor(local[keep], device=self.device)
        span = ps if broadcast else len(pages) * ps
        # a rank that holds some of the pages writes their spans only
        at = None if broadcast or n == len(pages) else start + (
            torch.as_tensor(keep, device=self.device)[:, None] * ps +
            torch.arange(ps, device=self.device)[None, :]).reshape(-1)
        cache = self.state.cache
        for name in ("k", "v"):
            pool, spool = cache[f"{name}_pages"], cache.get(f"{name}_scale")
            seg = row[name][:, 0, start:start + span] if at is None else \
                row[name][:, 0].index_select(1, at)      # (nL, span, Hkv, hd)
            seg = seg.reshape(pool.shape[0], -1, *pool.shape[2:])
            if spool is not None:
                seg, sseg = attn_lib.kv_quantize(seg, pool.dtype)
                if broadcast:
                    sseg = sseg.expand(spool.shape[0], n, *spool.shape[2:])
                spool[:, pg] = sseg
            if broadcast:
                seg = seg.expand(pool.shape[0], n, *pool.shape[2:])
            attn_lib._raw(pool)[:, pg] = attn_lib._raw(seg.to(pool.dtype))

    def _page_shard_of(self, info, fallback: Optional[int] = None) -> int:
        """The shard a request's prompt pages live on, chosen once
        (``engine.py:1064``): a prefix hit's held pages pin it; else the
        caller's ``fallback`` (the first admitted slot's shard) or, at
        early-seed time or under disaggregation, the least-loaded prefill
        shard."""
        if "page_shard" not in info:
            held = info.get("prompt_pages")
            if held:
                info["page_shard"] = self.pool.shard_of(held[0])
            elif fallback is not None and not self.prefill_shards:
                info["page_shard"] = fallback
            else:
                info["page_shard"] = self._prefill_shard_pick()
        return info["page_shard"]

    def _prefill_shard_pick(self) -> int:
        """The shard with the most headroom among those that may host
        prompt and chunk pages (the first ``prefill_shards``, or all)."""
        k = self.prefill_shards or self.dp
        return int(np.argmax([self._shard_headroom(s) for s in range(k)]))

    def _seed_prompt_pages(self, info, shard: Optional[int] = None):
        """Allocate and write the request's full prompt pages once (one
        pool hold each, released when the request finishes) on its page
        shard (``_page_shard_of``, ``shard`` the fallback) and register
        them in the prefix cache. A prefix hit arrives holding the cached
        pages; only the rest is written, from the suffix row, whose row
        positions are prompt positions minus ``prefix_len``."""
        if info.get("prompt_seeded"):
            return
        ps = self.page_size
        held = info.setdefault("prompt_pages", [])
        if len(held) * ps != info.get("prefix_len", 0):
            raise RuntimeError(f"{len(held)} held prefix pages for a prefix "
                               f"of {info.get('prefix_len', 0)} positions")
        new_full = self.pool.alloc(info["prompt_len"] // ps - len(held),
                                   self._page_shard_of(info, shard))
        self._write_pages(info["cache_row"], new_full, 0)
        info["prompt_pages"] = held + new_full
        if self.prefix_cache and info.get("cacheable"):
            self.pool.prefix.insert(info["page_keys"], info["prompt_pages"])
        info["prompt_seeded"] = True

    def _maybe_seed_early(self, req: Request):
        """Prefix-cache mode: seed and register the prompt pages at prefill
        time, so that same-prefix requests later in the same pass hit.
        Skipped when the pool could then not fund one worst-case
        candidate; seeding then happens at admission."""
        info = self._reqs[req.uid]
        if not info.get("cacheable") or info.get("prompt_seeded"):
            return
        L = info["prompt_len"]
        need = L // self.page_size - len(info.get("prompt_pages", ()))
        shard = self._page_shard_of(info)
        if self._shard_headroom(shard) - need < self._pages_per_candidate(L):
            return
        self._seed_prompt_pages(info, shard)
        # early seeding must not eat the pages backing live reservations
        self._ensure_reserved_free()

    def _seed_paged_slots(self, info, slot_ids: List[int], lim: int):
        """Point ``slot_ids`` at the request's prompt pages: full pages are
        shared (refcounted), the partial tail page is copied per candidate
        — the copy-on-write point — from the slot's own shard, and the
        rest of a row points at that shard's quarantine page. After a
        prefix hit the request's row starts at ``prefix_len``, so the tail
        is read from there."""
        L = info["prompt_len"]
        ps = self.page_size
        if L + lim > self.cache_len:
            raise ValueError(f"prompt {L} + limit {lim} overflows the paged "
                             f"cache of {self.cache_len} (no ring wrap)")
        full, tail_len = divmod(L, ps)
        row_off = info.get("prefix_len", 0)
        self._seed_prompt_pages(info, self._slot_shard(slot_ids[0]))
        mine, rows = self._own(slot_ids)
        bt_rows = np.repeat(self._slot_quarantine[slot_ids][:, None],
                            self.pages_per_slot, axis=1)
        tails = []
        for j, s in enumerate(slot_ids):
            sh = self._slot_shard(s)
            pages = list(info["prompt_pages"])
            self.pool.share(pages)
            if tail_len:
                tail = self.pool.alloc(1, sh)
                tails += tail
                pages += tail
            self._slot_pages[s] = pages
            self._slot_pos[s] = L
            self._slot_limit[s] = L + lim
            future = self._pages_per_candidate(L, lim) - (1 if tail_len else 0)
            self._slot_reserved[s] = future
            self._reserved_sh[sh] += future
            bt_rows[j, :len(pages)] = pages
        self._write_pages(info["cache_row"], tails, full * ps - row_off,
                          broadcast=True)
        if self.prefix_cache:
            # admission counted evictable pages as headroom: make them free
            # pages now, before a later hit can pin them again
            self._ensure_reserved_free()
        for j in mine:
            self._hold_mirrors(slot_ids[j], info["prompt_pages"], info)
        idx = torch.as_tensor(rows, device=self.device)
        cache = self.state.cache
        cache["block_table"][idx] = torch.as_tensor(
            self._local_pages(bt_rows[mine]), device=self.device)
        cache["pos"][idx] = L

    def _quarantine_rows(self, slots: List[int]) -> None:
        """Point the block-table rows of ``slots`` at their own shards'
        quarantine pages, in place (the captured graph keeps its
        addresses)."""
        mine, rows = self._own(slots)
        q = torch.as_tensor(self._local_pages(
            self._slot_quarantine[np.asarray(slots)[mine]]),
            device=self.device)
        self.state.cache["block_table"][
            torch.as_tensor(rows, device=self.device)] = q[:, None]

    def _pages_per_candidate(self, prompt_len: int,
                             lim: Optional[int] = None) -> int:
        """Pages a candidate may allocate beyond the shared prompt pages:
        its tail copy plus every boundary crossed decoding ``lim`` tokens."""
        lim = self.max_new if lim is None else lim
        return -((prompt_len + lim) // -self.page_size) - \
            prompt_len // self.page_size

    def _ensure_reserved_free(self):
        """Back every live reservation with free pages of its own shard
        (evicting cached-only prefix pages where needed)."""
        for s in range(self.dp):
            self.pool.ensure_free(int(self._reserved_sh[s]), s)

    def _paged_affordable(self, info, want: int,
                          lim: Optional[int] = None) -> int:
        """Candidates of this request the pool can fund right now, shard by
        shard (``engine.py:1220-1268``): walk the free slots an admission
        would take, in the order it takes them, and fund each candidate
        from its slot's own shard's headroom, the unseeded part of the
        prompt hold from the request's page shard; a hold its shard cannot
        fund admits nothing. With one shard this is the headroom minus
        the hold, over the pages a candidate needs."""
        L = info["prompt_len"]
        per_cand = self._pages_per_candidate(L, lim)
        need_hold = 0 if info.get("prompt_seeded") else \
            L // self.page_size - len(info.get("prompt_pages", ()))
        free = self._free_slots()[:want]
        if not free:
            return 0
        avail = [self._shard_headroom(s) for s in range(self.dp)]
        held = info.get("prompt_pages")
        if "page_shard" in info:
            hold_shard = info["page_shard"]
        elif held:
            hold_shard = self.pool.shard_of(held[0])
        elif self.prefill_shards:
            hold_shard = self._prefill_shard_pick()
        else:
            hold_shard = self._slot_shard(free[0])
        avail[hold_shard] -= need_hold
        if avail[hold_shard] < 0:
            return 0
        take = 0
        for slot in free:
            sh = self._slot_shard(slot)
            if avail[sh] < per_cand:
                break
            avail[sh] -= per_cand
            take += 1
        return take

    @staticmethod
    def _page_crossings(lo: int, hi: int, ps: int) -> int:
        """Page boundaries a write position crosses over [lo, hi)."""
        return -(-hi // ps) - (-(-lo // ps))

    def _stage_frontier(self):
        """Stage each live slot's next pages for one macro launch, out of
        its admission-time reservation and its own shard, into the static
        (B, F) ``_frontier`` (entries past them hold the slot's
        quarantine page). Returns {slot: (start_pos, pages)}."""
        fr = np.repeat(self._slot_quarantine[:, None], self._frontier_width,
                       axis=1)
        staged: Dict[int, Tuple[int, List[int]]] = {}
        ps = self.page_size
        for s in range(self.B):
            if self._slot_req[s] < 0:
                continue
            p = int(self._slot_pos[s])
            # worst-case advance: K iterations of the slot's verify width
            adv = max(self.macro_steps, 1) * int(self._slot_spec[s])
            hi = min(p + adv, int(self._slot_limit[s]))
            need = self._page_crossings(p, hi, ps)
            pages: List[int] = []
            if need > 0:
                if need > self._slot_reserved[s]:
                    raise RuntimeError(f"slot {s} needs {need} frontier "
                                       f"pages, reserved "
                                       f"{self._slot_reserved[s]}")
                sh = self._slot_shard(s)
                pages = self.pool.stage_frontier(need, sh)
                self._slot_reserved[s] -= need
                self._reserved_sh[sh] -= need
                fr[s, :need] = pages
            staged[s] = (p, pages)
        self._frontier.copy_(torch.from_numpy(self._local_pages(
            fr[self._rows])))
        return staged

    def _reclaim_frontier(self, staged, pos_np):
        """After a launch: the consumed frontier prefix becomes slot pages,
        the rest returns to the pool and to the slot's reservation."""
        for s, (p0, pages) in staged.items():
            p1 = int(pos_np[s])
            used = self._page_crossings(p0, p1, self.page_size)
            if used > len(pages):
                raise RuntimeError(f"slot {s} advanced past its frontier")
            self._slot_pages[s] += pages[:used]
            unused = pages[used:]
            if unused:
                self.pool.return_frontier(unused)
                self._slot_reserved[s] += len(unused)
                self._reserved_sh[self._slot_shard(s)] += len(unused)
            self._slot_pos[s] = p1

    def _alloc_step_pages(self):
        """Legacy loop only: before each step hand a fresh page to every
        live slot whose next write starts a page, mirrored into the
        device block table."""
        rows, cols, vals = [], [], []
        for s in range(self.B):
            if self._slot_req[s] < 0:
                continue
            p = int(self._slot_pos[s])
            if p % self.page_size == 0:
                li = p // self.page_size
                if li >= self.pages_per_slot:
                    raise RuntimeError(f"slot {s} ran past the paged cache "
                                       f"({p} >= {self.cache_len})")
                page = self.pool.alloc(1, self._slot_shard(s))[0]
                self._slot_pages[s].append(page)
                if self._slot_reserved[s] > 0:
                    self._slot_reserved[s] -= 1
                    self._reserved_sh[self._slot_shard(s)] -= 1
                rows.append(s)
                cols.append(li)
                vals.append(page)
            self._slot_pos[s] += 1
        mine, local_rows = self._own(rows)
        if len(mine):
            bt = self.state.cache["block_table"]
            bt[torch.as_tensor(local_rows, device=self.device),
               torch.as_tensor(np.asarray(cols)[mine], device=self.device)] = \
                torch.as_tensor(self._local_pages(np.asarray(vals)[mine]),
                                device=self.device)

    def _bytes_per_page(self) -> int:
        """Resident bytes of one pool page over every layer, values and
        int8/fp8 scales alike; every pool leaf has its page axis second
        (``repro/serving/engine.py:1444-1458``). A model rank holds its
        share of the kv heads: the page's bytes are its times the model
        axis, as the byte budget reckons them on one device."""
        cache = self.state.cache
        m = 1 if self.world is None else self.world.model
        return m * sum(cache[k][:, 0].numel() * cache[k].element_size()
                       for k in ("k_pages", "v_pages", "k_scale", "v_scale")
                       if k in cache)

    def kv_stats(self) -> Dict[str, Any]:
        """Pool accounting with resident KV bytes against the dense worst
        case (slots x cache_len) the paged layout replaces, and the prefix
        cache's hits (``engine.py:1462``)."""
        if not self.paged:
            raise ValueError("kv_stats needs a paged impl")
        stats = self.pool.stats()
        bpp = self._bytes_per_page()
        stats.update(kv_dtype=self.kv_dtype, bytes_per_page=bpp,
                     resident_kv_bytes=stats["in_use"] * bpp,
                     peak_kv_bytes=stats["max_in_use"] * bpp,
                     dense_equiv_bytes=self.B * self.pages_per_slot * bpp)
        if self.pool.prefix is not None:
            stats["prefix_cache"] = dict(self.pool.prefix.stats(),
                                         bytes_saved=self.pool.prefix.hits
                                         * bpp)
        return stats

    def sched_stats(self) -> Dict[str, Any]:
        s = dict(self.scheduler.stats())
        s.update(starved=len(self.starved_uids),
                 prefill_calls=self.prefill_calls,
                 prefill_tokens=self.prefill_tokens,
                 chunk_calls=self.chunk_calls,
                 chunk_tokens=self.chunk_tokens,
                 cancelled_requests=self.cancelled_requests,
                 image_encodes=self.image_encodes,
                 image_feat_hits=self.image_feat_hits)
        return s

    def reset_stats(self) -> None:
        """Zero the telemetry for reuse of the engine across runs; serving
        state (requests, budget ledgers, the prefix cache's chains, the
        decode step ``_t``) stays."""
        self.total_steps = self.total_tokens = 0
        self.macro_launches = self.host_syncs = 0
        self.spec_drafted = self.spec_accepted = 0
        self.prefill_calls = self.prefill_tokens = 0
        self.chunk_calls = self.chunk_tokens = 0
        self.cancelled_requests = 0
        self.image_encodes = self.image_feat_hits = 0
        self.image_encode_s = 0.0
        self.xmodal_rescored = self.xmodal_parted = 0
        self.starved_uids.clear()
        self.scheduler.reset_stats()
        if self.paged:
            self.pool.reset_stats()
        if self.arena is not None:
            self.arena.reset_stats()
            self.row_mirror_peak = len(self._row_mirror)
            self.row_fetches = 0

    # -- async front-end hooks -------------------------------------------
    def has_work(self) -> bool:
        """Anything live, queued or pending a round."""
        return self._any_live() or self._has_pending()

    def drain_stream_events(self) -> List[Tuple[int, int, np.ndarray]]:
        """Token deltas ``(uid, cand_uid, tokens)`` emitted since the last
        drain (with ``stream_tokens`` on)."""
        ev, self.stream_events = self.stream_events, []
        return ev

    def pop_finished(self) -> List[int]:
        """Uids finalized since the last call (completion and cancel)."""
        done, self._newly_done = self._newly_done, []
        return done

    # -- admission -----------------------------------------------------
    def _admit(self, req: Request, slot_ids: List[int],
               limit: Optional[int] = None):
        """Seed slots with the request's prompt cache and sample the first
        token of each candidate from the prefill logits in one batched
        draw. ``limit`` is the scheduler's per-candidate token grant."""
        lim = self.max_new if limit is None else min(int(limit),
                                                     self.max_new)
        info = self._reqs[req.uid]
        st = self.state
        if self.spec and not self.paged and \
                info["prompt_len"] + lim > self.cache_len:
            # a verify block past cache_len would wrap onto a live position
            raise ValueError(f"prompt {info['prompt_len']} + limit {lim} "
                             f"overflows the cache of {self.cache_len} "
                             "(speculation does not ring-wrap)")
        # every candidate's first token is drawn (the same draws on every
        # rank); the slots' rows this process holds take theirs
        mine, rows = self._own(slot_ids)
        idx = torch.as_tensor(rows, device=self.device)
        n, m = len(slot_ids), len(rows)
        if self.paged:
            self._seed_paged_slots(info, slot_ids, lim)
        else:
            self._fetch_row(info, slot_ids)
            if m:
                self._put_rows(st.cache, idx, self._request_row(info))
        bias = info.get("bias")
        toks, lps = sample_token_batch(info["prefill_logits"], self.sampling,
                                       bias=bias, greedy=self._greedy_row,
                                       noise=self.noise.first(n, self.V))
        pick = torch.as_tensor(mine, device=self.device)
        toks, lps = toks[pick], lps[pick]
        h0 = info["prefill_hidden"]
        hn0 = h0 / (torch.linalg.vector_norm(h0, dim=-1, keepdim=True) + 1e-8)
        if self.has_evidence:
            # the first token's alignment (engine.py:1599-1606)
            st.align_sum[idx] = (self._unit_embed(toks) @
                                 info["evid_row"][0].T).mean(-1)
        else:
            st.align_sum[idx] = 0.0
        st.last_token[idx] = toks
        st.token_counts[idx] = torch.nn.functional.one_hot(
            toks, self.V).float()
        st.sum_lp[idx] = lps
        st.n_tok[idx] = 1
        st.prev_h[idx] = hn0.expand(m, -1)
        st.sum_coh[idx] = 0.0
        st.sum_emb[idx] = 0.0
        st.active[idx] = True
        out = torch.zeros((m, self.max_new), dtype=torch.long,
                          device=self.device)
        out[:, 0] = toks
        st.out_buf[idx] = out
        st.bias[idx] = 0.0 if bias is None else bias.expand(m, -1)
        st.greedy[idx] = self.mode == "greedy"
        st.limit[idx] = lim
        k_eff = self._coverage_k(info.get("p_star"))
        if self.spec:
            # the n-gram table: the prompt at its cache positions (evidence
            # rows stay -1 and never match); the first sampled token is
            # pending, fed by the first verify block
            ne = info["prompt_len"] - len(req.prompt)
            row = torch.full((self.cache_len,), -1, dtype=torch.long,
                             device=self.device)
            row[ne:info["prompt_len"]] = torch.as_tensor(
                np.asarray(req.prompt, np.int64), device=self.device)
            st.hist[idx] = row
            st.spec_k[idx] = k_eff
        for s in slot_ids:
            self._slot_req[s] = req.uid
            self._slot_cand[s] = self._next_cand
            self._slot_lim[s] = lim
            self._slot_spec[s] = k_eff
            self._slot_streamed[s] = 0
            info["cand_slots"].append((self._next_cand, s))
            self._next_cand += 1
        if self.dp > 1:
            self.scheduler.note_shard_admission(
                self._slot_shard(s) for s in slot_ids)

    # -- prefill -------------------------------------------------------
    def _prompt_span(self, req: Request) -> int:
        """Cache positions the prompt occupies, evidence rows included
        (``engine.py:1657``): an encoder-decoder's evidence feeds the
        encoder instead."""
        ne = self.cfg.num_evidence_tokens \
            if (req.evidence is not None and
                not self.cfg.is_encoder_decoder) else 0
        return len(req.prompt) + ne

    def _init_info(self, req: Request, cache_row, lg, h, prompt_len: int):
        info = {
            "req": req, "cache_row": cache_row,
            "prefill_logits": lg.float(), "prefill_hidden": h.float(),
            "prompt_len": prompt_len,
            "camd": ctrl.init_state(self.camd, 1, self.d, self.V,
                                    self.device),
            "bias": None, "round": 0, "cand_slots": [], "records": {},
            "align_const": 0.0, "done": False}
        if self.has_evidence and req.evidence is not None:
            # engine.py:1680-1715
            evp = torch.as_tensor(req.evidence, dtype=torch.float32,
                                  device=self.device)
            if self.model.evidence_proj is not None:
                evp = self.model.project_evidence(evp)
            evn = evp / (torch.linalg.vector_norm(evp, dim=-1, keepdim=True)
                         + 1e-8)
            info["evid_row"] = evn[None]
            # Eq. 8 term 2: prompt-token embeddings against the evidence,
            # constant per request
            temb = self._unit_embed(torch.as_tensor(
                np.asarray(req.prompt, np.int64), device=self.device))
            if self.xmodal_rescore:
                info["text_row"] = temb[None]                # (1, L, d)
            sim = temb @ evn.T                               # (L, Ne)
            stats = [sim.amax(-1).mean()]
            ne_ev = int(evn.shape[0])
            if ne_ev > 1:
                # the coverage scheduler's difficulty prior: normalised
                # entropy of each prompt token's evidence attachment
                p_att = torch.softmax(sim, dim=-1)
                stats.append(-(p_att * torch.log(p_att + 1e-9)).sum(-1)
                             .mean())
            vals = torch.stack(stats).tolist()
            info["align_const"] = vals[0]
            info["evidence_entropy"] = \
                vals[1] / float(np.log(ne_ev)) if ne_ev > 1 else 0.0
        else:
            info["evid_row"] = torch.zeros((1, 1, self.d),
                                           device=self.device)
        self._reqs[req.uid] = info
        self._arena_put(info)

    # -- cache rows and the state arena ---------------------------------
    @staticmethod
    def _cache_row(cache, i: int) -> Dict[str, torch.Tensor]:
        """Row ``i`` of a dense cache as a 1-row view: every leaf has its
        batch on axis 1 but ``pos`` (``models/transformer.py``)."""
        return {name: leaf[i:i + 1] if name == "pos" else leaf[:, i:i + 1]
                for name, leaf in cache.items()}

    @staticmethod
    def _put_rows(cache, idx, row) -> None:
        """Copy a 1-row cache into rows ``idx`` of ``cache``, leaf by leaf
        (in place)."""
        for name, leaf in row.items():
            if name == "pos":
                cache["pos"][idx] = leaf
            else:
                cache[name][:, idx] = leaf.to(cache[name].dtype)

    def _arena_put(self, info) -> None:
        """Move a freshly prefilled prompt row into a state-arena row,
        held until ``_finish_request`` (``engine.py:1041-1053``), so that
        prefilled but unadmitted recurrent state is bounded and
        counted. On a rank the row is written only by the data rank of
        its shard; the others drop their prefill row."""
        if self.arena is None or info.get("cache_row") is None:
            return
        r = self.arena.alloc(1, self.arena.best_shard())[0]
        loc = self._arena_local(r)
        if loc is not None:
            self._put_rows(self._arena_buf,
                           torch.tensor([loc], device=self.device),
                           info["cache_row"])
        info["cache_row"] = None
        info["arena_row"] = r

    def _arena_local(self, r: int) -> Optional[int]:
        """Row ``r``'s index in this process's arena buffer: a rank's own
        block shifted to 0 or its mirror row; None where it holds
        neither."""
        loc = r - self._arena_row0
        if 0 <= loc < self._arena_own:
            return loc
        return self._row_mirror.get(r)

    def _fetch_row(self, info, slot_ids: List[int]) -> None:
        """On a rank mesh, before slots ``slot_ids`` are seeded from the
        request's arena row: when a slot lies on another shard than the
        row, the row's data rank broadcasts it over the data group (one
        collective: every leaf's bytes), and each rank whose slots read
        it keeps it in a mirror row, held until those slots let go
        (``_drop_row_mirror``). The shared prompt pages of a paged engine
        are mirrored from each rank's own prefill row
        (``_hold_mirrors``); a recurrent row is not, since it serves the
        request's later rounds long after that prefill row is gone."""
        r = info.get("arena_row")
        if r is None or self.world is None or self.dp == 1:
            return
        src = self.arena.shard_of(r)
        if all(self._slot_shard(s) == src for s in slot_ids):
            return
        row = self._cache_row(self._arena_buf, 0)     # the leaves' layout
        mine = [slot_ids[j] for j in self._own(slot_ids)[0]]
        here = self.world.coords[0]
        if here == src:
            buf = torch.cat([t.contiguous().reshape(-1).view(torch.uint8)
                             for t in self._request_row(info).values()])
        else:
            buf = torch.empty(sum(t.numel() * t.element_size()
                                  for t in row.values()),
                              dtype=torch.uint8, device=self.device)
        self.world.broadcast_data(buf, src)
        self.row_fetches += 1
        if here == src or not mine:
            return
        if r not in self._row_mirror:
            loc = self._row_mirror_free.pop()
            self._row_mirror[r] = loc
            parts, off = {}, 0
            for k, t in row.items():
                n = t.numel() * t.element_size()
                parts[k] = buf[off:off + n].view(t.dtype).reshape(t.shape)
                off += n
            self._put_rows(self._arena_buf,
                           torch.tensor([loc], device=self.device), parts)
        for s in mine:
            self._row_mirror_refs[r] = self._row_mirror_refs.get(r, 0) + 1
            self._slot_row_mirror[s] = r
        self.row_mirror_peak = max(self.row_mirror_peak,
                                   len(self._row_mirror))

    def _drop_row_mirror(self, s: int) -> None:
        """Slot ``s`` lets go of the mirror row it was seeded from."""
        r = self._slot_row_mirror.pop(s, None)
        if r is None:
            return
        self._row_mirror_refs[r] -= 1
        if not self._row_mirror_refs[r]:
            del self._row_mirror_refs[r]
            self._row_mirror_free.append(self._row_mirror.pop(r))

    def _request_row(self, info):
        """The request's 1-row prompt cache: a view of its arena row on a
        recurrent or hybrid engine (a rank's own row or mirror), its own
        prefill row otherwise."""
        r = info.get("arena_row")
        if r is not None:
            return self._cache_row(self._arena_buf, self._arena_local(r))
        return info["cache_row"]

    def arena_stats(self) -> Dict[str, Any]:
        """State-arena telemetry of a recurrent or hybrid engine, ``{}``
        on a kv one (``engine.py:1501-1515``): the arena's counters, the
        bytes of one row over every cache leaf and the bytes the arena
        holds resident, of the whole arena over every rank, as the
        reference reports them. A rank adds ``"rank"``: the rows its
        buffer holds (its shard's block and its mirror rows), their bytes
        at its widths, the bytes resident on it (block plus mirrors), the
        mirror rows held now and at peak, and the rows fetched from
        another shard."""
        if self.arena is None:
            return {}
        s: Dict[str, Any] = dict(self.arena.stats())
        s["state_kind"] = self.state_kind
        # a whole row, at the config's widths
        bpr = sum(int(np.prod(shape)) * self._arena_buf[k].element_size()
                  for k, shape in self._whole_cache(1).items())
        s["bytes_per_row"] = int(bpr)
        s["resident_state_bytes"] = int(bpr) * self.arena.num_rows
        if self.world is not None:
            held = self._arena_own + self._n_row_mirror
            local = sum(leaf.numel() // held * leaf.element_size()
                        for leaf in self._arena_buf.values())
            s["rank"] = {
                "rows": self._arena_own, "mirror_rows": self._n_row_mirror,
                "bytes_per_row": int(local),
                "resident_state_bytes": int(local) * held,
                "mirrors_held": len(self._row_mirror),
                "mirror_peak": self.row_mirror_peak,
                "row_fetches": self.row_fetches}
        return s

    def _evidence(self, reqs: List[Request], rows: int):
        """(rows, Ne, De) evidence of ``reqs`` (which all carry evidence,
        or none) in the param dtype, zero rows past them; None for
        text-only requests."""
        if reqs[0].evidence is None:
            return None
        ev = np.zeros((rows,) + np.shape(reqs[0].evidence), np.float32)
        for i, r in enumerate(reqs):
            ev[i] = r.evidence
        return torch.as_tensor(ev, device=self.device).to(self._dtype)

    def _prefill_request(self, req: Request):
        """Unbucketed path: one prefill call for one request."""
        prompt = torch.as_tensor(np.asarray(req.prompt, np.int64),
                                 device=self.device)[None]
        row = self.model.make_cache(1, self.cache_len, self._dtype)
        lg, h, row = self.model.prefill(prompt, row,
                                        self._evidence([req], 1),
                                        impl=self._model_impl)
        self.prefill_calls += 1
        self.prefill_tokens += self._prompt_span(req)
        self._init_info(req, row, lg, h, self._prompt_span(req))

    # -- cross-request prefix cache ------------------------------------
    def _mark_cacheable(self, req: Request):
        """Record the request's page keys, so that its prompt pages are
        registered in the prefix cache when they are seeded."""
        stream = self._prefix_token_stream(req)
        if not self.prefix_cache or stream is None:
            return
        info = self._reqs[req.uid]
        info["page_keys"] = prefix_page_keys(stream, self.page_size)
        info["cacheable"] = True

    def _probe(self, stream: np.ndarray, ne: int):
        """Hold the cached pages of the longest cached prefix of
        ``stream``, at most ``(len - 1) // page_size`` pages so that one
        token is left to give the last logits. A hit that ends inside the
        image span (``ne`` positions of embeddings, no tokens to resume
        from) is released. Returns (pages held, the stream's page
        keys)."""
        keys = prefix_page_keys(stream, self.page_size)
        usable = (len(stream) - 1) // self.page_size
        if usable <= 0:
            return [], keys
        pages = self.pool.prefix.match_and_hold(keys[:usable])
        if pages and len(pages) * self.page_size < ne:
            self.pool.free(pages)
            return [], keys
        return pages, keys

    def _try_prefill_suffix(self, req: Request) -> bool:
        """Prefix-cache fast path (``engine.py:1745``): hold the cached
        pages of the key stream's longest cached prefix and prefill only
        the suffix against their K/V. Returns False on a miss."""
        stream = self._prefix_token_stream(req)
        if not self.prefix_cache or stream is None:
            return False
        pages, keys = self._probe(stream, len(stream) - len(req.prompt))
        if not pages:
            return False
        start = len(pages) * self.page_size
        suffix = torch.as_tensor(stream[start:], device=self.device)[None]
        row = self.model.make_cache(1, self.cache_len, self._dtype)
        lg, h, row = self.model.prefill_suffix(
            suffix, row, self._gather_prefix_ctx(pages), start,
            impl=self._model_impl)
        self.prefill_calls += 1
        self.prefill_tokens += len(stream) - start          # suffix only
        self._init_info(req, row, lg, h, len(stream))
        self._reqs[req.uid].update(prompt_pages=pages, prefix_len=start,
                                   page_keys=keys, cacheable=True)
        return True

    def _gather_prefix_ctx(self, pages: List[int]) -> Dict[str, torch.Tensor]:
        """The cached pages' K/V as context for a suffix prefill:
        {"k", "v": (num_layers, 1, n * page_size, Hkv, hd)}, dequantized
        for int8/fp8 pools (``engine.py:1787``)."""
        pg = torch.as_tensor(self._local_pages(pages), device=self.device)
        cache = self.state.cache
        ctx = {}
        for name in ("k", "v"):
            pool = cache[f"{name}_pages"]
            x = attn_lib._raw(pool)[:, pg].view(pool.dtype)
            x = x.reshape(pool.shape[0], 1, -1, *pool.shape[3:])
            spool = cache.get(f"{name}_scale")
            if spool is not None:
                x = attn_lib.kv_dequantize(x, spool[:, pg].reshape(
                    spool.shape[0], 1, -1, spool.shape[-1]))
            ctx[name] = x
        return ctx

    # -- chunked prefill -------------------------------------------------
    def _start_chunk_job(self, req: Request) -> None:
        """Open a chunked-prefill job for a long prompt (``engine.py:1826``):
        a prefix hit's pages are its first chunks, already resident. When
        at most one chunk is left to run, the one-shot paths serve better
        and no job is opened."""
        stream = self._prefix_token_stream(req)
        pages = self._probe(stream, len(stream) - len(req.prompt))[0] \
            if self.prefix_cache else []
        cur = len(pages) * self.page_size
        if len(stream) - cur <= self.chunk:
            if pages:
                self.pool.free(pages)             # the probe's hold
            return
        # the shard the whole prompt's pages will live on
        shard = self.pool.shard_of(pages[0]) if pages \
            else self._prefill_shard_pick()
        self._chunking[req.uid] = {"req": req, "pos": cur, "pages": pages,
                                   "shard": shard}

    def _run_chunk(self, uid: int, job: Dict[str, Any]) -> int:
        """Advance one job by one chunk (``engine.py:1860``); returns the
        chunk's tokens, or 0 when the pool cannot fund its pages yet.

        A non-final chunk writes its K/V into fresh pool pages. The final
        chunk keeps its row and makes the job a request record as a
        prefix hit's suffix prefill would (prompt pages = the chunks'
        pages, prefix_len = the cursor)."""
        req = job["req"]
        stream = self._prefix_token_stream(req)
        ne = len(stream) - len(req.prompt)
        L, cur, ps = len(stream), job["pos"], self.page_size
        final = L - cur <= self.chunk
        take = L - cur if final else self.chunk
        if not final:
            # keep one worst-case candidate fundable after this chunk
            need = take // ps
            if self._shard_headroom(job["shard"]) - need < \
                    self._pages_per_candidate(L):
                return 0
        row = self.model.make_cache(1, self.cache_len, self._dtype)
        if cur == 0:
            # the first chunk carries the whole image span (jobs open only
            # where a chunk exceeds it), as evidence rows through the
            # normal prefill, and the rest as tokens
            toks = torch.as_tensor(np.asarray(req.prompt[:take - ne],
                                              np.int64), device=self.device)
            lg, h, row = self.model.prefill(
                toks[None], row, self._evidence([req], 1) if ne else None,
                impl=self._model_impl)
        else:
            toks = torch.as_tensor(stream[cur:cur + take], device=self.device)
            lg, h, row = self.model.prefill_suffix(
                toks[None], row, self._gather_prefix_ctx(job["pages"]), cur,
                impl=self._model_impl)
        self.chunk_calls += 1
        self.chunk_tokens += take
        if not final:
            new_pages = self.pool.alloc(need, job["shard"])
            # the chunk's row holds positions [cur, cur + take) at [0, take)
            self._write_pages(row, new_pages, 0)
            job["pages"] = job["pages"] + new_pages
            job["pos"] = cur + take
            return take
        del self._chunking[uid]
        self.prefill_calls += 1
        self.prefill_tokens += take
        self._init_info(req, row, lg, h, L)
        info = self._reqs[uid]
        info["prompt_pages"] = job["pages"]      # the job's holds carry over
        info["prefix_len"] = cur
        info["page_shard"] = job["shard"]
        if self.prefix_cache:
            info["page_keys"] = prefix_page_keys(stream, ps)
            info["cacheable"] = True
            self._maybe_seed_early(req)
        return take

    def _prefill_chunks(self) -> None:
        """One chunked-prefill pass (``engine.py:1930``): open jobs for the
        long prompts in the admission window, then spend the turn's
        chunk-token budget on the jobs in the policy's order. With no slot
        decoding the budget is ignored, but the pass stops as soon as a
        job completes, so that its request is admitted at once."""
        if not self.chunked:
            return
        ne = self.cfg.num_evidence_tokens
        for r in self._queue[:max(self.B, 4)]:
            if r.uid in self._reqs or r.uid in self._chunking:
                continue
            stream = self._prefix_token_stream(r)
            if stream is None or len(stream) <= self.chunk:
                continue
            if len(stream) > len(r.prompt) and self.chunk <= ne:
                continue        # the image span fits no chunk: one shot
            self._start_chunk_job(r)
        if not self._chunking:
            return
        items = [PrefillWork(uid=uid, arrival=self._arrival[uid],
                             prompt_len=len(job["req"].prompt),
                             prefilled=job["pos"])
                 for uid, job in self._chunking.items()]
        idle = not self._any_live()
        for w in self.scheduler.prefill_order(items):
            while True:
                job = self._chunking.get(w.uid)
                if job is None:
                    if idle:
                        return       # a request just became admissible
                    break
                if not idle and self._chunk_left <= 0:
                    return
                took = self._run_chunk(w.uid, job)
                if took == 0:
                    break            # the pool cannot fund the chunk yet
                self._chunk_left -= took
                self._chunk_progress = True

    def _bucket_len(self, prompt_len: int) -> int:
        return _next_pow2(max(prompt_len, self.prefill_bucket_min))

    def _prefill_pending(self):
        """Advance the chunk jobs, then prefill the queued requests that
        have no cache yet (a bounded queue prefix), batching same-bucket
        prompts — right-padded to a power-of-two length — into one
        prefill call each. With the prefix cache, a hit prefills only its
        suffix, and every cacheable miss is prefilled alone with its pages
        seeded at once, so that later requests of the same pass hit too
        (``engine.py:1975``)."""
        self._prefill_chunks()
        ahead = max(self.B, 4)
        pending = [r for r in self._queue[:ahead]
                   if r.uid not in self._reqs and r.uid not in self._chunking]
        if self.arena is not None and len(pending) > self.arena.free_rows:
            # arena-bounded prefill-ahead: the overflow waits for a pass
            # with free rows (engine.py:1988-1992)
            self.arena.sizing_stalls += 1
            pending = pending[:self.arena.free_rows]
        if self.prefix_cache:
            misses = []
            for r in pending:
                if self._try_prefill_suffix(r):
                    self._maybe_seed_early(r)
                elif self._prefix_token_stream(r) is not None:
                    self._prefill_request(r)
                    self._mark_cacheable(r)
                    self._maybe_seed_early(r)
                else:
                    misses.append(r)
            pending = misses
        if not pending:
            return
        if not self.bucket_prefill:
            for r in pending:
                self._prefill_request(r)
            return
        # groups share a padded token bucket and an evidence count; only
        # the token part is padded
        groups: Dict[Tuple[int, int], List[Request]] = {}
        for r in pending:
            ne = self.cfg.num_evidence_tokens if r.evidence is not None else 0
            groups.setdefault((self._bucket_len(len(r.prompt)), ne),
                              []).append(r)
        for (Lb, ne), reqs in sorted(groups.items()):
            if Lb + ne > min(self._min_ring, self.cache_len):
                for r in reqs:          # the padded bucket would wrap a ring
                    self._prefill_request(r)
            else:
                self._prefill_bucket(Lb, ne, reqs)

    def _prefill_bucket(self, Lb: int, ne: int, reqs: List[Request]):
        n = len(reqs)
        nb = _next_pow2(n)          # row counts bucket too, as the reference
        toks = np.zeros((nb, Lb), np.int64)
        lens = np.full((nb,), Lb + ne, np.int32)   # dummy rows: full length
        for i, r in enumerate(reqs):
            toks[i, :len(r.prompt)] = r.prompt
            lens[i] = len(r.prompt) + ne
        cache = self.model.make_cache(nb, self.cache_len, self._dtype)
        lg, h, cache = self.model.prefill(
            torch.as_tensor(toks, device=self.device), cache,
            self._evidence(reqs, nb), impl=self._model_impl,
            lengths=torch.as_tensor(lens, device=self.device))
        self.prefill_calls += 1
        self.prefill_tokens += int(lens[:n].sum())
        for i, r in enumerate(reqs):
            self._init_info(r, self._cache_row(cache, i), lg[i:i + 1],
                            h[i:i + 1], int(lens[i]))

    # -- scheduling ------------------------------------------------------
    def _free_slots(self) -> List[int]:
        return [i for i in range(self.B) if self._slot_req[i] < 0]

    def _per_round(self) -> int:
        if self.mode == "greedy":
            return 1
        if self.mode == "camd":
            return self.camd.samples_per_round
        return min(self.n_candidates, self.B)

    def _schedule(self):
        """Prefill what is queued, then let the traffic policy fill the
        free slots (paged engines admit only what the pool can fund) and
        stage the slots' evidence rows for the next launches. They are
        staged after every pass, also on a chunk turn, where the reference
        leaves them stale until the next completion (R5 in ROADMAP)."""
        self._prefill_pending()
        self.scheduler.schedule(_EngineSchedContext(self))
        if self.has_evidence:
            self._evid.copy_(self._gather_evid())

    def _needed(self, info) -> int:
        if self.mode == "camd":
            return self.camd.samples_per_round
        running = sum(1 for _, s in info["cand_slots"]
                      if self._slot_req[s] == info["req"].uid)
        return max(0, self.n_candidates - len(info["records"]) - running)

    # -- completion ------------------------------------------------------
    def _xmodal_scores(self, cands) -> List[float]:
        """S_align of finished candidates by the cross-modal score
        (``engine.py:2091``), one K4 call each: ``cands`` holds (tokens,
        evid_row, text_row), the tokens padded to ``max_new`` and masked
        and embedded in one call. The kernel impls run K4, the plain ones
        its plain version. Over ranks every rank scores the same
        candidates from the same inputs and takes rank 0's values (one
        broadcast over the world), so that every rank makes the same CAMD
        decisions; ``xmodal_parted`` counts the candidates whose own value
        differed."""
        if not cands:
            return []
        toks = np.zeros((len(cands), self.max_new), np.int64)
        for i, (t, _, _) in enumerate(cands):
            toks[i, :len(t)] = t
        lens = np.asarray([len(t) for t, _, _ in cands])
        mask = torch.as_tensor(np.arange(self.max_new)[None, :] <
                               lens[:, None], dtype=torch.float32,
                               device=self.device)
        emb = self._unit_embed(torch.as_tensor(toks, device=self.device))
        fn = ops.xmodal_score if self._model_impl == "cuda" \
            else ref.xmodal_score_ref
        vals = torch.cat([fn(emb[i:i + 1], mask[i:i + 1], ev, tx)
                          for i, (_, ev, tx) in enumerate(cands)])
        self.xmodal_rescored += len(cands)
        if self.world is not None and self.world.size > 1:
            own = vals.clone()
            self.world.broadcast(vals)
            self.xmodal_parted += int((own != vals).sum())
        return vals.tolist()

    def _finish_candidates(self, slots: List[int]):
        """Fold finished slots into candidate records with one batched
        readback, then host bookkeeping; completed rounds fold next."""
        st = self.state
        idx = torch.as_tensor(slots, device=self.device)
        out_buf, sum_lp, n_tok, sum_coh, sum_emb, align_sum, counts = \
            self._sync(tuple(self._all_rows(t)[idx] for t in (
                st.out_buf, st.sum_lp, st.n_tok, st.sum_coh, st.sum_emb,
                st.align_sum, st.token_counts)))
        # the cross-modal S_align of every candidate that has one, scored
        # together
        rescore = {}
        for j, slot in enumerate(slots):
            info = self._reqs[int(self._slot_req[slot])]
            if self.xmodal_rescore and n_tok[j] > 0 and "text_row" in info:
                rescore[j] = (out_buf[j][:n_tok[j]], info["evid_row"],
                              info["text_row"])
        s_xm = dict(zip(rescore, self._xmodal_scores(list(rescore.values()))))
        uids: List[int] = []
        for j, slot in enumerate(slots):
            uid = int(self._slot_req[slot])
            cand = int(self._slot_cand[slot])
            info = self._reqs[uid]
            n = int(n_tok[j])
            rec = {"uid": cand, "tokens": out_buf[j][:n].astype(np.int32),
                   "sum_lp": float(sum_lp[j]), "n": n,
                   "sum_coh": float(sum_coh[j]),
                   "emb": sum_emb[j] / max(n, 1),
                   "align": float(align_sum[j]) / max(n, 1),
                   "counts": counts[j]}
            # Eq. 12 from the incremental aggregates
            s_gen = rec["sum_lp"] / max(n, 1)
            s_coh = rec["sum_coh"] / max(n - 1, 1)
            s_align = 0.5 * (rec["align"] + info["align_const"]) \
                if self.has_evidence else 0.0
            if j in s_xm:
                s_align = rec["s_align_xmodal"] = s_xm[j]
            rec["score"] = s_gen + self.camd.lambda_g * s_align \
                + self.camd.lambda_c * s_coh
            info["records"][cand] = rec
            self._slot_req[slot] = -1
            self._slot_cand[slot] = -1
            self._slot_spec[slot] = 1
            self._slot_streamed[slot] = 0
            self.total_tokens += n
            self.scheduler.on_finish(uid, n, int(self._slot_lim[slot]))
            self._slot_lim[slot] = self.max_new
            if self.arena is not None:
                self._drop_row_mirror(slot)
            if self.paged:
                self.pool.free(self._slot_pages[slot])
                self._slot_pages[slot] = []
                self._drop_mirrors(slot)
                self._reserved_sh[self._slot_shard(slot)] -= \
                    int(self._slot_reserved[slot])
                self._slot_reserved[slot] = 0
            if uid not in uids:
                uids.append(uid)
        if self.paged:
            # freed slots' dead writes land on their shard's quarantine page
            self._quarantine_rows(slots)
        due = [u for u in uids
               if not any(self._slot_req[s] == u for s in range(self.B))]
        if due:
            self._finish_rounds(due)

    def _finish_rounds(self, uids: List[int]):
        """Fold every completed round in one batched
        ``round_update_assign`` call."""
        R = self._per_round()
        batch = []
        for uid in uids:
            info = self._reqs[uid]
            recs = [info["records"][c] for c, _ in info["cand_slots"]
                    if c in info["records"] and
                    "scored" not in info["records"][c]]
            if not recs:
                continue
            for r in recs:
                r["scored"] = True
            if len(recs) > R:
                raise RuntimeError(f"round of {len(recs)} > {R} candidates")
            batch.append((uid, recs))
        if not batch:
            return
        dev = self.device

        def field(key, dtype):
            rows = []
            for _, recs in batch:
                vals = [r[key] for r in recs]
                vals += [recs[0][key]] * (R - len(recs))   # padding rows
                rows.append(np.asarray(vals))
            return torch.as_tensor(np.stack(rows), dtype=dtype, device=dev)

        inp = ctrl.RoundInputs(
            scores=field("score", torch.float32),
            embs=field("emb", torch.float32),
            token_counts=field("counts", torch.float32),
            lengths=field("n", torch.int32),
            valid=torch.as_tensor(
                [[True] * len(recs) + [False] * (R - len(recs))
                 for _, recs in batch], device=dev),
            uids=field("uid", torch.int32))
        states = ctrl.stack_states([self._reqs[u]["camd"] for u, _ in batch])
        if self.mode != "camd":
            # the fixed-budget baselines keep folding every round
            states = states._replace(stopped=torch.zeros_like(states.stopped))
        new_states, biases, clusters = ctrl.round_update_assign(
            self.camd, states, inp)
        stopped_np, clusters_np, pstar_np, best_np = self._sync(
            (new_states.stopped, clusters, new_states.p_star,
             new_states.best_score))
        for i, (uid, recs) in enumerate(batch):
            info = self._reqs[uid]
            info["camd"] = ctrl.select_state(new_states, i)
            info["p_star"] = float(pstar_np[i])
            info["best_score_host"] = float(best_np[i])
            for j, r in enumerate(recs):
                r["cluster"] = int(clusters_np[i, j])
            info["round"] += 1
            if self.mode == "camd":
                info["bias"] = biases[i:i + 1]
                stopped = bool(stopped_np[i])
            else:
                info["bias"] = None
                stopped = len(info["records"]) >= self.n_candidates
            if stopped:
                self._finish_request(uid)
            else:
                info["pending_round"] = True

    def _finish_request(self, uid: int):
        """Finalize a request with the candidates it has: drop its prompt
        cache row and its prompt-page holds, and post it to the completion
        feed (``pop_finished``)."""
        info = self._reqs[uid]
        info["done"] = True
        info["pending_round"] = False
        info["cache_row"] = None
        r = info.pop("arena_row", None)
        if r is not None:
            self.arena.free([r])
        if self.paged and info.get("prompt_pages"):
            self.pool.free(info.pop("prompt_pages"))
        self._newly_done.append(uid)

    def _has_pending(self) -> bool:
        return bool(self._queue) or any(
            not i["done"] and i.get("pending_round")
            for i in self._reqs.values())

    def _raise_pool_sizing(self):
        blocked = self._queue[0].uid if self._queue else \
            next(uid for uid, i in self._reqs.items() if not i["done"])
        raise RuntimeError(
            f"paged KV pool ({self.pool.num_pages} pages of "
            f"{self.page_size}) cannot admit request {blocked} — raise "
            "num_pages or lower max_new_tokens/prompt lengths")

    def _finalize_starved(self):
        """Terminal drain once the global token budget is spent: pending
        work finalizes with whatever candidates it has, and half-prefilled
        chunk jobs return their pages."""
        for job in self._chunking.values():
            if job["pages"]:
                self.pool.free(job["pages"])
        self._chunking.clear()
        for req in self._queue:
            if req.uid not in self._reqs:
                self._reqs[req.uid] = self._stub_info(req)
        self._queue.clear()
        for uid, info in self._reqs.items():
            if not info["done"]:
                if not info["records"]:
                    self.starved_uids.append(uid)
                self._finish_request(uid)

    def _stub_info(self, req: Request, **extra) -> Dict[str, Any]:
        """The record of a request that finalizes without a prefill (budget
        starved, or cancelled while queued)."""
        return {"req": req, "cache_row": None,
                "camd": ctrl.init_state(self.camd, 1, self.d, self.V,
                                        self.device),
                "bias": None, "round": 0, "cand_slots": [], "records": {},
                "align_const": 0.0, "done": False, **extra}

    def _refill_idle(self) -> bool:
        """No slot is live: admit queued work or pending rounds. Returns
        True when all work is complete."""
        if not self._has_pending():
            return True
        self._chunk_progress = False
        self._schedule()
        if not self._any_live():
            if self.scheduler.exhausted():
                self._finalize_starved()
                return True
            if self._chunk_progress:
                return False        # a chunk job advanced: not a sizing error
            if self.paged:
                self._raise_pool_sizing()
            if self.arena is not None:
                # a full arena means held rows, and held rows mean live or
                # admissible work: fail fast rather than spin
                raise RuntimeError(
                    f"state arena ({self.arena.num_rows} rows, "
                    f"{self.arena.free_rows} free) cannot admit pending "
                    "work — arena sizing invariant violated")
        return False

    # -- run loops -------------------------------------------------------
    def _gather_evid(self) -> torch.Tensor:
        """(B_local, Ne, d) evidence rows of the request of each slot this
        process holds (zero rows for
        idle slots and text-only requests, padded to the config's Ne),
        staged for the next launches (``engine.py:2633``). Refreshed after
        every scheduling pass, where the reference's launch loop refreshes
        it. The reference pads to the longest row instead; the padding
        rows are zero and the rows of a request with evidence are Ne long,
        so each row's alignment mean is the same."""
        rows = []
        for s in range(self.row0, self.row0 + self.B_local):
            uid = int(self._slot_req[s])
            if uid >= 0 and "evid_row" in self._reqs[uid]:
                rows.append(self._reqs[uid]["evid_row"][0])
            else:
                rows.append(torch.zeros((1, self.d), device=self.device))
        ne = self.cfg.num_evidence_tokens
        return torch.stack([torch.nn.functional.pad(
            r, (0, 0, 0, ne - r.shape[0])) for r in rows])

    def run(self) -> List[Result]:
        if self.macro_steps <= 0:
            return self._run_legacy()
        self._schedule()
        self._begun = True
        while self._step():
            pass
        return [self.result(uid) for uid in self._reqs]

    def _step(self) -> bool:
        """One fused-loop iteration: refill when idle, else stage the
        frontier, run one macro launch and fold its results (cancels
        first, then the token stream, the frontier reclaim and the
        finished candidates, as ``engine.py:2403-2448``). Returns False
        once all work is drained."""
        self._chunk_left = self.chunk_budget     # the turn's chunk budget
        if not self._any_live():
            return not self._refill_idle()
        staged = self._stage_frontier() if self.paged else None
        done, *counts = self._macro_launch()
        self.macro_launches += 1
        self._steps_launched += max(self.macro_steps, 1)
        # one host sync a launch: speculation's draft counts, the emission
        # counts a cancel or the stream needs and the stream's tokens ride
        # along
        want_ntok = self.stream_tokens or bool(self._cancels)
        extra = ((self.state.n_tok,) if want_ntok else ()) + \
            ((self.state.out_buf,) if self.stream_tokens else ())
        rows = self._all_rows
        vals = self._sync((rows(done), rows(self.state.cache["pos"]),
                           *counts, *map(rows, extra)))
        done_np, pos_np, steps_np = vals[:3]
        if self.spec:
            self.spec_drafted += int(vals[3])
            self.spec_accepted += int(vals[4])
        k = 2 + len(counts)              # the first extra
        ntok_np = vals[k] if want_ntok else None
        out_np = vals[k + 1] if self.stream_tokens else None
        self.total_steps += int(steps_np)
        # a speculative iteration consumes the noise of spec_k steps
        self._t += int(steps_np) * max(self.spec_k, 1)
        cancelled = self._apply_cancels(staged, ntok_np) \
            if self._cancels else False
        if self.stream_tokens:
            self._emit_stream(ntok_np, out_np)
        if self.paged:
            self._reclaim_frontier(staged, pos_np)
        done_slots = [int(s) for s in np.nonzero(done_np)[0]
                      if self._slot_req[s] >= 0]
        if done_slots or cancelled:
            if done_slots:
                self._finish_candidates(done_slots)
            self._schedule()
        elif self.chunked and (self._chunking or
                               (self._queue and self._free_slots())):
            # prefill work waits: spend the turn's chunk budget between
            # two decode launches
            self._schedule()
        return True

    def _run_legacy(self) -> List[Result]:
        """Per-token host loop (``macro_steps=0``): one step, one host sync
        and one block-table update per generated token."""
        self._schedule()
        while True:
            if not self._any_live():
                if self._refill_idle():
                    break
                continue
            if self.paged:
                self._alloc_step_pages()
            done = self._decode_step(self._step_noise(self._t))
            self.total_steps += 1
            self._t += 1
            (done_np,) = self._sync((self._all_rows(done),))
            # parity with the reference's loop (engine.py:2617-2622): no
            # caller can cancel a live slot while this synchronous loop
            # runs, so ``_cancels`` is empty here today
            cancelled = self._apply_cancels(
                None, self._sync((self._all_rows(self.state.n_tok),))[0]) \
                if self._cancels else False
            if done_np.any() or cancelled:
                for s in np.nonzero(done_np)[0]:
                    if self._slot_req[int(s)] >= 0:
                        self._finish_candidates([int(s)])
                self._schedule()
        return [self.result(uid) for uid in self._reqs]

    def pump(self) -> bool:
        """Drive one serving iteration, the async front-end's hook
        (``engine.py:2450``). Where ``run`` admits only at completions,
        ``pump`` also runs an admission pass when work arrived between
        launches and a slot is free, or chunk jobs wait. Returns False once
        the engine is drained (call again after the next ``submit``)."""
        if self.macro_steps <= 0:
            raise RuntimeError(
                "pump() drives the fused macro-step loop; construct the "
                "engine with macro_steps >= 1 for async serving")
        if not self._begun:
            self._begun = True
            self._schedule()
        elif (self._queue and self._free_slots()) or self._chunking:
            self._schedule()
        return self._step()

    def _emit_stream(self, ntok_np, out_np):
        """Queue each live slot's new tokens for the front-end, before
        finished slots fold, so that the deltas of one candidate
        concatenate to its finished ``tokens``."""
        for s in range(self.B):
            uid = int(self._slot_req[s])
            if uid < 0:
                continue
            n = int(ntok_np[s])
            if n > self._slot_streamed[s]:
                self.stream_events.append(
                    (uid, int(self._slot_cand[s]),
                     np.asarray(out_np[s][int(self._slot_streamed[s]):n])))
                self._slot_streamed[s] = n

    # -- cancellation ----------------------------------------------------
    def cancel(self, uid: int) -> bool:
        """Abort a request (``engine.py:2489``): queued or pending work is
        dropped at once, running candidates are torn down at the next step
        boundary (``_apply_cancels``). Returns False for an unknown or
        finished uid. A cancelled request still yields a ``Result``
        (``cancelled=True``) with the candidates it completed."""
        info = self._reqs.get(uid)
        if info is None:
            # mid chunked prefill: the job's pages go back to the pool
            job = self._chunking.pop(uid, None)
            if job is not None and job["pages"]:
                self.pool.free(job["pages"])
            # queued and never prefilled: a stub record keeps results
            # uniform
            for i, r in enumerate(self._queue):
                if r.uid == uid:
                    self._queue.pop(i)
                    self._reqs[uid] = self._stub_info(r, cancelled=True)
                    self._finish_request(uid)
                    self.cancelled_requests += 1
                    return True
            return False
        if info["done"]:
            return False
        if (self._slot_req == uid).any():
            # live candidates: torn down after the next launch, whose sync
            # carries their emission counts
            self._cancels.add(uid)
            return True
        # prefilled but not running (queued, or pending a round): its prompt
        # row and page holds go now
        self._queue = [r for r in self._queue if r.uid != uid]
        info["cancelled"] = True
        self._finish_request(uid)
        self.cancelled_requests += 1
        return True

    def _apply_cancels(self, staged, ntok_np) -> bool:
        """Tear down the live slots of cancel-marked requests after a launch
        (``engine.py:2535``), before ``_reclaim_frontier``: a slot's staged
        frontier pages return wholesale, its pages and reservation free,
        and the scheduler refunds its commitment (the tokens it emitted
        count as spent). The slot is deactivated on the device and its
        block-table row pointed at the quarantine page in place, as
        ``_finish_candidates`` does: the captured graph's tensors keep
        their storage. Returns whether any slot was torn down."""
        uids = set(self._cancels)
        self._cancels.clear()
        slots = [s for s in range(self.B) if int(self._slot_req[s]) in uids]
        if not slots:
            return False
        for s in slots:
            uid = int(self._slot_req[s])
            n = int(ntok_np[s])
            self.total_tokens += n
            self.scheduler.on_cancel(uid, n, int(self._slot_lim[s]))
            self._slot_req[s] = -1
            self._slot_cand[s] = -1
            self._slot_spec[s] = 1
            self._slot_lim[s] = self.max_new
            self._slot_streamed[s] = 0
            if self.arena is not None:
                self._drop_row_mirror(s)
            if self.paged:
                if staged is not None and s in staged:
                    pages = staged.pop(s)[1]
                    if pages:
                        self.pool.return_frontier(pages)
                self.pool.free(self._slot_pages[s])
                self._slot_pages[s] = []
                self._drop_mirrors(s)
                self._reserved_sh[self._slot_shard(s)] -= \
                    int(self._slot_reserved[s])
                self._slot_reserved[s] = 0
        idx = torch.as_tensor(self._own(slots)[1], device=self.device)
        self.state.active[idx] = False
        if self.paged:
            self._quarantine_rows(slots)
        for uid in sorted(uids):
            info = self._reqs.get(uid)
            if info is not None and not info["done"]:
                info["cancelled"] = True
                self._finish_request(uid)
                self.cancelled_requests += 1
        return True

    def result(self, uid: int) -> Result:
        """One request's ``Result`` (``run`` returns them in bulk)."""
        info = self._reqs[uid]
        cs = info["camd"]
        p_star = float(cs.p_star[0])
        best_score = float(cs.best_score[0])
        recs = list(info["records"].values())
        if not recs:                     # budget-starved
            return Result(uid=uid, tokens=np.zeros((0,), np.int32),
                          n_candidates=0, tokens_spent=0,
                          rounds=info["round"], p_star=p_star,
                          best_score=best_score, stopped_early=False,
                          candidates=[],
                          cancelled=info.get("cancelled", False))
        if self.mode == "self_consistency":
            # majority vote: the largest cluster's best-scoring member
            n_cl = int(cs.table.n_clusters[0])
            members: List[Dict[str, Any]] = []
            if n_cl > 0:
                sizes = cs.table.sizes[0, :n_cl].cpu().numpy()
                best_k = int(np.argmax(sizes))
                members = [r for r in recs if r.get("cluster", -1) == best_k]
            chosen = max(members or recs, key=lambda r: r["score"])
        else:
            chosen = info["records"].get(int(cs.best_uid[0])) or \
                max(recs, key=lambda r: r["score"])
        return Result(
            uid=uid, tokens=chosen["tokens"], n_candidates=len(recs),
            tokens_spent=int(sum(r["n"] for r in recs)),
            rounds=info["round"], p_star=p_star, best_score=best_score,
            stopped_early=(self.mode == "camd" and bool(cs.stopped[0]) and
                           p_star >= 1.0 - self.camd.delta),
            candidates=[{k: v for k, v in r.items()
                         if k not in ("counts", "emb")} for r in recs],
            cancelled=info.get("cancelled", False))


class _EngineSchedContext(SchedulerContext):
    """The engine side of the scheduler facade; free slots are handed out
    in ascending order, as in the reference."""

    def __init__(self, eng: ServeEngine):
        self.eng = eng
        self.max_new = eng.max_new
        self.num_shards = eng.dp

    def free_slots(self) -> int:
        return len(self.eng._free_slots())

    def queued_new(self) -> List[NewWork]:
        eng = self.eng
        out = []
        for r in eng._queue:
            if r.uid in eng._chunking:
                continue                 # mid chunked prefill
            if r.uid not in eng._reqs:
                break                    # prefill covers a queue prefix
            info = eng._reqs[r.uid]
            out.append(NewWork(uid=r.uid, arrival=eng._arrival[r.uid],
                               want=eng._per_round(),
                               prompt_len=info["prompt_len"],
                               evidence_entropy=info.get("evidence_entropy",
                                                         0.0)))
        return out

    def pending_rounds(self) -> List[RoundWork]:
        eng = self.eng
        out = []
        for uid, info in eng._reqs.items():
            if info["done"] or info.get("pending_round") is not True:
                continue
            recs = list(info["records"].values())
            scores = [r["score"] for r in recs]
            out.append(RoundWork(
                uid=uid, arrival=eng._arrival.get(uid, 0),
                want=eng._needed(info), rounds=info["round"],
                p_star=info.get("p_star", 0.0), delta=eng.camd.delta,
                best_score=info.get("best_score_host",
                                    max(scores, default=0.0)),
                scores=scores,
                mean_len=float(np.mean([r["n"] for r in recs]))
                if recs else 0.0))
        return out

    def affordable(self, uid: int, want: int, limit: int) -> int:
        eng = self.eng
        if not eng.paged:
            return want
        return eng._paged_affordable(eng._reqs[uid], want, limit)

    def admit_new(self, uid: int, take: int, limit: int) -> None:
        eng = self.eng
        i = next(i for i, r in enumerate(eng._queue) if r.uid == uid)
        eng._admit(eng._queue.pop(i), eng._free_slots()[:take], limit=limit)

    def admit_round(self, uid: int, take: int, limit: int) -> None:
        eng = self.eng
        info = eng._reqs[uid]
        info["pending_round"] = False
        eng._admit(info["req"], eng._free_slots()[:take], limit=limit)

    def finish_request(self, uid: int) -> None:
        self.eng._finish_request(uid)

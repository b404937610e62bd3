#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. It
  1. prints the card's name and power limit (nvidia-smi);
  2. builds every CUDA kernel of the port from ``src/repro_torch/kernels/
     csrc`` with nvcc, one process per source, all at once, while the
     card-against-CPU training check of 28-30 (which launches no kernel)
     runs beside it;
  3. kernel phase: holds each kernel against its plain PyTorch version on
     the card (fp32 and bf16, head_dim 64 and 128, the serving shapes and
     ragged edges, granite's 24/8 heads of width 64 (GQA group 3) for the
     attention kernels; for the flash kernel also head_dim 16 and 32,
     llava's 832-token bucket, a 4096-token row, windows and key
     lengths, each twice for the same bits; the split plan's edges and a
     row with no valid key for both decode kernels, int8/fp8 pools, shared and
     out-of-range page ids and odd page sizes for the paged kernel,
     ragged row counts for the cross-modal score, granite's prefill,
     decode and speculative-verify dispatch shapes and ragged ones for
     the MoE dispatch and combine) and times kernel (the flash kernel at
     the three served prefill buckets; both decode kernels also at cache
     lengths 16 to 32768, the paged one at llava's and granite's decode
     shapes too and on int8 and fp8 pools at qwen3's; the MoE kernels at
     granite's prefill, decode and verify shapes), plain version and —
     where one PyTorch call computes the same function —
     ``scaled_dot_product_attention``, beside a bound from bytes and
     operations; the MoE combine also with the L2 warm (as serving finds
     its input) beside the device time of an empty kernel, the floor
     under any launch; it also counts the tensor-core (HMMA)
     instructions in the SASS of the flash kernel and the cross-modal
     score, checks K4b's split plan with one split and several, and times
     K2 and K4b beside a bytes, an fp32 and a 3xTF32 bound;
  4. serve phase: serves CAMD requests on full-width qwen3-0.6b through
     the port's serve entry point with ``--impl paged_cuda`` and checks
     that the flash and paged decode kernels carried it, the flash kernel
     once a layer a bucketed prefill; then the mesh phase serves the same
     weights again through the entry point, at dp 1 and on 2 logical
     data shards of the card (``--serve-dp 2 --prefill-shards 1
     --prefix-cache``: the same streams and K1/K2 counts as dp 1, every
     tail and frontier page on its slot's shard, every prompt page on
     shard 0, idle rows on their shard's quarantine page, both shards
     admitting) and on 4 (an 80-page pool, where shard-local capacity
     gates admissions yet every request is served, and the full pool),
     and prints tokens/s at dp 1, 2 and 4; then the ranks phase serves 2
     requests through the entry point as torch.distributed ranks: (a)
     one NCCL rank (world 1, the macro body and its collectives one
     captured graph) with the streams and K1/K2 counts of the run
     without a group, and as two gloo ranks sharing the card (eager
     bodies; every gloo run of this script is one torchrun launch of four
     worker processes, started before the in-process runs, a run of n
     ranks on its first n) (b) ``--mesh 1,2`` (8/4 heads a
     rank, K2 once a layer a prefill bucket, K1 once a layer a step), (c)
     ``--mesh 2,1`` (half the slots and pages a rank, plus mirror pages)
     with (a)'s streams and (d) ``--mesh 1,2 --impl cuda`` (K2, K3) with
     the one-process cuda run's; a parting stream must part at a top-two
     logit margin below 1e-4; it prints tokens/s, per-rank peak memory
     and weight and KV bytes; the kernel phase holds and times K1, K3 and
     K2 at a rank's 8/4 heads; then full-width llava-1.5-7b image
     requests (``vlm_ranks_phase``) and granite-moe-3b-a800m
     (``moe_ranks_phase``) likewise: granite's (a) one NCCL rank whose
     captured graph holds its MoE layers' collectives, (b) ``--mesh 1,2``
     (f 256 of each expert's 512 a rank) and (c) ``--mesh 2,1`` (all 40
     experts, half the slots) on two gloo ranks, and (d) ``--mesh 2,2``
     (20 experts at f 256 a rank) on four, each rank's K5a/K5b once a
     layer a forward, with the
     expert-parallel ``moe_apply_shard_map`` on the same four ranks held
     against its plain version and the dense oracle; the kernel phase
     holds and times K5a/K5b on a (2, 2) rank's 20 experts;
  5. profile: a shorter serve run of the same shapes under torch.profiler
     — device time by kernel and the device's idle share;
  6. dense check: at reduced depth, greedy streams of the plain (torch),
     dense-kernel (cuda) and paged-kernel (paged_cuda) engines must agree;
  7-9. the same three phases for image requests on full-width
     llava-1.5-7b (``--xmodal-rescore``): the serve phase checks that the
     flash, paged decode and both cross-modal score kernels carried it and
     that the vision tower encoded each distinct image once, and times one
     image encode and one bucketed image prefill; the dense check also
     holds the kernel-rescored scores against the plain engine's;
  10-12. the same three phases on full-width granite-moe-3b-a800m (40
     experts, top-8): the serve phase checks that the flash, paged decode
     and both MoE kernels carried it, the MoE kernels once per layer per
     forward, and times one bucketed prefill and one decode forward;
  13-14. qwen3-0.6b served again from int8 and from fp8 KV pools (paged
     decode kernel's dequant path), with their bytes per page beside
     fp32's, and at reduced depth the greedy streams of the plain and the
     kernel paged engines on each quantized pool must agree;
  15-17. llava-1.5-7b served with the cross-request prefix cache: each
     request whose image an earlier one brought hits the 36 pages of its
     576-token image span and prefills only its prompt (hits, prefill
     tokens against the run without the cache, whole and suffix prefill
     forwards checked), then the prefill of a hit against a miss (CUDA
     events, the attention's share of each) and no page in use once the
     cache drops its holds; served again with chunked prefill (chunks of
     640: the image span and 64 prompt tokens, then the rest); at 4
     layers the greedy streams with the cache on and off, plain and
     kernel paged engines, must agree;
  18-19. qwen3-0.6b served with chunked prefill (chunks of 64, at most 128
     chunk tokens between two decode launches; chunk calls and tokens
     checked, tokens/s beside the unchunked run's), and at 4 layers the
     greedy streams of two waves of the same requests (the second hits
     the cache) with the cache and chunks of 16 on and off, plain and
     kernel paged engines, must agree;
  20-22. the three models served again with speculative decoding
     (``--spec-k 4``: n-gram drafts of up to 3 tokens verified in one
     block forward an iteration, inside the captured graph): drafts
     proposed and accepted, tokens/s beside the plain run's, peak memory,
     the graph's capture, noise fill and one replay; the flash kernel
     (and the cross-modal and MoE kernels) carried them, the paged decode
     kernel never (the verify runs plain sdpa, as the reference's); and
     at 4 layers the greedy streams with ``--spec-k 4`` on and off, plain
     and kernel paged engines, must agree for qwen3-0.6b on fp32 and
     int8 pools and for llava-1.5-7b;
  23-25. open-loop serving on full-width qwen3-0.6b: one greedy engine
     serves 16 requests (twice its slots) in six waves, a warm-up that
     captures its graph, a closed-loop wave (golden streams, capacity),
     Poisson and bursty arrivals at 0.7x that capacity, saturation (all at
     t = 0) and Poisson with every third client disconnecting after its
     first streamed token, through the async front-end; every surviving
     stream equals its closed-loop stream, nothing leaks after the
     cancels, TTFT p50/p99, TPOT p50/p99, goodput at the adaptive TTFT SLO
     and tokens/s are printed a cell; then CAMD requests through the serve
     CLI's ``--open-loop``; and at 4 layers the plain and kernel paged
     engines, pumped through one cancel plan, must deliver the same
     streams and cancel the same requests in the same launches;
  26-27. the remaining attention-only configs: at 4 layers in fp32 the
     greedy streams of torch, cuda and paged_cuda must agree for
     internvl2-2b (images, K4 rescoring), qwen2.5-32b, yi-34b and
     granite-34b (K1 and K3 at 48 query heads over one kv head), then
     each is served at full depth: internvl2-2b in fp32 through the CLI,
     the 32-34B ones in bf16 through ``build_engine(...,
     param_dtype=torch.bfloat16)``, one at a time, each released before
     the next, with its prefill forward (CUDA events), graph, peak memory
     against the card's and launch counts. The kernel phase holds and
     times K1 and K3 at 5, 7, 12 and 48 query heads a kv head (K1 also on
     int8/fp8 pools at 48), K2 in bf16 at the 32-34B models' buckets and
     K4 at internvl2-2b's shape.
  28-30. training and rescoring, the full-sequence forward: full-width
     qwen3-0.6b (20 steps of 8 x 128 tokens, the reference CLI's
     defaults but for its 50 steps), granite-moe-3b-a800m (10 steps),
     mamba2-780m (10) and recurrentgemma-2b (5) trained in fp32 through
     the training launcher,
     and seamless-m4t-large-v2 (5, with 512 evidence frames a row)
     through ``training.train``, on the plain impl (no kernel launches;
     losses finite, qwen3's falling, peak memory, median step, tokens/s,
     the AdamW update's time, granite's router losses); at 2 layers
     (recurrentgemma 3, seamless 2 + 2) three train steps of each on the
     card against the same three on the CPU (losses, and granite's router
     losses), and a checkpoint round trip on the card; then ``camd_wrap``
     rescores 8 candidates of 32 tokens on full-width llava-1.5-7b (with
     one image's 576 rows as evidence), granite-moe-3b-a800m and
     seamless-m4t-large-v2 (512 frames into its encoder) with both
     impls: the cuda one launches K2 once a (decoder) layer, K4a/K4b
     once, K5a/K5b once a layer, agrees with the plain one, and each
     kernel's first call is held against its plain version at the shape
     it got; every kernel of that path raises on inputs that require
     grad; last, the CAMD core's stop rules, round update, candidate
     score and §4.1 theory on the card agree with the CPU's.
  31-32. the recurrent and hybrid models: at 3 layers, full widths, fp32,
     the greedy streams of torch (K 8), cuda (K 8, the graph) and cuda
     (K 0) must agree for mamba2-780m (SSD blocks) and recurrentgemma-2b
     (RG-LRU blocks and local attention); then each is served at full
     width in fp32 through ``--impl cuda`` (8 requests arriving at once
     through the front-end, for TTFT), with exact launch counts (mamba2
     none; recurrentgemma K2 once a local layer a prefill, K3 once a
     local layer a replayed step, nothing else), one graph, the state
     arena empty and audited at the end, tokens/s, TTFT, the arena's
     stats, the capture and a replay's device time a step against the
     byte bound of one step. The kernel phase holds and times K2 and K3
     at head_dim 256 (``hd256_phase``: recurrentgemma's 10 query heads
     over one kv head, the window binding at L 3072 and on a wrapped
     2048-slot ring).
  33-34. the encoder-decoder seamless-m4t-large-v2 (512 random audio
     frames a request into a 24-layer encoder; a 24-layer decoder with
     cross-attention): at 4 + 4 layers, full widths, fp32, the greedy
     streams of torch (K 8), cuda (K 8, the graph) and cuda (K 0) must
     agree, with K2 and K3 launched once a decoder layer a prefill and a
     step, and ``--impl paged_cuda`` refused; then it is served at full
     width in fp32 through ``--impl cuda --mode camd --xmodal-rescore``
     (8 requests arriving at once through the front-end), with exact
     launch counts (K2 once a decoder layer a prefill, K3 once a decoder
     layer a replayed step, K4a and K4b once a rescored candidate,
     nothing else), tokens/s, TTFT, peak memory, and a replay's device
     time a step against the byte bound of one step. The kernel phase
     holds and times K2 and K3 at its decoder's 16/16 heads of width 64
     (``seamless_attention_phase``) and K4 at its 512 frames of width
     1024.
Before the kernel phase and again after the last phase, ``timer_check``
profiles K4a's timed call in 40 windows with no head, 40 behind one
spinning kernel of ~1 ms and 40 the timer's way (behind 500 spinning
kernels of a few cycles, whose records take the places the profiler
drops), and prints what each way lost.
Every serve phase and open-loop wave checks that the flash kernel ran
once a layer a whole-prompt prefill forward and the paged decode kernel
once a layer a step of every replay (none in a speculative run).
Every serve phase runs each macro launch as a replay of the engine's one
captured CUDA graph: it checks that one graph was captured, prints the
capture time, the steps the launches ran against the real ones (the
masked share), the time of filling a launch's noise, and one macro
launch's wall time against its device time, replayed and with the same
body run eagerly; each dense check also holds the CAMD streams of the
graph (8 steps a launch) against those of the eager per-token loop;
and prints a JSON line describing every kernel, the card line again, and
last ``{"ok": true, "device": {...}}``. Any failure exits nonzero. It
exits with an error, printing no result, without a CUDA device or outside
a checkout of the repository.
"""
import asyncio
import concurrent.futures
import contextlib
import dataclasses
import json
import math
import os
import re
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PEAK_BYTES_PER_S = 3.35e12            # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_FLOPS = {"float32": 67e12,       # fp32 outside the tensor cores
              "tf32": 495e12,         # dense TF32 tensor cores
              "bfloat16": 989e12}     # dense bf16 tensor cores
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (2e-2, 2e-2)}   # (atol, rtol)
DT_NAMES = {"float32": "fp32", "bfloat16": "bf16"}

# serving configuration of the main path
SERVE = dict(slots=8, page=16, requests=8, prompt=256, max_new=32)
CACHE_LEN = SERVE["prompt"] + SERVE["max_new"]     # 288, a page multiple
# granite-moe-3b-a800m's MoE layer: 40 experts, top-8, d 1536, capacity
# factor 1.25 in groups of 256 tokens; C = ceil(g k / E * 1.25) rounded up
# to a multiple of 8 (repro/models/moe.py:61)
GRANITE_MOE = dict(E=40, k=8, d=1536)
GRANITE_PREFILL = dict(G=8, g=256, C=64)   # one 8 x 256 prefill bucket
GRANITE_DECODE = dict(G=1, g=8, C=8)       # one decode step of 8 slots
# one speculative verify forward: 8 slots' blocks of 4 tokens, one group
GRANITE_VERIFY = dict(G=1, g=32, C=8)
# the multimodal path: llava-1.5-7b's 576 image tokens ahead of the prompt
IMAGE_TOKENS = 576
MM_CACHE_LEN = IMAGE_TOKENS + CACHE_LEN            # 864, a page multiple
# the configs served in bf16 on one card (query heads, kv heads; head_dim
# 128): G 5, 7 and 48 query heads a kv head
LARGE_HEADS = {"qwen2.5-32b": (40, 8), "yi-34b": (56, 8),
               "granite-34b": (48, 1)}
# internvl2-2b: 256 image tokens (448 / 28 squared) of width 2048
INTERNVL_TOKENS, INTERNVL_D = 256, 2048
INTERNVL_CACHE_LEN = INTERNVL_TOKENS + CACHE_LEN   # 544, a page multiple
# recurrentgemma-2b's local attention, which K2 and K3 serve at head_dim
# 256: 10 query heads over one kv head, a window of 2048
RG_ATTN = dict(H=10, Hkv=1, hd=256, window=2048)
# the kernels' JSON entries at the shapes of the remaining configs, and of
# recurrentgemma-2b's local attention (K2 in fp32 and bf16 at the served
# prefill and in fp32 at 3072 tokens, where the window binds; K3 at the
# served decode)
HD256_ENTRIES = ("recurrentgemma-2b", "recurrentgemma-2b bf16",
                 "recurrentgemma-2b L3072")
# seamless-m4t-large-v2: its decoder's self-attention, which K2 and K3
# serve (16 query heads over 16 kv heads of width 64, G 1), and its 512
# audio frames of width 1024, the evidence K4 rescores against
SEAMLESS = dict(name="seamless-m4t-large-v2", H=16, Hkv=16, hd=64,
                frames=512, d=1024, eos=256206, layers=24)
SEAMLESS_DENSE_LAYERS = 4
# a model rank's heads of qwen3-0.6b at model=2: 8 query over 4 kv heads
RANK_HEADS = (8, 4)
RANK_ENTRY = "qwen3-0.6b tp2 rank"
# a model rank's heads of llava-1.5-7b at model=2: 16 query over 16 kv
# heads; K2 at the bucket of the vlm ranks phase's two requests
LLAVA_RANK_HEADS = (16, 16)
LLAVA_RANK_ENTRY = "llava-1.5-7b tp2 rank"
# a (2, 2) rank of granite-moe-3b-a800m: its data rank's 20 of the 40
# experts at a decode step of the 8 slots (G 1, g 8, k 8, C 8)
MOE_RANK_EXPERTS = 20
MOE_RANK_ENTRY = "granite-moe-3b-a800m 2x2 rank"
# a model rank of recurrentgemma-2b at model=2: 5 query heads beside the
# one kv head, which every model rank holds whole; K2 at a request's
# one-row prefill, K3 at a decode step of the 8 slots on one data rank
# (``--mesh 1,2``) and of a data rank's 4 (``--mesh 2,2``)
RG_RANK_HEADS = (5, 1)
RG_RANK_ENTRY = "recurrentgemma-2b tp2 rank"
RG_RANK_DP2_ENTRY = "recurrentgemma-2b 2x2 rank"
NEW_ENTRIES = tuple(LARGE_HEADS) + ("granite-34b int8", "granite-34b fp8",
                                    "internvl2-2b") + HD256_ENTRIES + (
    SEAMLESS["name"], RANK_ENTRY, LLAVA_RANK_ENTRY, MOE_RANK_ENTRY,
    RG_RANK_ENTRY, RG_RANK_DP2_ENTRY)
# K3's second timing shape: the reference's decode_32k cache length
# (repro/config.py:263); K3 is timed at each length of the sweep, from
# one 16-row tile to 2048 of them
DECODE_LONG = 32768
DECODE_SWEEP = (16, 64, CACHE_LEN, 4096, DECODE_LONG)


def sass_count(lib, opcode: str) -> int:
    """Instructions of ``opcode`` in the SASS of a built library
    (``cuobjdump -sass``)."""
    from repro_torch.kernels import sass
    return sum(len(re.findall(rf"\b{opcode}\b", ins))
               for code in sass.functions(str(lib)).values() for ins in code)


T_START = time.perf_counter()


def stamp(phase: str) -> None:
    """The script's seconds so far, as a phase begins."""
    print(f"[{time.perf_counter() - T_START:.1f} s] {phase}")


def fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def device_records(torch, prof):
    """({kernel name: summed device microseconds}, {name: records}) of a
    finished torch.profiler run, read from its raw device records.
    ``key_averages()`` gives the same sums, but first builds the
    profiler's Python event tree, about 0.3 ms a record on the card's
    host: minutes over the graph replays of the 60-88 layer models."""
    cuda = torch.autograd.DeviceType.CUDA
    times, counts = {}, {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != cuda or \
                getattr(e, "is_hidden_event", lambda: False)():
            continue
        name = e.name()
        times[name] = times.get(name, 0.0) + e.duration_ns() / 1e3
        counts[name] = counts.get(name, 0) + 1
    return times, counts


# spinning kernels of a few cycles each (``torch.cuda._sleep``) that open
# each profiled window: a process that has profiled many device records
# drops the first records of later windows (~30 late in this script, more
# the more it has profiled; ``timer_check``), and these take their place
HEAD_RECORDS = 500
# windows a profiled timing tries before it fails: a window that lost
# records of the call (or all of them) is profiled again
PROFILE_TRIES = 3


class Timer:
    """Per-launch timing with the L2 cache flushed before each launch (the
    serving path meets every layer's K/V cold): ``device_ms`` sums the
    device durations of the call's kernels under torch.profiler (launch
    gaps and host time excluded), ``ms`` reads CUDA events around the
    call (the host's work inside the call included, where the device
    waits on it).

    A process that has profiled many device records drops the first
    records of every later window (``timer_check``): the first calls'
    kernels went missing, and the timer failed a correct tree. So each
    padded window opens with ``HEAD_RECORDS`` spinning kernels of a few
    cycles, which take the dropped places. They and the flush are left
    out of every sum."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
        self.prof = None
        # the timer's own kernels, each named from a window of two calls
        # that leaves nothing out yet
        self._flush_keys, self._pad_keys = set(), set()
        self._flush_keys = set(self._kernel_times(self._flush, 2, pad=False))
        self._pad_keys = set(self._kernel_times(self._pad, 2, pad=False))

    def _flush(self):
        self.flush.bitwise_not_()

    def _pad(self):
        for _ in range(HEAD_RECORDS):
            self.torch.cuda._sleep(1)

    def _kernel_times(self, fn, reps: int, flush: bool = True,
                      pad: bool = True):
        """{kernel name: summed device microseconds} over ``reps`` calls,
        each after an L2 flush unless ``flush`` is false, the window
        opened by the head records unless ``pad`` is false (``timer_check``
        profiles both ways; an unpadded window can time the spinning
        kernel itself). The flush and the head are left out. The profile
        stays in ``self.prof``."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            if pad:
                self._pad()
            for _ in range(reps):
                if flush:
                    self._flush()
                fn()
            torch.cuda.synchronize()
        times, self.counts = device_records(torch, prof)
        self.prof = prof
        own = self._flush_keys | (self._pad_keys if pad else set())
        return {k: v for k, v in times.items() if k not in own}

    def kernel_times(self, fn, reps: int, flush: bool = True,
                     pad: bool = True, kernel: str = None) -> dict:
        """``_kernel_times`` of the call's kernels (only those whose name
        holds ``kernel``, when given) from a window in which each ran at
        least once a call: every kernel of the call runs once a call, so
        fewer records mean the profiler lost some, and a window with none
        of the call's records lost them all; such a window is profiled
        again, up to ``PROFILE_TRIES`` windows, and then the timing
        fails."""
        for _ in range(PROFILE_TRIES):
            times = {k: v for k, v in
                     self._kernel_times(fn, reps, flush, pad).items()
                     if kernel is None or kernel in k}
            if times and all(self.counts[k] >= reps for k in times):
                return times
        check(bool(times), f"timer: the profiler saw no kernel "
              f"{kernel or ''} in the call in {PROFILE_TRIES} windows")
        kept = _window_records(self.torch, self.prof, kernel or "")
        print(f"timer: {kernel or 'the call'}: kept {kept['head']} of "
              f"{HEAD_RECORDS if pad else 0} head, {kept['flush']} flush "
              f"and {kept['call']} call records of {reps} calls",
              file=sys.stderr)
        check(False, f"timer: the profiler lost records of "
              f"{kernel or 'the call'} in {PROFILE_TRIES} windows")

    def device_ms(self, fn, kernel: str = None, reps: int = 20,
                  warmup: int = 3, flush: bool = True,
                  pad: bool = True) -> float:
        """Device time per call: the call's kernels (only those whose name
        holds ``kernel``, when given), the flush left out, from a window
        that kept every record (``kernel_times``); with ``flush`` false
        the call finds in the L2 what its previous call left; with
        ``pad`` false the window is not padded (to time the pad's own
        kernel)."""
        for _ in range(warmup):
            fn()
        return sum(self.kernel_times(fn, reps, flush, pad,
                                     kernel).values()) / reps / 1e3

    def by_kernel(self, fn, reps: int = 20) -> dict:
        """Device ms per call of each kernel the call runs, the flush
        left out, from a window that kept every record."""
        return {k: v / reps / 1e3 for k, v in
                self.kernel_times(fn, reps).items()}

    def ms(self, fn, reps: int = 20, warmup: int = 3) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        total = 0.0
        for _ in range(reps):
            self._flush()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            total += start.elapsed_time(end)
        return total / reps


def bound_ms(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops \
        else "operations"


def times(timer, kernel_fn, kernel, plain_fn, library_fn=None):
    """ms: the kernel's device time; call_ms: the wrapper call's CUDA-event
    window; plain_ms / library_ms: the device time of every kernel the
    plain version / the one PyTorch call runs (None: no such call)."""
    return dict(
        ms=timer.device_ms(kernel_fn, kernel), call_ms=timer.ms(kernel_fn),
        plain_ms=timer.device_ms(plain_fn),
        library_ms=None if library_fn is None else
        timer.device_ms(library_fn))


def compare(torch, name, case, out, exp, dtype):
    atol, rtol = TOL[dtype]
    out, exp = out.float(), exp.float()
    check(bool(torch.isfinite(out).all()), f"{name} {case}: non-finite")
    err = (out - exp).abs()
    ok = bool((err <= atol + rtol * exp.abs()).all())
    mx = float(err.max())
    print(f"  {name:24s} {case:44s} max_abs_err {mx:.3e} "
          f"(tol {atol:g} + {rtol:g}|ref|) {'ok' if ok else 'FAIL'}")
    check(ok, f"{name} {case}: max_abs_err {mx:.3e} beyond tolerance")
    return mx


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------

# keys of a timing kept under another shape's entry of the kernels line
SUB_KEYS = ("shape", "ms", "call_ms", "plain_ms", "library_ms",
            "bound_ms", "bound_by")
# the bounds of the tensor-core kernels (K2, K4b): bytes, fp32 on the CUDA
# cores, 3xTF32 on the tensor cores
TF32_BOUNDS = ("bound_bytes_ms", "bound_simt_ms", "bound_tf32x3_ms")


# K2's timed shapes: the bucketed prefills of the three served models
FLASH_SHAPES = {  # (B, L, H, Hkv, hd)
    "qwen3": (8, SERVE["prompt"], 16, 8, 128),
    "granite": (8, SERVE["prompt"], 24, 8, 64),
    "llava": (8, IMAGE_TOKENS + SERVE["prompt"], 32, 32, 128),
}


def flash_phase(torch, ops, ref, timer):
    """K2 against its plain version in fp32 (3xTF32 on the tensor cores)
    and bf16 (one TF32 pass) at every head_dim it takes, at the served
    buckets (qwen3's, granite's G 3, llava's L 832, no tile multiple), the
    one-row prefills of a prefix-cache miss and of a first chunk (qwen3's
    and llava's), a 4096-token row (the 3xTF32 error over many keys),
    ragged last tiles,
    sliding windows whose edge cuts diagonal tiles, a non-causal row and
    key lengths, twice each for the same bits; then timed
    (``flash_timing``) at the three served buckets."""
    g = torch.Generator(device="cuda").manual_seed(1)
    errs = []
    cases = [  # (B, L, H, Hkv, hd, causal, window, key lengths)
        (8, 256, 16, 8, 128, True, 0, None),   # qwen3 prefill bucket
        (8, 256, 24, 8, 64, True, 0, None),    # granite bucket, G = 3
        (2, 832, 32, 32, 128, True, 0, None),  # llava bucket, ragged tile
        (1, 4096, 16, 8, 128, True, 0, None),  # long row
        (2, 200, 4, 2, 64, True, 0, None),     # L not a tile multiple
        (2, 300, 4, 4, 128, True, 96, None),   # causal + sliding window
        (2, 200, 4, 2, 64, True, 40, None),    # window edge in the diagonal
        (1, 37, 2, 1, 64, False, 0, None),     # tiny, non-causal, MQA
        (2, 130, 4, 2, 16, True, 0, None),     # hd 16
        (2, 170, 4, 1, 32, True, 24, None),    # hd 32, window
        (3, 200, 24, 8, 64, True, 0, [200, 37, 130]),  # padded rows, G = 3
        (2, 256, 16, 8, 128, True, 0, [1, 100]),       # padded rows, G = 2
        (2, 150, 4, 2, 32, True, 0, [150, 3]),         # padded rows, hd 32
        # one-row prefills of the prefix-cache and chunked serve runs
        (1, 16, 16, 8, 128, True, 0, None),    # qwen3 first chunk, 4 layers
        (1, 64, 16, 8, 128, True, 0, None),    # qwen3 first chunk
        (1, 640, 32, 32, 128, True, 0, None),  # llava first chunk
        (1, 832, 32, 32, 128, True, 0, None),  # llava prefix-cache miss
    ]
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        for B, L, H, Hkv, hd, causal, window, lens in cases:
            q = torch.randn(B, L, H, hd, generator=g, device="cuda").to(dt)
            k = torch.randn(B, L, Hkv, hd, generator=g, device="cuda").to(dt)
            v = torch.randn(B, L, Hkv, hd, generator=g, device="cuda").to(dt)
            ln = None if lens is None else torch.tensor(
                lens, dtype=torch.int32, device="cuda")
            out = ops.flash_attention(q, k, v, causal=causal, window=window,
                                      lengths=ln)
            exp = ref.flash_attention_ref(q, k, v, causal=causal,
                                          window=window, lengths=ln)
            case = f"{dtype} B{B} L{L} H{H}/{Hkv} hd{hd} " \
                f"causal={int(causal)} w={window} lens={lens}"
            errs.append(compare(torch, "flash_attention", case, out, exp,
                                dtype))
            check(torch.equal(out, ops.flash_attention(
                q, k, v, causal=causal, window=window, lengths=ln)),
                  f"flash_attention {case}: two runs differ")
    t = flash_timing(torch, ops, ref, timer, g)
    t["max_abs_err"] = max(errs + [t["max_abs_err"]])
    for name, (H, Hkv) in LARGE_HEADS.items():
        t[name], err = flash_bf16_timing(torch, ops, ref, timer, g, H, Hkv)
        t["max_abs_err"] = max(t["max_abs_err"], err)
    return t


def flash_bf16_timing(torch, ops, ref, timer, g, H, Hkv):
    """K2 in bf16 (one TF32 pass on the tensor cores) at a bf16-served
    config's 8 x 256 bucket: held against its plain version and twice for
    the same bits, then timed beside SDPA and the bound (bf16 bytes; the
    causal pairs' FLOPs over the bf16 tensor-core rate). Returns (times,
    max_abs_err)."""
    F = torch.nn.functional
    B, L, hd = SERVE["slots"], SERVE["prompt"], 128
    q, k, v = (torch.randn(B, L, h, hd, generator=g, device="cuda").to(
        torch.bfloat16) for h in (H, Hkv, Hkv))
    shape = f"bf16 B{B} L{L} H{H} Hkv{Hkv} hd{hd} causal"
    out = ops.flash_attention(q, k, v)
    err = compare(torch, "flash_attention", f"{shape} (timed)", out,
                  ref.flash_attention_ref(q, k, v), "bfloat16")
    check(torch.equal(out, ops.flash_attention(q, k, v)),
          f"flash_attention {shape}: two runs differ")
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    t = times(timer, lambda: ops.flash_attention(q, k, v), "flash_kernel",
              lambda: ref.flash_attention_ref(q, k, v),
              lambda: F.scaled_dot_product_attention(
                  qt, kt, vt, is_causal=True, enable_gqa=True))
    t["bound_ms"], t["bound_by"] = bound_ms(
        2 * (2 * B * L * H * hd + 2 * B * L * Hkv * hd),
        4 * B * H * hd * (L * (L + 1) // 2), "bfloat16")
    t["shape"] = shape
    print(f"  flash_attention bf16 H{H}/{Hkv}: kernel {t['ms']:.4f} ms (call "
          f"{t['call_ms']:.4f}), plain {t['plain_ms']:.4f}, SDPA "
          f"{t['library_ms']:.4f}, bound {t['bound_ms']:.5f} ms "
          f"({t['bound_by']})")
    return t, err


def tf32_bounds(nbytes, flops):
    """Bounds in ms of a tensor-core kernel (K2, K4b) in fp32: its bytes
    over 3.35 TB/s; its FLOPs over the fp32 rate outside the tensor cores
    (``simt``) and, three times over, over the TF32 tensor-core rate
    (``tf32x3``, what the kernel runs). ``bound_ms`` is the larger of the
    bytes and the 3xTF32 time."""
    b = {"bytes": nbytes / PEAK_BYTES_PER_S * 1e3,
         "simt": flops / PEAK_FLOPS["float32"] * 1e3,
         "tf32x3": 3 * flops / PEAK_FLOPS["tf32"] * 1e3}
    bound, by = (b["bytes"], "bytes") if b["bytes"] >= b["tf32x3"] \
        else (b["tf32x3"], "operations")
    return bound, by, b


def flash_bounds(B, L, H, Hkv, hd):
    """K2's ``tf32_bounds`` at a causal fp32 shape: q, k, v read once and
    o written once; 4 hd FLOPs per causal pair."""
    return tf32_bounds(4 * (2 * B * L * H * hd + 2 * B * L * Hkv * hd),
                       4 * B * H * hd * (L * (L + 1) // 2))


def flash_timing(torch, ops, ref, timer, g):
    """K2 timed in fp32 at the three served buckets (``FLASH_SHAPES``;
    qwen3's is K2's row, granite's and llava's its entries of those
    names): the kernel's device time (``flash_kernel``), the wrapper
    call's CUDA-event window, the plain version's and SDPA's device
    time, beside ``flash_bounds``. Takes any tree's ``ops``, so that one
    call can time a parent's kernel too. Returns K2's row with its
    max_abs_err over the timed inputs."""
    rows, errs = {}, []
    for name, shape in FLASH_SHAPES.items():
        rows[name], err = flash_shape_timing(torch, ops, ref, timer, g, name,
                                             *shape)
        errs.append(err)
    t = rows["qwen3"]
    for name in ("granite", "llava"):
        t[name] = {key: rows[name][key] for key in SUB_KEYS + TF32_BOUNDS}
    t["max_abs_err"] = max(errs)
    return t


def flash_shape_timing(torch, ops, ref, timer, g, name, B, L, H, Hkv, hd):
    """K2 at one causal fp32 shape: held against its plain version, then
    the kernel's, the wrapper call's, the plain version's and SDPA's times
    beside ``flash_bounds``. Returns (times, max_abs_err)."""
    F = torch.nn.functional
    q = torch.randn(B, L, H, hd, generator=g, device="cuda")
    k = torch.randn(B, L, Hkv, hd, generator=g, device="cuda")
    v = torch.randn(B, L, Hkv, hd, generator=g, device="cuda")
    shape = f"fp32 B{B} L{L} H{H} Hkv{Hkv} hd{hd} causal"
    err = compare(torch, "flash_attention", f"{shape} (timed)",
                  ops.flash_attention(q, k, v),
                  ref.flash_attention_ref(q, k, v), "float32")
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    t = times(timer, lambda: ops.flash_attention(q, k, v),
              "flash_kernel", lambda: ref.flash_attention_ref(q, k, v),
              lambda: F.scaled_dot_product_attention(
                  qt, kt, vt, is_causal=True, enable_gqa=True))
    t["bound_ms"], t["bound_by"], b = flash_bounds(B, L, H, Hkv, hd)
    t.update({f"bound_{key}_ms": val for key, val in b.items()})
    t["shape"] = shape
    print(f"  flash_attention {name}: kernel {t['ms']:.4f} ms (call "
          f"{t['call_ms']:.4f}), plain {t['plain_ms']:.4f}, SDPA "
          f"{t['library_ms']:.4f}; bounds: bytes {b['bytes']:.5f}, "
          f"fp32 SIMT {b['simt']:.5f}, 3xTF32 {b['tf32x3']:.5f} ms "
          f"({shape})")
    return t, err


def rank_shape_phase(torch, ops, ref, timer):
    """K1, K3 and K2 at a model rank's shapes of qwen3-0.6b at model=2
    (``RANK_HEADS``: 8 query over 4 kv heads, hd 128): K1 and K3 at B 8,
    S 288 with the serve phase's lengths, K2 at the 8 x 256 bucket; and K1
    and K2 at llava-1.5-7b's rank shapes (``LLAVA_RANK_HEADS``); each
    held against its plain version and timed beside its bound and SDPA's
    time (``decode_timing``, ``flash_shape_timing``); K5a and K5b at a
    (2, 2) rank of granite-moe-3b-a800m (``moe_rank_timing``); K2 and K3
    at a model rank of recurrentgemma-2b (``RG_RANK_HEADS``, hd 256:
    ``windowed_flash_timing``, ``decode_timing`` at B 8 and 4). Returns
    ({kernel: {entry: times}}, {kernel: max_abs_err})."""
    g = torch.Generator(device="cuda").manual_seed(12)
    H, Hkv = RANK_HEADS
    B = SERVE["slots"]
    lens = [SERVE["prompt"] + 1 + 4 * i for i in range(B)]
    entries, errs = {}, {}
    for paged, kernel in ((False, "decode_attention"),
                          (True, "paged_decode_attention")):
        t, errs[kernel] = decode_timing(
            torch, ops, ref, timer, g, CACHE_LEN, paged=paged, H=H, Hkv=Hkv,
            lengths=lens if paged else None)
        entries[kernel] = {RANK_ENTRY: {k: t[k] for k in SUB_KEYS + (
            "by_kernel", "sdpa_on_gathered_ms") if k in t}}
    t, errs["flash_attention"] = flash_shape_timing(
        torch, ops, ref, timer, g, RANK_ENTRY, B, SERVE["prompt"], H, Hkv,
        128)
    entries["flash_attention"] = {RANK_ENTRY: {
        k: t[k] for k in SUB_KEYS + TF32_BOUNDS}}
    # llava-1.5-7b at model=2 (``LLAVA_RANK_HEADS``): K1 at the serve
    # phase's decode shape (B 8, S 864), K2 at the vlm ranks phase's
    # bucket of its two requests (2 x 832)
    H, Hkv = LLAVA_RANK_HEADS
    t, err = decode_timing(
        torch, ops, ref, timer, g, MM_CACHE_LEN, paged=True, H=H, Hkv=Hkv,
        lengths=[MM_CACHE_LEN - 31 + 4 * i for i in range(B)])
    errs["paged_decode_attention"] = max(errs["paged_decode_attention"], err)
    entries["paged_decode_attention"][LLAVA_RANK_ENTRY] = {
        k: t[k] for k in SUB_KEYS + ("by_kernel", "sdpa_on_gathered_ms")}
    t, err = flash_shape_timing(
        torch, ops, ref, timer, g, LLAVA_RANK_ENTRY, VLM_REQUESTS,
        IMAGE_TOKENS + SERVE["prompt"], H, Hkv, 128)
    errs["flash_attention"] = max(errs["flash_attention"], err)
    entries["flash_attention"][LLAVA_RANK_ENTRY] = {
        k: t[k] for k in SUB_KEYS + TF32_BOUNDS}
    # granite-moe-3b-a800m at (2, 2): K5a/K5b on the second data rank's
    # 20 experts of a decode step's global tables
    for name, (t, err) in moe_rank_timing(torch, ops, ref, timer, g).items():
        entries[name] = {MOE_RANK_ENTRY: t}
        errs[name] = err
    # recurrentgemma-2b at model=2 (``RG_RANK_HEADS``: 5 query heads
    # beside the whole kv head, hd 256): K2 at a request's one-row
    # prefill in its window, K3 at a decode step of the 8 slots of a
    # ``1,2`` rank and the 4 of a ``2,2`` rank, G 5 in one group
    H, Hkv = RG_RANK_HEADS
    entries["flash_attention"][RG_RANK_ENTRY], err = windowed_flash_timing(
        torch, ops, ref, timer, g, RG_RANK_ENTRY, SERVE["prompt"], H, Hkv,
        "float32")
    errs["flash_attention"] = max(errs["flash_attention"], err)
    for key, rows in ((RG_RANK_ENTRY, B), (RG_RANK_DP2_ENTRY, B // 2)):
        t, err = decode_timing(torch, ops, ref, timer, g, CACHE_LEN, B=rows,
                               H=H, Hkv=Hkv, hd=RG_ATTN["hd"])
        errs["decode_attention"] = max(errs["decode_attention"], err)
        entries["decode_attention"][key] = {
            k: t[k] for k in SUB_KEYS + ("by_kernel",)}
    return entries, errs


def moe_rank_timing(torch, ops, ref, timer, gen):
    """K5a and K5b as a (2, 2) rank of granite-moe-3b-a800m runs them at a
    decode step (``GRANITE_DECODE``): the global step's tables, the
    dispatch on the data rank's experts ``[20, 40)`` (``idx[:, 20:]``),
    the combine through the slot table shifted by ``-20 * C`` over those
    experts' slot rows. Each held against its plain version (K5a bit for
    bit) and timed beside its bound and the one-hot einsum of the same
    tables. Returns {kernel: (times, max_abs_err)}."""
    E, k, d = GRANITE_MOE["E"], GRANITE_MOE["k"], GRANITE_MOE["d"]
    G, g, C = GRANITE_DECODE["G"], GRANITE_DECODE["g"], GRANITE_DECODE["C"]
    E_loc = MOE_RANK_EXPERTS
    e0 = E - E_loc
    idx, slot, gates, _ = moe_tables(torch, gen, G, g, E, C, k)
    idx = idx[:, e0:].contiguous()
    slot = (slot - e0 * C).contiguous()
    mine = (slot >= 0) & (slot < E_loc * C)
    kept = int(mine.sum())
    x = torch.randn(G, g, d, generator=gen, device="cuda")
    eo = torch.randn(G, E_loc, C, d, generator=gen, device="cuda")
    shape = f"fp32 G{G} g{g} E{E_loc} of {E} C{C} k{k} d{d}, {kept} of " \
        f"{G * g * k} choices on the rank's experts"
    out = ops.moe_dispatch(idx, x)
    check(torch.equal(out, ref.moe_dispatch_ref(idx, x)),
          f"moe_dispatch {shape}: differs from the plain version")
    print(f"  {'moe_dispatch':24s} {shape:44s} bit for bit ok")
    err_c = compare(torch, "moe_combine", shape,
                    ops.moe_combine(slot, gates, eo),
                    ref.moe_combine_ref(slot, gates, eo), "float32")
    comb = torch.zeros(G, g, E_loc * C + 1, device="cuda")
    comb.scatter_(2, torch.where(mine, slot, E_loc * C).long(),
                  torch.where(mine, gates, torch.zeros_like(gates)))
    comb = comb[..., :E_loc * C].reshape(G, g, E_loc, C).contiguous()
    disp = torch.zeros(G, E_loc, C, g + 1, device="cuda")
    disp.scatter_(3, torch.where(idx >= 0, idx, g).long()[..., None], 1.0)
    disp = disp[..., :g].permute(0, 3, 1, 2).contiguous()    # (G, g, E, C)
    tk = times(timer, lambda: ops.moe_dispatch(idx, x), "moe_dispatch_kernel",
               lambda: ref.moe_dispatch_ref(idx, x),
               lambda: torch.einsum("gsec,gsd->gecd", disp, x))
    tokens = torch.unique(idx[idx >= 0]).numel()
    tk["bound_ms"], tk["bound_by"] = bound_ms(
        4 * (tokens * d + idx.numel() + idx.numel() * d), 0, "float32")
    tc = times(timer, lambda: ops.moe_combine(slot, gates, eo),
               "moe_combine_kernel", lambda: ref.moe_combine_ref(slot, gates, eo),
               lambda: torch.einsum("gsec,gecd->gsd", comb, eo))
    tc["bound_ms"], tc["bound_by"] = bound_ms(
        4 * (kept * d + 2 * slot.numel() + G * g * d), 2 * kept * d,
        "float32")
    return {name: (dict(shape=shape, **{k_: t[k_] for k_ in SUB_KEYS
                                          if k_ in t}), err)
            for name, t, err in (("moe_dispatch", tk, 0.0),
                                 ("moe_combine", tc, err_c))}


def ring_mask(torch, pos, S):
    slot = torch.arange(S, device="cuda")
    p = pos[:, None]
    return p - torch.remainder(p - slot[None, :], S) >= 0


def decode_timing(torch, ops, ref, timer, g, S, paged=False, B=8, H=16,
                  Hkv=8, hd=128, lengths=None, pool=None, dtype="float32"):
    """K3 (dense cache) or, with ``paged``, K1 (a pool of 16-row pages,
    each row's S slots through its block table) timed in ``dtype`` (fp32
    or bf16: q and the cache) at B, H, Hkv, hd (by default qwen3's heads)
    with S cache slots a row; K1's pool may instead hold int8 or fp8
    values with fp32 scales (``pool``: the storage dtype), the bound then
    counting 1-byte values and the scales. The valid rows are those at or below a position in the last
    32 slots (K3: a ring mask; K1: lengths = position + 1), or below
    ``lengths`` (K1).
    Returns (times, max_abs_err against the plain version): the device
    time of every kernel the wrapper runs (split and combine; the
    breakdown under ``by_kernel``), the plain version's, SDPA's on the
    dense cache (K3: ``library_ms``) or on the view gathered from the
    pages (K1: ``sdpa_on_gathered_ms``; no one PyTorch call reads a block
    table, so K1's ``library_ms`` is null), and the byte bound of the
    valid rows."""
    F = torch.nn.functional
    if lengths is None:
        pos = torch.randint(max(0, S - 32), S, (B,), generator=g,
                            device="cuda")
    dt = getattr(torch, dtype)
    value_bytes, scale_bytes = dt.itemsize, 0
    if paged:
        from repro_torch.models.attention import kv_quantize
        ps = SERVE["page"]
        n = S // ps
        pool = pool or dt
        q, kp, vp, bt, ln, ks, vs = paged_setup(
            torch, g, B, H, Hkv, hd, ps, n,
            (pos + 1).tolist() if lengths is None else lengths,
            pool, dt, kv_quantize)
        fn = lambda: ops.paged_decode_attention(  # noqa: E731
            q, kp, vp, bt, ln, k_scale=ks, v_scale=vs)
        plain = lambda: ref.paged_decode_attention_ref(  # noqa: E731
            q, kp, vp, bt, ln, k_scale=ks, v_scale=vs)
        k = kp[bt.long()].reshape(B, S, Hkv, hd).float()
        v = vp[bt.long()].reshape(B, S, Hkv, hd).float()
        if ks is not None:      # SDPA reads the view dequantized
            k = k * ks[bt.long()].reshape(B, S, Hkv)[..., None]
            v = v * vs[bt.long()].reshape(B, S, Hkv)[..., None]
            value_bytes, scale_bytes = kp.element_size(), 4
        k, v = k.to(q.dtype), v.to(q.dtype)
        mask = torch.arange(S, device="cuda")[None, :] < ln[:, None]
        name, index_bytes = "paged_decode_attention", 4 * (bt.numel() + B)
        pname = str(pool).replace("torch.", "")
        shape = f"{pname} pool, {DT_NAMES[dtype]} q, B{B} H{H} Hkv{Hkv} " \
            f"hd{hd} ps{ps} n{n} lengths {int(ln.min())}..{int(ln.max())}"
    else:
        q, k, v = (torch.randn(B, n_, H_, hd, generator=g,
                               device="cuda").to(dt)
                   for n_, H_ in ((1, H), (S, Hkv), (S, Hkv)))
        mask = ring_mask(torch, pos, S)
        fn = lambda: ops.decode_attention(q, k, v, mask)   # noqa: E731
        plain = lambda: ref.decode_attention_ref(  # noqa: E731
            q, k, v, mask)
        name, index_bytes = "decode_attention", mask.numel()
        shape = f"{DT_NAMES[dtype]} B{B} S{S} H{H} Hkv{Hkv} hd{hd} ring mask"
    err = compare(torch, name, f"{dtype} B{B} S{S} H{H}/{Hkv} hd{hd} "
                  "(timed)", fn(), plain(), dtype)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    am = mask[:, None, None, :]
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, attn_mask=am, enable_gqa=True)
    t = times(timer, fn, None, plain, None if paged else sdpa)
    if paged:
        t["sdpa_on_gathered_ms"] = timer.device_ms(sdpa)
    t["by_kernel"] = timer.by_kernel(fn)
    live = int(mask.sum())
    nbytes = 2 * q.element_size() * q.numel() + index_bytes + \
        2 * live * Hkv * (value_bytes * hd + scale_bytes)
    t["bound_ms"], t["bound_by"] = bound_ms(nbytes, 4 * H * hd * live,
                                            dtype)
    # another tree's ops (an A/B's parent) may not group heads
    groups = getattr(ops, "decode_groups", lambda G: 1)(H // Hkv)
    n_split, rows = ops.decode_splits(
        B, Hkv * groups, S,
        torch.cuda.get_device_properties(0).multi_processor_count)
    t["S"] = S
    t["shape"] = f"{shape}, {n_split} splits of {rows} rows" + (
        f", {groups} head groups" if groups > 1 else "")
    sdpa_ms = t["sdpa_on_gathered_ms"] if paged else t["library_ms"]
    print(f"  {name} S {S}: kernel {t['ms']:.4f} ms, plain "
          f"{t['plain_ms']:.4f} ms, SDPA {sdpa_ms:.4f} ms, bound "
          f"{t['bound_ms']:.5f} ms ({shape}); by kernel: " + ", ".join(
              f"{k_[:60]} {ms:.4f} ms" for k_, ms in t["by_kernel"].items()))
    return t, err


def decode_phase(torch, ops, ref, timer):
    """K3 against its plain version at the serving, granite and ragged
    shapes, at the split plan's edges (only the first split valid, one
    split, a ragged last split), at a row with no valid key under several
    splits and under one, and at the launcher's other instantiations
    (G 8; rows copied in 4- and 2-byte units), twice each for the same
    bits; then timed (``decode_timing``) at each cache length of
    ``DECODE_SWEEP``: the serving length is K3's row, the reference's
    decode_32k length its "long" entry."""
    g = torch.Generator(device="cuda").manual_seed(2)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    errs = []
    cases = [  # (B, S, H, Hkv, hd, mask kind)
        (8, CACHE_LEN, 16, 8, 128, "ring"),    # serving decode, mid-run
        (2, 300, 8, 2, 64, "random"),          # S not a tile multiple, G=4
        (3, 128, 4, 4, 128, "ring"),           # G = 1
        (8, CACHE_LEN, 24, 8, 64, "ring"),     # granite decode, G = 3
        (8, 4096, 16, 8, 128, "first split"),  # rows only in split 0
        (8, 16, 16, 8, 128, "ring"),           # one split, no combine
        (4, 1000, 8, 2, 64, "random"),         # ragged last split
        (2, 300, 16, 2, 128, "ring"),          # G = 8
        (3, 500, 8, 4, 33, "random"),  # 4-byte units (fp32), 2-byte (bf16)
        (2, 200, 6, 2, 36, "ring"),    # 16-byte units (fp32), 4-byte (bf16)
        (3, 300, 8, 4, 128, "empty row"),      # no valid key, splits
        (3, 16, 8, 4, 128, "empty row"),       # no valid key, one split
    ]
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        for B, S, H, Hkv, hd, kind in cases:
            n_split, rows = ops.decode_splits(B, Hkv, S, sms)
            q = torch.randn(B, 1, H, hd, generator=g, device="cuda").to(dt)
            k = torch.randn(B, S, Hkv, hd, generator=g, device="cuda").to(dt)
            v = torch.randn(B, S, Hkv, hd, generator=g, device="cuda").to(dt)
            if kind == "ring":
                pos = torch.randint(0, S, (B,), generator=g, device="cuda")
                mask = ring_mask(torch, pos, S)
            elif kind == "first split":   # early in every request
                pos = torch.randint(0, rows, (B,), generator=g,
                                    device="cuda")
                mask = ring_mask(torch, pos, S)
                check(n_split > 1 and not bool(mask[:, rows:].any()),
                      "decode case: valid rows past the first split")
            else:
                mask = torch.rand(B, S, generator=g, device="cuda") < 0.75
                mask[:, :2] = True
                if kind == "empty row":   # the mean of V over all S rows
                    mask[1] = False
            out = ops.decode_attention(q, k, v, mask)
            exp = ref.decode_attention_ref(q, k, v, mask)
            case = f"{dtype} B{B} S{S} H{H}/{Hkv} hd{hd} {kind} " \
                f"{n_split}x{rows}"
            errs.append(compare(torch, "decode_attention", case, out, exp,
                                dtype))
            check(torch.equal(out, ops.decode_attention(q, k, v, mask)),
                  f"decode_attention {case}: two runs differ")

    sweep = {}
    for S in DECODE_SWEEP:
        sweep[S], err = decode_timing(torch, ops, ref, timer, g, S)
        errs.append(err)
    t = sweep[CACHE_LEN]
    t["max_abs_err"] = max(errs)
    t["long"] = {key: sweep[DECODE_LONG][key]
                 for key in SUB_KEYS + ("by_kernel",)}
    t["sweep"] = [{key: tt[key] for key in ("S", "ms", "library_ms",
                                            "bound_ms")}
                  for tt in sweep.values()]
    return t


def paged_setup(torch, g, B, H, Hkv, hd, ps, n, lengths, pool_dtype, q_dtype,
                kv_quantize):
    """Random fp32 pages cast or quantized to ``pool_dtype`` and a block
    table of distinct pages in random order (page 0 unused)."""
    P = B * n + 3
    q = torch.randn(B, 1, H, hd, generator=g, device="cuda").to(q_dtype)
    kf = torch.randn(P, ps, Hkv, hd, generator=g, device="cuda")
    vf = torch.randn(P, ps, Hkv, hd, generator=g, device="cuda")
    ks = vs = None
    if pool_dtype in (torch.int8, torch.float8_e4m3fn):
        kp, ks = kv_quantize(kf, pool_dtype)
        vp, vs = kv_quantize(vf, pool_dtype)
    else:
        kp, vp = kf.to(pool_dtype), vf.to(pool_dtype)
    perm = torch.randperm(P - 1, generator=g, device="cuda")[:B * n] + 1
    bt = perm.reshape(B, n).to(torch.int32)            # pages out of order
    ln = torch.as_tensor(lengths, dtype=torch.int32, device="cuda")
    return q, kp, vp, bt, ln, ks, vs


def paged_phase(torch, ops, ref, timer, kv_quantize):
    """K1 against its plain version in five (q, pool) kinds at the serving
    shapes, at the split plan's edges (only the first split live, one
    split, a ragged last split, lengths past n * ps), at block tables the
    engine makes or must survive (two rows sharing pages, as copy-on-write
    seeding leaves them; page ids out of range, clipped), at page sizes 8,
    64 and 6 (no multiple of 4: rows are looked up one by one), at G 8,
    at hd 33 and 36 (copy units of 4, 2 and 1 bytes), and at a row with no
    valid key under several splits and under one, twice each for the same
    bits; then timed (``decode_timing``) at llava's and granite's
    decode shapes and at qwen3's heads over ``DECODE_SWEEP``
    (``paged_timing``)."""
    g = torch.Generator(device="cuda").manual_seed(3)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    n_serve = CACHE_LEN // SERVE["page"]
    serve_lens = [SERVE["prompt"] + 1 + 4 * i for i in range(8)]
    errs = []
    cases = [  # (label, B, H, Hkv, hd, ps, n, lengths)
        ("qwen3 serving", 8, 16, 8, 128, SERVE["page"], n_serve, serve_lens),
        ("length 1, ragged", 3, 8, 2, 64, 16, 5, [1, 37, 80]),
        ("ps 64", 3, 4, 4, 128, 64, 3, [64, 130, 5]),
        ("granite G 3", 8, 24, 8, 64, SERVE["page"], n_serve, serve_lens),
        ("first split only", 8, 16, 8, 128, 16, 256, None),
        ("one split", 8, 16, 8, 128, 16, 1, [1, 2, 5, 8, 11, 13, 15, 16]),
        ("ragged last split", 4, 8, 2, 64, 16, 63, [1008, 1001, 977, 100]),
        ("lengths past n*ps", 3, 8, 4, 128, 16, 4, [69, 164, 64]),
        ("shared pages", 4, 16, 8, 128, 16, 18, [288, 200, 150, 30]),
        ("page ids out of range", 3, 16, 8, 128, 16, 18, [288, 250, 100]),
        ("ps 8", 3, 8, 2, 128, 8, 40, [320, 171, 9]),
        ("ps 64, splits", 2, 16, 8, 128, 64, 10, [640, 300]),
        ("ps 6", 3, 8, 2, 64, 6, 50, [300, 133, 7]),
        ("G 8", 2, 16, 2, 128, 16, 19, [300, 151]),
        ("hd 33", 3, 8, 4, 33, 16, 32, [500, 250, 17]),
        ("hd 36", 2, 6, 2, 36, 16, 13, [200, 101]),
        # no valid key: the mean of V over the row's n * ps slots
        ("empty row", 3, 8, 4, 128, 16, 20, [300, 0, 77]),
        ("empty row, one split", 3, 8, 4, 128, 16, 1, [16, 0, 5]),
    ]
    kinds = [("float32", torch.float32), ("bfloat16", torch.bfloat16),
             ("float32", torch.int8), ("bfloat16", torch.int8),
             ("float32", torch.float8_e4m3fn)]
    for qname, pool_dtype in kinds:
        q_dtype = getattr(torch, qname)
        for label, B, H, Hkv, hd, ps, n, lens in cases:
            n_split, rows = ops.decode_splits(B, Hkv, n * ps, sms)
            if lens is None:   # early in every request: split 0 only
                lens = torch.randint(1, rows, (B,), generator=g,
                                     device="cuda").tolist()
                check(n_split > 1, f"paged case {label}: one split")
            q, kp, vp, bt, ln, ks, vs = paged_setup(
                torch, g, B, H, Hkv, hd, ps, n, lens, pool_dtype, q_dtype,
                kv_quantize)
            if label == "shared pages":
                bt[1, :13] = bt[0, :13]
            elif label == "page ids out of range":
                bt[0, 1], bt[1, 0], bt[2, 5] = -5, kp.shape[0] + 7, -1
            out = ops.paged_decode_attention(q, kp, vp, bt, ln, k_scale=ks,
                                             v_scale=vs)
            exp = ref.paged_decode_attention_ref(q, kp, vp, bt, ln,
                                                 k_scale=ks, v_scale=vs)
            pname = str(pool_dtype).replace("torch.", "")
            case = f"q {qname} pool {pname} {label}: B{B} H{H}/{Hkv} " \
                f"hd{hd} ps{ps} n{n} {n_split}x{rows}"
            errs.append(compare(torch, "paged_decode_attention", case, out,
                                exp, qname))
            check(torch.equal(out, ops.paged_decode_attention(
                q, kp, vp, bt, ln, k_scale=ks, v_scale=vs)),
                  f"paged_decode_attention {case}: two runs differ")

    t, err = paged_timing(torch, ops, ref, timer, g)
    t["max_abs_err"] = max(errs + [err])
    return t


def paged_timing(torch, ops, ref, timer, g):
    """K1 timed (``decode_timing``) at qwen3's heads over ``DECODE_SWEEP``
    (at the serving length with the serve phase's lengths: K1's row; the
    reference's decode_32k length: its "long" entry), at llava's and
    granite's decode shapes, and at qwen3's serving shape on int8 and fp8
    pools (the quantized serve runs' shape; "int8", "fp8" entries). Takes
    any tree's ``ops``, so that one call can time a parent's kernel too.
    Returns (times, max_abs_err)."""
    serve_lens = [SERVE["prompt"] + 1 + 4 * i for i in range(8)]
    sweep, errs = {}, []
    for S in DECODE_SWEEP:
        sweep[S], err = decode_timing(
            torch, ops, ref, timer, g, S, paged=True,
            lengths=serve_lens if S == CACHE_LEN else None)
        errs.append(err)
    llava, err = decode_timing(
        torch, ops, ref, timer, g, MM_CACHE_LEN, paged=True, H=32, Hkv=32,
        lengths=[MM_CACHE_LEN - 31 + 4 * i for i in range(8)])
    errs.append(err)
    granite, err = decode_timing(
        torch, ops, ref, timer, g, CACHE_LEN, paged=True, H=24, Hkv=8, hd=64,
        lengths=serve_lens)
    errs.append(err)
    quant = {}
    for key, pool in (("int8", torch.int8), ("fp8", torch.float8_e4m3fn)):
        quant[key], err = decode_timing(
            torch, ops, ref, timer, g, CACHE_LEN, paged=True,
            lengths=serve_lens, pool=pool)
        errs.append(err)
    t = sweep[CACHE_LEN]
    for key, tt in (("llava", llava), ("granite", granite),
                    ("long", sweep[DECODE_LONG]), *quant.items()):
        t[key] = {k_: tt[k_] for k_ in SUB_KEYS + ("sdpa_on_gathered_ms",
                                                   "by_kernel")}
    t["sweep"] = [{key: tt[key] for key in ("S", "ms", "sdpa_on_gathered_ms",
                                            "bound_ms")}
                  for tt in sweep.values()]
    return t, max(errs)


def any_g_phase(torch, ops, ref, timer, kv_quantize):
    """K3 and K1 at any number of query heads a kv head: G 5, 7, 12 and 48
    (H 40/8, 56/8, 24/2, 48/1; hd 128, B 8, S 288 and 4096), fp32 and
    bf16, K1 also on int8 and fp8 pools at G 48, with a batch row without
    a valid key at S 4096, each against its plain version and twice for
    the same bits; then both timed (``decode_timing``) at the bf16-served
    configs' decode shapes (B 8, S 288, the serve phase's lengths), K1
    also on int8 and fp8 pools at G 48. A G above 8 runs in groups of at
    most 8 query heads, a block each (``ops.decode_groups``). Returns
    ({kernel: {entry: times}}, {kernel: max_abs_err})."""
    g = torch.Generator(device="cuda").manual_seed(8)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    B, hd, ps = SERVE["slots"], 128, SERVE["page"]
    serve_lens = [SERVE["prompt"] + 1 + 4 * i for i in range(B)]
    errs = {"decode_attention": [], "paged_decode_attention": []}
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        for H, Hkv in ((40, 8), (56, 8), (24, 2), (48, 1)):
            G = H // Hkv
            for S in (CACHE_LEN, 4096):
                n_split, rows = ops.decode_splits(
                    B, Hkv * ops.decode_groups(G), S, sms)
                plan = f"{n_split}x{rows}, {ops.decode_groups(G)} groups"
                q, k, v = (torch.randn(B, n_, h, hd, generator=g,
                                       device="cuda").to(dt)
                           for n_, h in ((1, H), (S, Hkv), (S, Hkv)))
                pos = torch.randint(0, S, (B,), generator=g, device="cuda")
                mask = ring_mask(torch, pos, S)
                lens = serve_lens if S == CACHE_LEN else \
                    torch.randint(1, S + 1, (B,), generator=g,
                                  device="cuda").tolist()
                if S > CACHE_LEN:          # a row with no valid key
                    mask[1] = False
                    lens[1] = 0
                case = f"{dtype} B{B} S{S} H{H}/{Hkv} (G {G}) hd{hd} {plan}"
                out = ops.decode_attention(q, k, v, mask)
                errs["decode_attention"].append(compare(
                    torch, "decode_attention", case, out,
                    ref.decode_attention_ref(q, k, v, mask), dtype))
                check(torch.equal(out, ops.decode_attention(q, k, v, mask)),
                      f"decode_attention {case}: two runs differ")
                pools = [dt] + ([torch.int8, torch.float8_e4m3fn]
                                if G == 48 else [])
                for pool in pools:
                    q, kp, vp, bt, ln, ks, vs = paged_setup(
                        torch, g, B, H, Hkv, hd, ps, S // ps, lens, pool,
                        dt, kv_quantize)
                    pname = str(pool).replace("torch.", "")
                    pcase = f"q {dtype} pool {pname} B{B} n*ps {S} " \
                        f"H{H}/{Hkv} (G {G}) {plan}"
                    out = ops.paged_decode_attention(
                        q, kp, vp, bt, ln, k_scale=ks, v_scale=vs)
                    errs["paged_decode_attention"].append(compare(
                        torch, "paged_decode_attention", pcase, out,
                        ref.paged_decode_attention_ref(
                            q, kp, vp, bt, ln, k_scale=ks, v_scale=vs),
                        dtype))
                    check(torch.equal(out, ops.paged_decode_attention(
                        q, kp, vp, bt, ln, k_scale=ks, v_scale=vs)),
                          f"paged_decode_attention {pcase}: two runs differ")
                del q, k, v, kp, vp
    timed = {"decode_attention": {}, "paged_decode_attention": {}}
    for name, (H, Hkv) in LARGE_HEADS.items():
        for paged, kernel in ((False, "decode_attention"),
                              (True, "paged_decode_attention")):
            t, err = decode_timing(torch, ops, ref, timer, g, CACHE_LEN,
                                   paged=paged, H=H, Hkv=Hkv,
                                   lengths=serve_lens if paged else None,
                                   dtype="bfloat16")
            errs[kernel].append(err)
            timed[kernel][name] = t
    for key, pool in (("int8", torch.int8), ("fp8", torch.float8_e4m3fn)):
        t, err = decode_timing(torch, ops, ref, timer, g, CACHE_LEN,
                               paged=True, H=48, Hkv=1, lengths=serve_lens,
                               pool=pool, dtype="bfloat16")
        errs["paged_decode_attention"].append(err)
        timed["paged_decode_attention"][f"granite-34b {key}"] = t
    for kernel, entries in timed.items():
        for key, t in entries.items():
            entries[key] = {k_: t[k_] for k_ in SUB_KEYS + (
                "by_kernel", "sdpa_on_gathered_ms") if k_ in t}
    return timed, {k_: max(v_) for k_, v_ in errs.items()}


def window_pairs(L, window):
    """(query, key) pairs of a causal prefill of L tokens under a sliding
    window (a key at most ``window - 1`` positions back)."""
    return sum(min(i + 1, window) for i in range(L))


def hd256_phase(torch, ops, ref, timer):
    """K2 and K3 at recurrentgemma-2b's local attention (``RG_ATTN``: H 10
    over one kv head, head_dim 256, window 2048), fp32 and bf16, each
    against its plain version and twice for the same bits: K2 at the
    served one-row prefill (L 256), at L 3072 (the window binds), at a
    ragged L 200 and with key lengths; K3 at the served decode (B 8,
    S 288, a ring mask), on a 2048-slot ring whose positions wrapped past
    it under ``ring_mask``'s window term (window 2048, and 1536, which
    excludes rows), and at a row with no valid key under several splits
    and one. Then timed: K2 at the served prefill in fp32 and bf16 and at
    L 3072 in fp32 beside SDPA and its bounds (bytes; the window's causal
    pairs over the 3xTF32 or bf16 tensor-core rate), K3 at the served
    decode (``decode_timing``). Returns ({kernel: {entry: times}},
    {kernel: max_abs_err})."""
    g = torch.Generator(device="cuda").manual_seed(9)
    H, Hkv, hd, W = (RG_ATTN[k] for k in ("H", "Hkv", "hd", "window"))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    errs = {"flash_attention": [], "decode_attention": []}
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        for B, L, lens in ((1, SERVE["prompt"], None), (1, 3072, None),
                           (1, 200, None), (2, 200, [200, 77])):
            q, k, v = (torch.randn(B, L, h, hd, generator=g,
                                   device="cuda").to(dt)
                       for h in (H, Hkv, Hkv))
            ln = None if lens is None else torch.tensor(
                lens, dtype=torch.int32, device="cuda")
            out = ops.flash_attention(q, k, v, window=W, lengths=ln)
            case = f"{dtype} B{B} L{L} H{H}/{Hkv} hd{hd} w={W} lens={lens}"
            errs["flash_attention"].append(compare(
                torch, "flash_attention", case, out,
                ref.flash_attention_ref(q, k, v, window=W, lengths=ln),
                dtype))
            check(torch.equal(out, ops.flash_attention(q, k, v, window=W,
                                                       lengths=ln)),
                  f"flash_attention {case}: two runs differ")
            del q, k, v
        for B, S, kind, win in ((8, CACHE_LEN, "ring", W),
                                (8, 2048, "wrapped", W),
                                (8, 2048, "wrapped", 1536),
                                (3, CACHE_LEN, "empty row", W),
                                (3, 16, "empty row", W)):
            q, k, v = (torch.randn(B, n_, h, hd, generator=g,
                                   device="cuda").to(dt)
                       for n_, h in ((1, H), (S, Hkv), (S, Hkv)))
            pos = torch.randint(0, S, (B,), generator=g, device="cuda")
            if kind == "wrapped":
                pos = pos + S + 1
            slot = torch.arange(S, device="cuda")
            slot_pos = pos[:, None] - torch.remainder(
                pos[:, None] - slot[None, :], S)
            mask = (slot_pos >= 0) & (slot_pos > pos[:, None] - win)
            if kind == "empty row":
                mask[1] = False
            n_split, rows = ops.decode_splits(
                B, Hkv * ops.decode_groups(H // Hkv), S, sms)
            case = f"{dtype} B{B} S{S} H{H}/{Hkv} hd{hd} {kind} w={win} " \
                f"{n_split}x{rows}, {ops.decode_groups(H // Hkv)} groups"
            out = ops.decode_attention(q, k, v, mask)
            errs["decode_attention"].append(compare(
                torch, "decode_attention", case, out,
                ref.decode_attention_ref(q, k, v, mask), dtype))
            check(torch.equal(out, ops.decode_attention(q, k, v, mask)),
                  f"decode_attention {case}: two runs differ")
            del q, k, v
    timed = {"flash_attention": {}, "decode_attention": {}}
    for key, L, dtype in (("recurrentgemma-2b", SERVE["prompt"], "float32"),
                          ("recurrentgemma-2b bf16", SERVE["prompt"],
                           "bfloat16"),
                          ("recurrentgemma-2b L3072", 3072, "float32")):
        timed["flash_attention"][key], err = windowed_flash_timing(
            torch, ops, ref, timer, g, key, L, H, Hkv, dtype)
        errs["flash_attention"].append(err)
    t, err = decode_timing(torch, ops, ref, timer, g, CACHE_LEN, H=H,
                           Hkv=Hkv, hd=hd)
    errs["decode_attention"].append(err)
    timed["decode_attention"]["recurrentgemma-2b"] = {
        k_: t[k_] for k_ in SUB_KEYS + ("by_kernel",)}
    return timed, {k_: max(v_) for k_, v_ in errs.items()}


def windowed_flash_timing(torch, ops, ref, timer, g, key, L, H, Hkv,
                          dtype):
    """K2 at a one-row prefill of recurrentgemma-2b's local attention (B 1,
    L tokens, H over Hkv heads of 256, its window of 2048), in ``dtype``:
    held against its plain version, then timed beside SDPA under the
    window's band mask and its bounds (bytes; the window's causal pairs
    over the 3xTF32 or bf16 tensor-core rate). Returns (its entry,
    max_abs_err)."""
    F = torch.nn.functional
    hd, W = RG_ATTN["hd"], RG_ATTN["window"]
    dt = getattr(torch, dtype)
    q, k, v = (torch.randn(1, L, h, hd, generator=g, device="cuda").to(dt)
               for h in (H, Hkv, Hkv))
    shape = f"{DT_NAMES[dtype]} B1 L{L} H{H} Hkv{Hkv} hd{hd} causal " \
        f"window {W}"
    err = compare(torch, "flash_attention", f"{shape} (timed)",
                  ops.flash_attention(q, k, v, window=W),
                  ref.flash_attention_ref(q, k, v, window=W), dtype)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    band = torch.ones(L, L, dtype=torch.bool, device="cuda").tril() & \
        ~torch.ones(L, L, dtype=torch.bool, device="cuda").tril(-W)
    t = times(timer, lambda: ops.flash_attention(q, k, v, window=W),
              "flash_kernel",
              lambda: ref.flash_attention_ref(q, k, v, window=W),
              lambda: F.scaled_dot_product_attention(
                  qt, kt, vt, attn_mask=band, enable_gqa=True))
    nbytes = dt.itemsize * (2 * L * H * hd + 2 * L * Hkv * hd)
    flops = 4 * H * hd * window_pairs(L, W)
    if dtype == "float32":
        t["bound_ms"], t["bound_by"], b = tf32_bounds(nbytes, flops)
        t.update({f"bound_{k_}_ms": val for k_, val in b.items()})
    else:
        t["bound_ms"], t["bound_by"] = bound_ms(nbytes, flops, dtype)
    t["shape"] = shape
    print(f"  flash_attention {key}: kernel {t['ms']:.4f} ms (call "
          f"{t['call_ms']:.4f}), plain {t['plain_ms']:.4f}, SDPA "
          f"{t['library_ms']:.4f}, bound {t['bound_ms']:.5f} ms "
          f"({t['bound_by']}; {shape})")
    return {k_: t[k_] for k_ in SUB_KEYS + TF32_BOUNDS if k_ in t}, err


def xmodal_max_bounds(B, Nt, Nv, d):
    """K4b's ``tf32_bounds`` at an fp32 shape: txt and vis read once and
    the (B,) sums written once; 2 Nt Nv d FLOPs a batch row."""
    return tf32_bounds(4 * (B * Nt * d + B * Nv * d + B),
                       2 * B * Nt * Nv * d)


def xmodal_phase(torch, ops, ref, timer):
    """K4a (masked token-visual cosine sum) and K4b (sum of each text row's
    best visual cosine), each against its plain version and twice for the
    same bits, and the composed score. Both compute in fp32 from the same
    input values, so bf16 inputs take the fp32 tolerance. K4b's split plan
    takes one split at the two short-d cases and several at the serving
    shape and at d 1004 (whose bf16 rows lie off a 16-byte boundary:
    element copies); both kinds must occur. Timed at llava's serving shape,
    at internvl2-2b's (256 image rows of width 2048) and at
    seamless-m4t-large-v2's (512 audio frames of width 1024)."""
    g = torch.Generator(device="cuda").manual_seed(4)
    serving = (1, SERVE["max_new"], IMAGE_TOKENS, SERVE["prompt"], 4096)
    internvl = (1, SERVE["max_new"], INTERNVL_TOKENS, SERVE["prompt"],
                INTERNVL_D)
    seamless = (1, SERVE["max_new"], SEAMLESS["frames"], SERVE["prompt"],
                SEAMLESS["d"])
    cases = [serving, internvl, seamless,  # (B, L, Nv, Nt, d)
             (3, 1, 7, 129, 48),           # ragged rows, d not a chunk multiple
             (2, 33, 65, 31, 100),
             (2, 8, 100, 70, 1004)]        # ragged, split d
    errs = {"xmodal_score_mean": [], "xmodal_score_max": []}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plans = set()

    def inputs(B, L, Nv, Nt, d, dt):
        tok, vis, txt = (torch.randn(B, n, d, generator=g, device="cuda")
                         for n in (L, Nv, Nt))
        k = min(Nv, Nt)                    # some strong text-visual matches
        vis[:, :k] += 2 * txt[:, :k]
        mask = (torch.rand(B, L, generator=g, device="cuda") < 0.7).float()
        return tok.to(dt), mask, vis.to(dt), txt.to(dt)

    for dtype in ("float32", "bfloat16"):
        for B, L, Nv, Nt, d in cases:
            tok, mask, vis, txt = inputs(B, L, Nv, Nt, d,
                                         getattr(torch, dtype))
            if B > 1:
                mask[-1] = 0.0             # a row with no live token
                tok[0, -1] = 0.0           # zero rows: cos 0 by the
                vis[0, 1] = 0.0            # 1e-8 floor of the norm
                txt[0, 2] = 0.0
            n_split, cols = ops.xmodal_max_splits(B, Nt, Nv, d, sms)
            plans.add(n_split > 1)
            case = f"{dtype} B{B} L{L} Nv{Nv} Nt{Nt} d{d}"
            sum1 = ops.xmodal_mean_sum(tok, mask, vis)
            errs["xmodal_score_mean"].append(compare(
                torch, "xmodal_score_mean", case, sum1,
                ref.xmodal_mean_sum_ref(tok, mask, vis), "float32"))
            check(torch.equal(sum1, ops.xmodal_mean_sum(tok, mask, vis)),
                  f"xmodal_score_mean {case}: two runs differ")
            sum2 = ops.xmodal_max_sum(txt, vis)
            errs["xmodal_score_max"].append(compare(
                torch, "xmodal_score_max", f"{case} S{n_split}x{cols}",
                sum2, ref.xmodal_max_sum_ref(txt, vis), "float32"))
            check(torch.equal(sum2, ops.xmodal_max_sum(txt, vis)),
                  f"xmodal_score_max {case}: two runs differ")
            out = ops.xmodal_score(tok, mask, vis, txt)
            compare(torch, "xmodal_score", case, out,
                    ref.xmodal_score_ref(tok, mask, vis, txt), "float32")
            check(torch.equal(out, ops.xmodal_score(tok, mask, vis, txt)),
                  f"xmodal_score {case}: two runs differ")
    check(plans == {False, True},
          "xmodal_score_max: the cases must take one split and several")
    # timing at the serving shapes: one finished candidate's 32 tokens
    # (all live) against llava's 576 image rows and a 256-token prompt
    # (the kernels' rows), against internvl2-2b's 256 of width 2048 and
    # seamless-m4t-large-v2's 512 audio frames of width 1024 (their
    # entries of those names), fp32
    timed = {}
    for key, (B, L, Nv, Nt, d) in (("llava", serving),
                                   ("internvl2-2b", internvl),
                                   (SEAMLESS["name"], seamless)):
        tok, mask, vis, txt = inputs(B, L, Nv, Nt, d, torch.float32)
        mask.fill_(1.0)
        shape = f"fp32 B{B} L{L} Nv{Nv} Nt{Nt} d{d}"
        t_mean = times(timer, lambda: ops.xmodal_mean_sum(tok, mask, vis),
                       "xmodal_mean_kernel",
                       lambda: ref.xmodal_mean_sum_ref(tok, mask, vis))
        t_mean["shape"] = shape
        t_mean["by_kernel"] = timer.by_kernel(
            lambda: ops.xmodal_mean_sum(tok, mask, vis))
        print(f"  xmodal_score_mean {key} by kernel: " + ", ".join(
            f"{k_[:40]} {ms:.5f} ms"
            for k_, ms in t_mean["by_kernel"].items()))
        # operations of the factored sum, 4 an element: its square, and
        # its term of u (visual rows) or of a dot with u (token rows)
        t_mean["bound_ms"], t_mean["bound_by"] = bound_ms(
            4 * (B * L * d + B * L + B * Nv * d + B), 4 * B * (L + Nv) * d,
            "float32")
        t_max = times(timer, lambda: ops.xmodal_max_sum(txt, vis),
                      "xmodal_max_kernel",
                      lambda: ref.xmodal_max_sum_ref(txt, vis))
        t_max["shape"] = shape
        t_max["splits"] = ops.xmodal_max_splits(B, Nt, Nv, d, sms)
        t_max["by_kernel"] = timer.by_kernel(
            lambda: ops.xmodal_max_sum(txt, vis))
        t_max["bound_ms"], t_max["bound_by"], b = xmodal_max_bounds(
            B, Nt, Nv, d)
        t_max.update({f"bound_{k_}_ms": val for k_, val in b.items()})
        print(f"  xmodal_score_max {key} by kernel: " + ", ".join(
            f"{k_[:40]} {ms:.5f} ms"
            for k_, ms in t_max["by_kernel"].items()) +
            f"; splits {t_max['splits']}; bounds: bytes {b['bytes']:.5f}, "
            f"fp32 SIMT {b['simt']:.5f}, 3xTF32 {b['tf32x3']:.5f} ms")
        timed[key] = (t_mean, t_max)
    t_mean, t_max = timed["llava"]
    for key in ("internvl2-2b", SEAMLESS["name"]):
        sub_mean, sub_max = timed[key]
        t_mean[key] = {k_: sub_mean[k_] for k_ in SUB_KEYS + ("by_kernel",)}
        t_max[key] = {k_: sub_max[k_] for k_ in
                      SUB_KEYS + ("by_kernel", "splits") + TF32_BOUNDS}
    t_mean["max_abs_err"] = max(errs["xmodal_score_mean"])
    t_max["max_abs_err"] = max(errs["xmodal_score_max"])
    return {"xmodal_score_mean": t_mean, "xmodal_score_max": t_max}


def moe_tables(torch, gen, G, g, E, C, k, skew=0.0):
    """Index tables of a capacity dispatch (the port's own
    ``dispatch_tables``: choice-major priority) from random routing: each
    token's k distinct experts by random logits, tilted towards the low
    expert ids by ``skew`` so that capacity binds. Returns (idx, slot,
    gates, kept choices)."""
    from repro_torch.models.moe import dispatch_tables
    logits = torch.randn(G, g, E, generator=gen, device="cuda") + \
        skew * torch.linspace(1, 0, E, device="cuda")
    vals, gate_idx = torch.sort(torch.softmax(logits, -1), dim=-1,
                                descending=True, stable=True)
    gates = vals[..., :k] / vals[..., :k].sum(-1, keepdim=True)
    idx, slot, keep = dispatch_tables(gate_idx[..., :k], E, C)
    return idx, slot, gates.contiguous(), int(keep.sum())


def moe_phase(torch, ops, ref, timer):
    """K5a (dispatch: slot rows gathered from token rows) and K5b (combine:
    each token's k expert rows, weighted by its gates, summed in fp32).
    K5a copies bits, so it must equal its plain version exactly; K5b sums
    in the plain version's order, within the tolerance of its input type.
    Both must give the same bits on a second run."""
    g_ = torch.Generator(device="cuda").manual_seed(6)
    E, k, d = GRANITE_MOE["E"], GRANITE_MOE["k"], GRANITE_MOE["d"]
    P, D, Vf = GRANITE_PREFILL, GRANITE_DECODE, GRANITE_VERIFY
    cases = [  # (name, G, g, E, C, k, d, routing skew)
        ("granite prefill", P["G"], P["g"], E, P["C"], k, d, 1.0),
        ("granite decode", D["G"], D["g"], E, D["C"], k, d, 0.0),
        ("granite verify", Vf["G"], Vf["g"], E, Vf["C"], k, d, 0.0),
        ("d % 4 != 0", 2, 37, 5, 8, 3, 1001, 0.0),
        ("k 1, d 130", 3, 24, 6, 8, 1, 130, 0.0),
        ("C binds hard", 1, 64, 4, 8, 4, 256, 2.0),
        ("every slot empty", 1, 16, 4, 8, 2, 64, None),
    ]
    errs = {"moe_dispatch": [0.0], "moe_combine": []}
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        for name, G, g, E_, C, k_, d_, skew in cases:
            if skew is None:
                idx = torch.full((G, E_, C), -1, dtype=torch.int32,
                                 device="cuda")
                slot = torch.full((G, g, k_), -1, dtype=torch.int32,
                                  device="cuda")
                gates = torch.rand(G, g, k_, generator=g_, device="cuda")
                kept = 0
            else:
                idx, slot, gates, kept = moe_tables(torch, g_, G, g, E_, C,
                                                    k_, skew)
            case = f"{dtype} {name}: G{G} g{g} E{E_} C{C} k{k_} d{d_} " \
                f"kept {kept}/{G * g * k_}"
            x = torch.randn(G, g, d_, generator=g_, device="cuda").to(dt)
            out = ops.moe_dispatch(idx, x)
            same = torch.equal(out, ref.moe_dispatch_ref(idx, x))
            print(f"  {'moe_dispatch':24s} {case:44s} "
                  f"{'bit for bit ok' if same else 'FAIL'}")
            check(same, f"moe_dispatch {case}: differs from the plain "
                  "version")
            check(torch.equal(out, ops.moe_dispatch(idx, x)),
                  f"moe_dispatch {case}: two runs differ")
            eo = torch.randn(G, E_, C, d_, generator=g_, device="cuda").to(dt)
            out = ops.moe_combine(slot, gates, eo)
            errs["moe_combine"].append(compare(
                torch, "moe_combine", case, out,
                ref.moe_combine_ref(slot, gates, eo), dtype))
            check(torch.equal(out, ops.moe_combine(slot, gates, eo)),
                  f"moe_combine {case}: two runs differ")

    def timed(G, g, C):
        """Kernel, plain and library times of both kernels at one of
        granite's shapes (fp32, as served), beside their byte bounds. The
        library call is the reference's own formulation, one einsum over
        the dense 0/1 dispatch or gate-weighted combine table
        (G, g, E, C), the same information as the kernels' index tables;
        the table is built outside the timed call."""
        idx, slot, gates, kept = moe_tables(torch, g_, G, g, E, C, k,
                                            1.0 if G > 1 else 0.0)
        x = torch.randn(G, g, d, generator=g_, device="cuda")
        eo = torch.randn(G, E, C, d, generator=g_, device="cuda")
        comb = torch.zeros(G, g, E * C + 1, device="cuda")
        comb.scatter_(2, torch.where(slot >= 0, slot, E * C).long(), gates)
        comb = comb[..., :E * C].reshape(G, g, E, C).contiguous()
        disp = (comb > 0).float()                # gates are positive
        shape = f"fp32 G{G} g{g} E{E} C{C} k{k} d{d}, {kept} of " \
            f"{G * g * k} choices kept"
        tk = times(timer, lambda: ops.moe_dispatch(idx, x),
                   "moe_dispatch_kernel",
                   lambda: ref.moe_dispatch_ref(idx, x),
                   lambda: torch.einsum("gsec,gsd->gecd", disp, x))
        # bytes: the token rows some slot takes, the table, every slot row
        grp = torch.arange(G, device="cuda")[:, None, None]
        tokens = torch.unique((idx + g * grp)[idx >= 0]).numel()
        tk["bound_ms"], tk["bound_by"] = bound_ms(
            4 * (tokens * d + idx.numel() + idx.numel() * d), 0, "float32")
        tc = times(timer, lambda: ops.moe_combine(slot, gates, eo),
                   "moe_combine_kernel",
                   lambda: ref.moe_combine_ref(slot, gates, eo),
                   lambda: torch.einsum("gsec,gecd->gsd", comb, eo))
        tc["bound_ms"], tc["bound_by"] = bound_ms(
            4 * (kept * d + 2 * slot.numel() + G * g * d), 2 * kept * d,
            "float32")
        # serving finds eo in the L2, right after the down projection
        tc["warm_ms"] = timer.device_ms(
            lambda: ops.moe_combine(slot, gates, eo), "moe_combine_kernel",
            flush=False)
        for t in (tk, tc):
            t["shape"] = shape
        return tk, tc

    # the decode shape carries nearly every launch of the plain serve
    # phase, the verify shape every decode launch of the speculative one;
    # the prefill bucket moves the most bytes per launch
    out = {}
    dec = timed(D["G"], D["g"], D["C"])
    pre = timed(P["G"], P["g"], P["C"])
    ver = timed(Vf["G"], Vf["g"], Vf["C"])
    for name, td, tp, tv in zip(("moe_dispatch", "moe_combine"), dec, pre,
                                ver):
        td["max_abs_err"] = max(errs[name])
        for key, tt in (("prefill", tp), ("verify", tv)):
            td[key] = {k_: tt[k_] for k_ in SUB_KEYS + ("warm_ms",)
                       if k_ in tt}
        out[name] = td
    # the floor under a launch-bound kernel: the device time of an empty
    # kernel, timed as the kernels are, in a window the timer's pads (the
    # same spinning kernel) stay out of
    out["moe_combine"]["floor_ms"] = timer.device_ms(
        lambda: torch.cuda._sleep(0), pad=False)
    return out


# ---------------------------------------------------------------------------
# serve phases and dense checks
# ---------------------------------------------------------------------------

def serve_argv(arch, cache_len, eos_id, extra=()):
    """A full-width serve run of the serve phases' shapes (8 slots, 8
    requests of 256 + 32 tokens, CAMD, K 8, ``paged_cuda``)."""
    return ["--arch", arch, "--no-reduced", "--impl", "paged_cuda",
            "--mode", "camd", "--slots", str(SERVE["slots"]),
            "--page-size", str(SERVE["page"]),
            "--requests", str(SERVE["requests"]),
            "--prompt-len", str(SERVE["prompt"]),
            "--max-new", str(SERVE["max_new"]),
            "--cache-len", str(cache_len), "--eos-id", str(eos_id),
            "--device", "cuda", "--seed", "0", *extra]


def dense_argv(arch, cache_len, eos_id, extra=()):
    """A 4-layer greedy run of the dense checks' shapes (4 requests of 64
    + 16 tokens), fp32."""
    return ["--arch", arch, "--no-reduced", "--num-layers", "4", "--mode",
            "greedy", "--requests", "4", "--prompt-len", "64", "--max-new",
            "16", "--cache-len", str(cache_len), "--eos-id", str(eos_id),
            "--device", "cuda", "--seed", "1", *extra]


def with_arg(argv, flag, value):
    """``argv`` with ``flag``'s value replaced."""
    argv = list(argv)
    argv[argv.index(flag) + 1] = str(value)
    return argv


IMAGE_EXTRA = ("--xmodal-rescore", "--image-pool", "2")
QWEN_ARGV = serve_argv("qwen3-0.6b", CACHE_LEN, 151936)
LLAVA_ARGV = serve_argv("llava-1.5-7b", MM_CACHE_LEN, 32000, IMAGE_EXTRA)
GRANITE_ARGV = serve_argv("granite-moe-3b-a800m", CACHE_LEN, 49155)


@contextlib.contextmanager
def counting_prefills(torch, timed=False):
    """Counts the served engine's prefill forwards while it is open:
    whole-prompt ones (``Model.prefill``: the flash kernel once a layer on
    the kernel impls) and suffix ones (``Model.prefill_suffix``: a prefix
    hit or a later chunk, plain sdpa against the cached context). With
    ``timed``, also each forward's CUDA-event span and the spans of the
    prefill attention calls inside it (the flash kernel's wrapper, the
    plain sdpa), under "spans": {name: [(forward, [attention])]}, read
    once the device has synchronized."""
    from repro_torch.kernels import ops
    from repro_torch.models import attention as attn_lib
    from repro_torch.models.model import Model
    counts = {"prefill": 0, "prefill_suffix": 0}
    spans = {name: [] for name in counts}
    saved = {name: getattr(Model, name) for name in counts}
    saved_attn = (attn_lib.sdpa, ops.flash_attention)
    inner = None                  # the open forward's attention spans

    def event_span(fn, *args, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args, **kw)
        end.record()
        return out, (start, end)

    def counted(name, fn):
        def call(self, *args, **kw):
            nonlocal inner
            counts[name] += 1
            if not timed:
                return fn(self, *args, **kw)
            inner = []
            out, span = event_span(fn, self, *args, **kw)
            spans[name].append((span, inner))
            inner = None
            return out
        return call

    def attention(fn):
        def call(*args, **kw):
            if inner is None:
                return fn(*args, **kw)
            out, span = event_span(fn, *args, **kw)
            inner.append(span)
            return out
        return call

    for name, fn in saved.items():
        setattr(Model, name, counted(name, fn))
    if timed:
        attn_lib.sdpa, ops.flash_attention = map(attention, saved_attn)
    try:
        yield counts, spans
    finally:
        for name, fn in saved.items():
            setattr(Model, name, fn)
        attn_lib.sdpa, ops.flash_attention = saved_attn


def serve_phase(torch, ops, serve, argv, kernels, timed=False,
                param_dtype=None, model=None):
    """One serve run through the entry point, with the launch counts set
    to 0 just before and read just after; every kernel in ``kernels`` must
    have carried it, every macro launch a replay of the engine's one
    captured graph; the flash kernel runs once a layer a whole-prompt
    prefill forward, the paged decode kernel once a layer a step of every
    replay. ``param_dtype`` (fp32 when None, as the CLI) and ``model``
    (an already built model to serve; None builds one) go to
    ``serve.main`` and on to ``build_engine``. Returns (launches, output
    of serve.main, with the prefill forwards under "forwards" and, with
    ``timed``, their CUDA-event spans under "spans", as
    ``counting_prefills`` gives them)."""
    s = SERVE
    print("serve phase: python -m repro_torch.launch.serve " + " ".join(argv)
          + ("" if param_dtype is None else
             f"  [build_engine(..., param_dtype={param_dtype})]"))
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    with counting_prefills(torch, timed) as (forwards, spans):
        out = serve.main(argv, param_dtype or torch.float32, model=model)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    out["forwards"], out["spans"] = dict(forwards), spans
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    total_gb = torch.cuda.get_device_properties(0).total_memory / 1e9
    eng, results = out["engine"], out["results"]
    check(len(results) == serve.parse_args(argv).requests,
          "serve: missing results")
    for r in results:
        check(r.n_candidates > 0 and 0 < len(r.tokens) <= s["max_new"],
              f"serve: request {r.uid} has no usable candidate")
        check(all(0 <= int(t) < eng.V for t in r.tokens),
              f"serve: request {r.uid} emitted an out-of-vocab token")
        check(bool(torch.isfinite(torch.tensor(r.best_score))),
              f"serve: request {r.uid} has a non-finite score")
    eng.pool.check()
    cached = eng.pool.prefix.cached_pages if eng.pool.prefix else 0
    check(eng.pool.in_use == cached, f"serve: {eng.pool.in_use} pages in "
          f"use after the run, {cached} of them cached: pages leaked")
    check(eng._graphs_captured == 1 and eng.macro_launches > 0,
          f"serve: {eng._graphs_captured} graphs captured, "
          f"{eng.macro_launches} macro launches")
    for name in kernels:
        check(launches[name] > 0, f"serve: {name} was never launched")
    L = eng.cfg.num_layers
    # a speculating engine verifies in plain sdpa on the gathered pages,
    # as the reference does: no paged decode kernel in its decode path
    want = {"flash_attention": L * forwards["prefill"],
            "paged_decode_attention": 0 if eng.spec else
            L * eng.macro_launches * eng.macro_steps}
    for name, n in want.items():
        check(launches[name] == n, f"serve: {name} launched "
              f"{launches[name]} times, not {n} ({L} layers, "
              f"{forwards['prefill']} whole-prompt prefills, "
              f"{eng.macro_launches} replays of {eng.macro_steps} steps"
              f"{', speculative' if eng.spec else ''})")
    print(f"serve phase: {out['tokens_per_s']:.1f} tok/s "
          f"({eng.total_tokens} tokens in {out['seconds']:.2f}s, "
          f"{eng.total_steps} decode steps, {eng.macro_launches} launches, "
          f"{eng.prefill_calls} prefills over {eng.prefill_tokens} tokens "
          f"({forwards['prefill']} whole-prompt and "
          f"{forwards['prefill_suffix']} suffix forwards), "
          f"{eng.chunk_calls} chunks over {eng.chunk_tokens} tokens, "
          f"{eng.host_syncs} host syncs, peak device memory {peak_gb:.1f} "
          f"GB of the card's {total_gb:.1f}); launches {launches}")
    kv = eng.kv_stats()
    print(f"serve phase: kv pool [{kv['kv_dtype']}] {kv['bytes_per_page']} "
          f"bytes a page, peak {kv['peak_kv_bytes'] / 1e6:.2f} MB")
    out["peak_gb"] = peak_gb
    return launches, out


# mesh serving: 2 and 4 logical data shards of the one card. Runs (a)'s
# pool lets shard 0 hold every request's 16 prompt pages beside its
# slots' pages (8 slots x 18 pages + a quarantine page, a shard), so that
# shard-local capacity never binds; run (b)'s 80 pages (19 allocatable a
# shard) fund one candidate at a time beside a prompt's 16.
MESH_PAGES = 2 * (SERVE["slots"] * (CACHE_LEN // SERVE["page"]) + 1)
MESH_TIGHT_PAGES = 80


@contextlib.contextmanager
def watching_shards():
    """While open, records what every served engine does with its shards:
    the prompt pages each admitted request holds ("prompt"), the pages
    each slot takes as its own (CoW tail, staged frontier: "owned", (slot,
    pages)), and every admission gate's (wanted, funded) ("gates")."""
    from repro_torch.serving.engine import ServeEngine
    rec = {"prompt": [], "owned": [], "gates": []}
    saved = {name: getattr(ServeEngine, name) for name in
             ("_seed_paged_slots", "_stage_frontier", "_paged_affordable")}

    def seed(self, info, slot_ids, lim):
        saved["_seed_paged_slots"](self, info, slot_ids, lim)
        n = len(info["prompt_pages"])
        rec["prompt"].extend(info["prompt_pages"])
        rec["owned"].extend((s, self._slot_pages[s][n:]) for s in slot_ids)

    def stage(self):
        staged = saved["_stage_frontier"](self)
        rec["owned"].extend((s, pages) for s, (_, pages) in staged.items())
        return staged

    def gate(self, info, want, lim=None):
        got = saved["_paged_affordable"](self, info, want, lim)
        rec["gates"].append((want, got))
        return got

    ServeEngine._seed_paged_slots, ServeEngine._stage_frontier = seed, stage
    ServeEngine._paged_affordable = gate
    try:
        yield rec
    finally:
        for name, fn in saved.items():
            setattr(ServeEngine, name, fn)


def stream_digest(results):
    """Each request's chosen tokens, rounds and candidates' tokens."""
    return [(r.uid, r.rounds, [int(t) for t in r.tokens],
             sorted([int(t) for t in c["tokens"]] for c in r.candidates))
            for r in sorted(results, key=lambda r: r.uid)]


def shard_checks(eng, rec, what):
    """A drained sharded engine: every slot-owned page in the slot's own
    shard, idle rows on their own shard's quarantine page, the pool
    conserved and no reservation left."""
    for s, pages in rec["owned"]:
        for p in pages:
            check(eng.pool.shard_of(p) == eng._slot_shard(s),
                  f"{what}: slot {s} (shard {eng._slot_shard(s)}) took page "
                  f"{p} of shard {eng.pool.shard_of(p)}")
    bt = eng.state.cache["block_table"].cpu()
    for s in range(eng.B):
        q = eng.pool.quarantine_page(eng._slot_shard(s))
        check(bool((bt[s] == q).all()), f"{what}: idle row {s} does not "
              f"point at its shard's quarantine page {q}")
    eng.pool.check()
    check(eng._reserved == 0 and not eng._reserved_sh.any(),
          f"{what}: reservations left {eng._reserved_sh.tolist()}")


def mesh_runs(torch, ops, serve, model, serve_run):
    """The mesh phase's four serve runs of full-width qwen3-0.6b through
    ``serve_run(argv, model)`` (``serve_phase`` on the card) on ``model``:
    dp 1 with the prefix cache; (a) ``--serve-dp 2 --prefill-shards 1
    --prefix-cache`` on the same pool (``MESH_PAGES``); (b) ``--serve-dp
    4`` on ``MESH_TIGHT_PAGES`` pages; (c) ``--serve-dp 4`` on the full
    pool. Checks (a) against dp 1 (streams, K1 and K2 counts), the shard
    locality of (a), (b) and (c), (a)'s prompt pages on shard 0 and both
    its shards admitting, and (b) gated by shard-local capacity yet
    serving every request. Returns ({run: launches}, {dp: output})."""
    base = QWEN_ARGV + ["--num-pages", str(MESH_PAGES), "--prefix-cache"]
    runs, outs, recs = {}, {}, {}
    for dp, argv in (
            (1, base),
            (2, base + ["--serve-dp", "2", "--prefill-shards", "1"]),
            ("4 tight", QWEN_ARGV + ["--num-pages", str(MESH_TIGHT_PAGES),
                                     "--serve-dp", "4"]),
            (4, QWEN_ARGV + ["--serve-dp", "4"])):
        run = f"qwen3-0.6b serve dp {dp}"
        with watching_shards() as rec:
            runs[run], out = serve_run(argv, model)
        eng = out["engine"]
        outs[dp], recs[dp] = out, rec
        gates = rec["gates"]
        print(f"mesh [dp {dp}]: {out['tokens_per_s']:.1f} tok/s, "
              f"{eng.macro_launches} launches, pool {eng.pool.num_pages} "
              f"pages in {eng.pool.num_shards} shards, admitted per shard "
              f"{eng.sched_stats().get('admitted_per_shard')}, admission "
              f"gates funded short {sum(g < w for w, g in gates)} of "
              f"{len(gates)}")
        if dp != 1:
            shard_checks(eng, rec, f"mesh dp {dp}")
    check(stream_digest(outs[2]["results"]) ==
          stream_digest(outs[1]["results"]),
          "mesh (a): dp-2 streams differ from dp 1's")
    a, b = runs["qwen3-0.6b serve dp 1"], runs["qwen3-0.6b serve dp 2"]
    for name in ("flash_attention", "paged_decode_attention"):
        check(a[name] == b[name], f"mesh (a): {name} launched {b[name]} "
              f"times at dp 2, {a[name]} at dp 1")
    eng = outs[2]["engine"]
    check(bool(recs[2]["prompt"]) and
          {eng.pool.shard_of(p) for p in recs[2]["prompt"]} == {0},
          "mesh (a): a prompt page off shard 0")
    per_shard = eng.sched_stats()["admitted_per_shard"]
    check(set(per_shard) == {"0", "1"}, f"mesh (a): admitted {per_shard}")
    tight = outs["4 tight"]["engine"]
    gated = sum(g < w for w, g in recs["4 tight"]["gates"])
    check(gated > 0, "mesh (b): no admission was gated by the tight pool")
    check(len(outs["4 tight"]["results"]) == SERVE["requests"] and
          tight.pool.in_use == 0, "mesh (b): unserved or leaked")
    print(f"mesh (b): {gated} of {len(recs['4 tight']['gates'])} admission "
          f"gates funded short, {tight.macro_launches} launches against "
          f"{outs[4]['engine'].macro_launches} on the full pool; scheduler "
          f"{tight.sched_stats()}")
    return runs, outs


def mesh_phase(torch, ops, serve, model, card):
    """Mesh serving of full-width qwen3-0.6b on logical data shards of the
    card, on the weights the qwen3 serve phase built (no new model load),
    through the serve CLI's entry point: ``mesh_runs`` with each run in
    ``serve_phase`` (launch counts from 0, one graph, K2 once a layer a
    whole-prompt prefill, K1 once a layer a replayed step, results, pool
    and cache conserved). Prints tokens/s at dp 1, 2 and 4 beside the
    card's name and power limit. Returns {run: launches}."""
    t0 = time.perf_counter()
    runs, outs = mesh_runs(
        torch, ops, serve, model,
        lambda argv, m: serve_phase(torch, ops, serve, argv,
                                    ("flash_attention",
                                     "paged_decode_attention"), model=m))
    print("mesh tokens/s: " + ", ".join(
        f"dp {dp} {out['tokens_per_s']:.1f}" for dp, out in outs.items())
        + f" ({card})")
    print(f"mesh phase: {time.perf_counter() - t0:.1f} s")
    return runs


# serving over ranks (ranks_phase): full-width qwen3-0.6b, 8 slots, 2
# requests of 256 + 32 tokens (4 took the phase to 61 s, over its 45),
# CAMD, on the mesh phase's pool, where no shard's capacity binds (every
# mesh admits as one device does)
RANKS_ARGV = with_arg(QWEN_ARGV, "--requests", 2) + [
    "--num-pages", str(MESH_PAGES)]
# the runs of two gloo ranks on the one card: (mesh, impl, layers, 0 for
# all of them), and the run of one process whose streams each must give.
# (b) and (d), whose ~59 host-staged collectives a step cost ~4 ms each,
# serve 4 of the 28 layers, against one-process runs of those 4 layers
# ((a4), (d0)): the vlm ranks phase needs their time
RANK_LAYERS = 4
RANK_RUNS = {"(b)": ("1,2", "paged_cuda", RANK_LAYERS, "(a4)"),
             "(c)": ("2,1", "paged_cuda", 0, "(a)"),
             "(d)": ("1,2", "cuda", RANK_LAYERS, "(d0)")}
RANKS_TIMEOUT = 420          # the gloo runs of the three models, after the go
# the torchrun launch of every gloo run: a run of n ranks takes its first
# n workers (the others wait), each run a gloo group of its own; one
# launch, as its start and end cost ~12 s
GLOO_PROCS = 4
GLOO_WAIT = 900              # how long a worker waits for its go
SPLIT_MARGIN = 1e-4


def free_port() -> int:
    """A free TCP port on the loopback interface."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


@contextlib.contextmanager
def one_nccl_rank():
    """The environment torchrun gives a world of one rank, for the serve
    entry point to join over NCCL while open; the group is destroyed and
    the environment restored on exit."""
    import torch.distributed as dist
    env = dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()),
               RANK="0", LOCAL_RANK="0", WORLD_SIZE="1")
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def rank_record(torch, out):
    """What a rank's serve run shows: its streams, launches, tokens/s,
    peak device memory, the bytes of its weights and pools, its head and
    row counts, the collectives of its macro bodies and its pool's pages
    (own range and mirrors); with a recurrent or hybrid model its arena's
    stats (the rank's rows and mirror rows), SSD heads, RG-LRU width and
    local layers; with a
    vision tower its image encodes, memo hits, candidates rescored (and
    parted from rank 0's S_align), the tower's heads and the peak the
    allocator reserved."""
    eng = out["engine"]
    model = eng.model
    cache = eng.state.cache
    attn = next((b.attn for b in model.layers if hasattr(b, "attn")), None)
    rec = dict(
        rank=eng.world.rank, coords=list(eng.world.coords),
        streams=stream_digest(out["results"]), launches=out["launches"],
        tokens_per_s=out["tokens_per_s"], seconds=out["seconds"],
        peak_gb=torch.cuda.max_memory_allocated() / 1e9,
        weight_bytes=sum(p.numel() * p.element_size()
                         for p in model.parameters()),
        kv_bytes=sum(t.numel() * t.element_size() for k, t in cache.items()
                     if k not in ("pos", "block_table")),
        eager=eng._eager_body, graphs=eng._graphs_captured,
        macro_launches=eng.macro_launches, macro_steps=eng.macro_steps,
        prefill_calls=eng.prefill_calls, layers=eng.cfg.num_layers,
        B_local=eng.B_local, kv_heads=model.kv_heads,
        q_heads=0 if attn is None else attn.wq.kernel.shape[1] //
        eng.cfg.resolved_head_dim, collectives=out.get("collectives"))
    if eng.arena is not None:
        blk = {b.kind: b for b in model.layers}
        rec.update(arena=eng.arena_stats(),
                   ssd_heads=int(blk["ssm"].ssm.A_log.shape[0])
                   if "ssm" in blk else 0,
                   rglru_width=int(blk["rglru"].rglru.lam.shape[0])
                   if "rglru" in blk else 0,
                   n_local=sum(k == "local" for k in eng.cfg.layer_kinds))
    if eng.paged:
        rec.update(pool_pages=int(cache["k_pages"].shape[1]),
                   own_pages=eng._own_pages, num_pages=eng.pool.num_pages,
                   mirror_pages=eng._n_mirror, mirror_peak=eng.mirror_peak)
    moe = model.layers[0].moe
    if moe is not None:
        from repro_torch.models.moe import expert_range
        rec.update(experts=list(expert_range(moe, eng.cfg, eng.world)),
                   expert_f=int(moe.w_gate.shape[2]),
                   peak_reserved_gb=torch.cuda.max_memory_reserved() / 1e9)
    if model.vision is not None:
        v = eng.cfg.vision
        rec.update(
            image_encodes=eng.image_encodes,
            image_feat_hits=eng.image_feat_hits,
            encode_ms=eng.image_encode_s * 1e3 / max(eng.image_encodes, 1),
            rescored=eng.xmodal_rescored, parted=eng.xmodal_parted,
            candidates=sum(r.n_candidates for r in out["results"]),
            vision_heads=model.vision.blocks[0].wq.kernel.shape[1] //
            (v.d_model // v.num_heads),
            peak_reserved_gb=torch.cuda.max_memory_reserved() / 1e9)
    return rec


def ranks_worker(arg: str, out_dir: str) -> None:
    """One worker of ``start_gloo_ranks``' launch (torchrun's rank RANK):
    waits for the go file in ``out_dir``, then for each (run, argv,
    ranks, first) of the spec in which it is one of the ``ranks`` workers
    from ``first`` joins the run's gloo group (a file store in
    ``out_dir``, its rank there RANK - first), serves argv
    through the serve entry point (``shard_map_rank`` when argv is null),
    writes the run's record to ``out_dir`` (a file a rank and run: the
    workers' standard outputs interleave) and leaves the group. It gives
    up waiting once the script that started it is gone."""
    parent, spec = json.loads(arg)
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    rank = int(os.environ["RANK"])
    go, deadline = Path(out_dir, "go"), time.monotonic() + GLOO_WAIT
    while not go.exists():
        os.kill(parent, 0)                  # raises once the script is gone
        if time.monotonic() > deadline:
            raise SystemExit(f"gloo worker {rank}: no go in {GLOO_WAIT} s")
        time.sleep(0.05)
    for i, (run, argv, ranks, first) in enumerate(spec):
        if not first <= rank < first + ranks:
            continue
        dist.init_process_group(
            "gloo", store=dist.FileStore(str(Path(out_dir, f"store-{i}")),
                                         ranks), rank=rank - first,
            world_size=ranks)
        try:
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launches()
            if argv is None:            # the expert-parallel check
                rec = shard_map_rank(torch, ops)
            else:
                with counting_collectives() as counts:
                    out = serve.main(argv)
                out["collectives"] = dict(counts)
                torch.cuda.synchronize()
                rec = rank_record(torch, out)
                del out
            Path(out_dir, f"{run}-{rec['rank']}.json").write_text(
                json.dumps(dict(run=run, **rec)))
        finally:
            dist.destroy_process_group()
        free_memory(torch)


@contextlib.contextmanager
def counting_collectives():
    """Counts the ``torch.distributed`` collectives a rank calls while
    open ("all") and those inside its engine's macro bodies ("body"),
    with the decode steps those bodies ran, masked ones included
    ("steps": K a launch): "body" / "steps" is a decode step's
    collectives, the exit flags' OR among them."""
    import torch.distributed as dist
    from repro_torch.serving.engine import ServeEngine
    counts = {"all": 0, "body": 0, "steps": 0}
    names = ("all_reduce", "all_gather", "broadcast",
             "reduce_scatter_tensor", "all_to_all_single")
    saved = {n: getattr(dist, n) for n in names}
    saved_body = ServeEngine._macro_step
    depth = [0]

    def counted(fn):
        def call(*args, **kw):
            counts["all"] += 1
            counts["body"] += depth[0] > 0
            return fn(*args, **kw)
        return call

    def body(self):
        depth[0] += 1
        counts["steps"] += max(self.macro_steps, 1)
        try:
            return saved_body(self)
        finally:
            depth[0] -= 1
    for n in names:
        setattr(dist, n, counted(saved[n]))
    ServeEngine._macro_step = body
    try:
        yield counts
    finally:
        for n in names:
            setattr(dist, n, saved[n])
        ServeEngine._macro_step = saved_body


def stream_split(a, b):
    """Where two stream digests part: (request, the candidate's common
    prefix, its next token in a, in b), or None when they are equal."""
    for ra, rb in zip(a, b):
        if ra == rb:
            continue
        for ca, cb in zip(ra[3], rb[3]):
            if ca != cb:
                j = next((i for i, (x, y) in enumerate(zip(ca, cb))
                          if x != y), min(len(ca), len(cb)))
                return (ra[0], ca[:j], ca[j] if j < len(ca) else None,
                        cb[j] if j < len(cb) else None)
        return ra[0], [], None, None
    return None if len(a) == len(b) else (None, [], None, None)


def streams_agree(torch, serve, model, argv, got, want, what):
    """``got``'s streams equal ``want``'s, or part where the one-process
    model's top two logits (after the request's image, prompt and the
    candidate's common prefix) lie within ``SPLIT_MARGIN``: the step and
    both logits are printed. Fails otherwise."""
    split = stream_split(json.loads(json.dumps(got)),
                         json.loads(json.dumps(want)))
    if split is None:
        return
    uid, prefix, tok_got, tok_want = split
    check(uid is not None and tok_got is not None and tok_want is not None,
          f"{what}: streams differ in their candidates, not at a token")
    req = serve.make_requests(model.cfg, serve.parse_args(argv))[uid]
    toks = torch.as_tensor(list(req.prompt) + list(prefix),
                           device="cuda")[None]
    with torch.inference_mode():
        # an image request's evidence rows prefill ahead of its tokens
        ev = None if req.image is None else model.encode_image(
            torch.as_tensor(req.image, device="cuda")[None])
        ne = 0 if ev is None else ev.shape[1]
        lg, _, _ = model.prefill(toks, model.make_cache(1, ne + toks.shape[1]),
                                 ev)
    top = torch.topk(lg[0].float(), 2).values
    margin = float(top[0] - top[1])
    print(f"{what}: streams part at request {uid}, step {len(prefix)}: "
          f"token {tok_got} (logit {float(lg[0, tok_got]):.6f}) against "
          f"{tok_want} (logit {float(lg[0, tok_want]):.6f}); top-two "
          f"margin {margin:.3e}")
    check(margin < SPLIT_MARGIN, f"{what}: streams part at a top-two "
          f"margin of {margin:.3e}, not below {SPLIT_MARGIN}")


def rank_launch_checks(rec, what):
    """Each rank's K2 once a layer a prefill bucket, its decode kernel (K1
    paged, K3 dense) once a layer a step of every launch, no other."""
    L, steps = rec["layers"], rec["macro_launches"] * rec["macro_steps"]
    paged = "pool_pages" in rec
    want = {"flash_attention": L * rec["prefill_calls"],
            "paged_decode_attention": L * steps if paged else 0,
            "decode_attention": 0 if paged else L * steps}
    for name, n in want.items():
        check(rec["launches"][name] == n,
              f"{what} rank {rec['rank']}: {name} launched "
              f"{rec['launches'][name]} times, not {n}")


def ranks_phase(torch, ops, serve, model, card):
    """Serving full-width qwen3-0.6b over torch.distributed ranks, through
    the serve entry point, on the qwen3 serve phase's weights where one
    process serves (``RANKS_ARGV``): (a) one NCCL rank (world 1; the
    macro body captured as one graph with its collectives) against the
    same run without a group: the same streams and K1/K2 counts; and the
    one-process runs (a4) and (d0) at ``RANK_LAYERS`` layers. Returns
    ({run: launches}, what ``ranks_check`` needs to hold the gloo runs
    (b) ``--mesh 1,2``, (c) ``--mesh 2,1`` and (d) ``--mesh 1,2 --impl
    cuda``: the one-process streams they must give)."""
    t0 = time.perf_counter()
    runs = {}
    runs["qwen3-0.6b ranks one process"], base = serve_phase(
        torch, ops, serve, RANKS_ARGV, TEXT_KERNELS, model=model)
    with one_nccl_rank():
        runs["qwen3-0.6b ranks (a)"], a = serve_phase(
            torch, ops, serve, RANKS_ARGV + ["--mesh", "1,1"], TEXT_KERNELS,
            model=model)
    eng = a["engine"]
    check(eng.world is not None and eng.world.backend == "nccl" and
          not eng._eager_body and eng._graphs_captured == 1,
          "ranks (a): not one NCCL rank replaying one captured graph")
    want = stream_digest(base["results"])
    check(stream_digest(a["results"]) == want,
          "ranks (a): streams differ from the run without a group")
    for name in TEXT_KERNELS:
        check(runs["qwen3-0.6b ranks (a)"][name] ==
              runs["qwen3-0.6b ranks one process"][name],
              f"ranks (a): {name} launched differently from the run without "
              "a group")
    one = {"(a)": dict(streams=want, tps=a["tokens_per_s"],
                       weight_bytes=sum(p.numel() * p.element_size()
                                        for p in model.parameters()),
                       kv_bytes=a["engine"].kv_stats()["bytes_per_page"] *
                       a["engine"].pool.num_pages)}
    del base, a, eng
    from repro_torch.models.model import build_model
    small = build_model(model.cfg.with_overrides(num_layers=RANK_LAYERS),
                        torch.float32, device="cuda", seed=0)
    shallow = RANKS_ARGV + ["--num-layers", str(RANK_LAYERS)]
    for run, impl in (("(a4)", "paged_cuda"), ("(d0)", "cuda")):
        ops.reset_launches()
        o = serve.main(with_arg(shallow, "--impl", impl), model=small)
        torch.cuda.synchronize()
        runs[f"qwen3-0.6b ranks {run}"] = dict(ops.LAUNCHES)
        one[run] = dict(streams=stream_digest(o["results"]),
                        tps=o["tokens_per_s"])
        del o
    del small
    free_memory(torch)
    a = one["(a)"]
    print(f"ranks: (a) one NCCL rank {a['tps']:.1f} tok/s, weights "
          f"{a['weight_bytes'] / 1e9:.3f} GB, KV {a['kv_bytes'] / 1e6:.1f} MB;"
          f" {RANK_LAYERS} layers in one process: (a4) paged_cuda "
          f"{one['(a4)']['tps']:.1f}, (d0) cuda {one['(d0)']['tps']:.1f} "
          f"tok/s ({card}); in process {time.perf_counter() - t0:.1f} s")
    return runs, dict(one=one, cfg=model.cfg)


def gloo_spec():
    """Every gloo run of the rank phases: (run, argv, ranks, first), the
    argv of ``serve.main`` (None: ``shard_map_rank``) on workers
    ``first .. first + ranks - 1`` of the launch, each worker taking its
    runs in this order. The two-rank runs go in two lanes beside each
    other, workers 0-1 (qwen3's, granite-moe's) and 2-3 (recurrentgemma's
    and mamba2's, ~20 GB at most beside granite's (c) ~28 GB); the
    four-rank runs follow, then llava's runs alone on workers 0-1 (its
    (c) holds ~71 GB)."""
    def argv(base, mesh, layers):
        return base + ["--mesh", mesh, "--dist-backend", "gloo"] + (
            ["--num-layers", str(layers)] if layers else [])

    def ranks(mesh):
        dp, mp = (int(x) for x in mesh.split(","))
        return dp * mp

    def lane(runs, first):
        return [(run, a, n, first if n == 2 else 0) for run, a, n in runs]
    qwen = [(f"qwen3 {run}", argv(with_arg(RANKS_ARGV, "--impl", impl),
                                  mesh, layers), ranks(mesh))
            for run, (mesh, impl, layers, _) in RANK_RUNS.items()]
    llava = [(f"llava {run}", argv(VLM_RANKS_ARGV, mesh, 0), ranks(mesh))
             for run, (mesh, _, _) in VLM_RANK_RUNS.items()]
    granite = [(f"granite {run}", argv(MOE_RANKS_ARGV, mesh, layers),
                ranks(mesh))
               for run, (mesh, layers, _) in MOE_RANK_RUNS.items()] + [
        ("granite shard_map", None, 4)]
    recurrent = [(f"recurrent {run}", argv(recurrent_ranks_argv(name, mode),
                                          mesh, layers), ranks(mesh))
                 for run, (name, mesh, mode, layers)
                 in RECURRENT_RANK_RUNS.items()]
    two = lane([r for r in qwen + granite if r[2] == 2], 0) + \
        lane([r for r in recurrent if r[2] == 2], 2)
    four = lane([r for r in granite + recurrent if r[2] == 4], 0)
    return two + four + lane(llava, 0)


def start_gloo_ranks(spec):
    """Starts one torchrun launch of ``GLOO_PROCS`` gloo worker processes
    on the card (the ``expandable_segments`` allocator) for the runs of
    ``spec`` (``ranks_worker``). The workers import and then wait for the
    go that ``gloo_ranks`` gives, so that the launch's start overlaps the
    in-process runs before it. Returns the launch."""
    out_dir = tempfile.mkdtemp(prefix="gloo-ranks-")
    cmd = [sys.executable, "-m", "torch.distributed.run",
           "--nproc-per-node", str(GLOO_PROCS), "--master-addr", "127.0.0.1",
           "--master-port", str(free_port()), str(ROOT / "chip_smoke.py"),
           "--ranks-worker", json.dumps([os.getpid(), spec]), out_dir]
    print("gloo ranks: " + " ".join(cmd[:-2]) + " '<runs>' <dir>")
    env = dict(os.environ, PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
    log = open(Path(out_dir, "torchrun.log"), "w")
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=log,
                            stderr=subprocess.STDOUT, text=True, env=env)
    log.close()
    return dict(proc=proc, out_dir=out_dir, spec=spec,
                t0=time.perf_counter())


def stop_gloo_ranks(launch) -> None:
    """Ends a launch (its processes, if a phase failed before their go or
    while they ran) and removes its directory."""
    proc = launch["proc"]
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    shutil.rmtree(launch["out_dir"], ignore_errors=True)


def gloo_ranks(launch):
    """Gives the launch's workers their go, waits for them (at most
    ``RANKS_TIMEOUT``), prints their output and returns their records
    (one a rank and run). One launch serves the qwen3, llava, granite,
    recurrentgemma and mamba2 runs: a launch's start and end cost ~12
    s."""
    t0 = time.perf_counter()
    out_dir, proc = launch["out_dir"], launch["proc"]
    Path(out_dir, "go").touch()
    try:
        proc.wait(timeout=RANKS_TIMEOUT)
    finally:
        output = Path(out_dir, "torchrun.log").read_text()
        records = [json.loads(f.read_text())
                   for f in sorted(Path(out_dir).glob("*.json"))]
        stop_gloo_ranks(launch)
    for line in output.splitlines():
        print(f"  | {line}")
    want = sum(n for _, _, n, _ in launch["spec"])
    check(proc.returncode == 0 and len(records) == want,
          f"gloo ranks: torchrun exited {proc.returncode} with "
          f"{len(records)} of {want} records")
    print(f"gloo ranks: torchrun of {GLOO_PROCS} gloo workers, "
          f"{len(launch['spec'])} runs, {time.perf_counter() - t0:.1f} s "
          f"after the go, {time.perf_counter() - launch['t0']:.1f} s since "
          "the launch")
    return records


def agree(torch, serve, cfg, argv, got, want, what, models):
    """``streams_agree`` on ``cfg``'s seeded model (fp32, on the card),
    built only when ``got``'s streams part from ``want``'s and kept in
    ``models`` by (name, layers)."""
    if stream_split(json.loads(json.dumps(got)),
                    json.loads(json.dumps(want))) is None:
        return
    from repro_torch.models.model import build_model
    key = (cfg.name, cfg.num_layers)
    if key not in models:
        models[key] = build_model(cfg, torch.float32, device="cuda", seed=0)
    streams_agree(torch, serve, models[key], argv, got, want, what)


def ranks_check(torch, serve, pending, records, card):
    """``ranks_phase``'s gloo runs, from their records: every rank's body
    eager, its heads, rows and pages, K2 once a layer a prefill bucket
    and K1 (paged) or K3 (dense) once a layer a step
    (``rank_launch_checks``), and (a)'s streams for (c), (a4)'s for (b),
    (d0)'s for (d) (``agree``). Prints tokens/s, per-rank peak memory and
    weight and KV bytes beside the card. Returns ({run: launches}, the
    paged runs, the dense runs)."""
    runs, models = {}, {}
    one = pending["one"]
    paged_runs, dense_runs = [], []
    for run, (mesh, impl, layers, ref_run) in RANK_RUNS.items():
        recs = [r for r in records if r["run"] == f"qwen3 {run}"]
        dp, mp = (int(x) for x in mesh.split(","))
        cfg = pending["cfg"].with_overrides(num_layers=layers) if layers \
            else pending["cfg"]
        for rec in recs:
            what = f"ranks {run} --mesh {mesh} {impl}"
            check(rec["eager"] and rec["graphs"] == 0,
                  f"{what}: a gloo rank's body must run eagerly")
            check(rec["q_heads"] == 16 // mp and rec["kv_heads"] == 8 // mp
                  and rec["B_local"] == SERVE["slots"] // dp,
                  f"{what} rank {rec['rank']}: {rec['q_heads']}/"
                  f"{rec['kv_heads']} heads, {rec['B_local']} rows")
            if "pool_pages" in rec:
                check(rec["own_pages"] * dp == rec["num_pages"] and
                      rec["pool_pages"] == rec["own_pages"] +
                      rec["mirror_pages"],
                      f"{what} rank {rec['rank']}: pool of "
                      f"{rec['pool_pages']} pages, own {rec['own_pages']}")
            rank_launch_checks(rec, what)
            agree(torch, serve, cfg, RANKS_ARGV, rec["streams"],
                  one[ref_run]["streams"], f"{what} rank {rec['rank']}",
                  models)
            name = f"qwen3-0.6b ranks {run} rank {rec['rank']}"
            runs[name] = rec["launches"]
            (paged_runs if "pool_pages" in rec else dense_runs).append(name)
            print(f"{what} rank {rec['rank']} at {tuple(rec['coords'])}: "
                  f"{rec['tokens_per_s']:.1f} tok/s ({card}), peak device "
                  f"memory {rec['peak_gb']:.2f} GB (build included), weights "
                  f"{rec['weight_bytes'] / 1e9:.3f} GB, KV "
                  f"{rec['kv_bytes'] / 1e6:.1f} MB" + (
                      f" ({rec['pool_pages']} pages: {rec['own_pages']} "
                      f"own of {rec['num_pages']}, {rec['mirror_pages']} "
                      f"mirror, {rec['mirror_peak']} used at peak)"
                      if "pool_pages" in rec else "") + f", {rec['q_heads']}"
                  f"/{rec['kv_heads']} heads, {rec['B_local']} rows; "
                  f"launches {rec['launches']}")
    del models
    free_memory(torch)
    return runs, tuple(paged_runs) + ("qwen3-0.6b ranks (a4)",), \
        tuple(dense_runs)


# vlm serving over ranks (vlm_ranks_phase): full-width llava-1.5-7b,
# fp32, CAMD with cross-modal rescoring, 2 requests over the image pool
# and 16 new tokens (the decode, ~0.4 s a step on two gloo ranks, is the
# phase's cost), on a pool sized for them: a shard can hold both prompts'
# 52 pages and its 4 slots' tail pages beside its quarantine page, so
# that no shard's capacity binds (every mesh admits as one device does)
VLM_REQUESTS = 2
VLM_MAX_NEW = 16
MM_PROMPT_PAGES = (IMAGE_TOKENS + SERVE["prompt"]) // SERVE["page"]
VLM_PAGES = 2 * (VLM_REQUESTS * MM_PROMPT_PAGES + SERVE["slots"] // 2 *
                 -(-VLM_MAX_NEW // SERVE["page"]) + 1)
VLM_RANKS_ARGV = with_arg(with_arg(LLAVA_ARGV, "--requests", VLM_REQUESTS),
                          "--max-new", VLM_MAX_NEW) + [
    "--num-pages", str(VLM_PAGES)]
# the runs of two gloo ranks on the one card: mesh, each rank's LM query
# and kv heads and the tower's heads
VLM_RANK_RUNS = {"(b)": ("1,2", (16, 16), 8), "(c)": ("2,1", (32, 32), 16)}


def vlm_checks(rec, one, what):
    """A vlm rank's run: the one-process run's image encodes and memo
    hits, every candidate it finished rescored by K4 (one K4a and one K4b
    launch each) with rank 0's S_align its own, and its peak memory under
    the card's."""
    check((rec["image_encodes"], rec["image_feat_hits"]) ==
          (one["image_encodes"], one["image_feat_hits"]),
          f"{what}: {rec['image_encodes']} encodes and "
          f"{rec['image_feat_hits']} memo hits, not the one process's "
          f"{one['image_encodes']} and {one['image_feat_hits']}")
    check(rec["rescored"] == rec["candidates"] and rec["parted"] == 0,
          f"{what}: {rec['rescored']} of {rec['candidates']} candidates "
          f"rescored, {rec['parted']} parted from rank 0's S_align")
    for name in ("xmodal_score_mean", "xmodal_score_max"):
        check(rec["launches"][name] == rec["rescored"],
              f"{what}: {name} launched {rec['launches'][name]} times for "
              f"{rec['rescored']} rescored candidates")
    check(rec["peak_reserved_gb"] < one["card_gb"],
          f"{what}: {rec['peak_reserved_gb']:.1f} GB reserved at peak")


def vlm_ranks_phase(torch, ops, serve, card):
    """Serving full-width llava-1.5-7b image requests in fp32 with CAMD
    and cross-modal rescoring over torch.distributed ranks, through the
    serve entry point (``VLM_RANKS_ARGV``): (a) one NCCL rank (world 1;
    one captured graph with its collectives) against the same run
    without a group, on one seeded model: the same streams, image encodes
    and memo hits and K1/K2/K4a/K4b counts. The model is released before
    the gloo ranks share the card. Returns ({run: launches}, what
    ``vlm_ranks_check`` needs to hold the gloo runs (b) ``--mesh 1,2``
    and (c) ``--mesh 2,1``: (a)'s record)."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    t0 = time.perf_counter()
    total_gb = torch.cuda.get_device_properties(0).total_memory / 1e9
    model = build_model(get_config("llava-1.5-7b").with_overrides(
        dtype="float32"), torch.float32, device="cuda", seed=0)
    runs = {}
    runs["llava-1.5-7b ranks one process"], base = serve_phase(
        torch, ops, serve, VLM_RANKS_ARGV, LLAVA_KERNELS, model=model)
    image_checks(torch, serve, VLM_RANKS_ARGV, base)
    with one_nccl_rank():
        runs["llava-1.5-7b ranks (a)"], a = serve_phase(
            torch, ops, serve, VLM_RANKS_ARGV + ["--mesh", "1,1"],
            LLAVA_KERNELS, model=model)
    eng = a["engine"]
    check(eng.world is not None and eng.world.backend == "nccl" and
          not eng._eager_body and eng._graphs_captured == 1,
          "vlm ranks (a): not one NCCL rank replaying one captured graph")
    want = stream_digest(base["results"])
    check(stream_digest(a["results"]) == want,
          "vlm ranks (a): streams differ from the run without a group")
    check((eng.image_encodes, eng.image_feat_hits) ==
          (base["engine"].image_encodes, base["engine"].image_feat_hits),
          "vlm ranks (a): image encodes and memo hits differ from the run "
          "without a group")
    for name in LLAVA_KERNELS:
        check(runs["llava-1.5-7b ranks (a)"][name] ==
              runs["llava-1.5-7b ranks one process"][name],
              f"vlm ranks (a): {name} launched differently from the run "
              "without a group")
    one = dict(streams=want, tps=a["tokens_per_s"], peak_gb=a["peak_gb"],
               weight_bytes=sum(p.numel() * p.element_size()
                                for p in model.parameters()),
               kv_bytes=eng.kv_stats()["bytes_per_page"] *
               eng.pool.num_pages, image_encodes=eng.image_encodes,
               image_feat_hits=eng.image_feat_hits,
               encode_ms=eng.image_encode_s * 1e3 / max(eng.image_encodes, 1),
               rescored=eng.xmodal_rescored, card_gb=total_gb,
               cfg=model.cfg)
    print(f"vlm ranks: (a) one NCCL rank {one['tps']:.1f} tok/s, without a "
          f"group {base['tokens_per_s']:.1f} ({card}); weights "
          f"{one['weight_bytes'] / 1e9:.3f} GB, KV {one['kv_bytes'] / 1e6:.1f}"
          f" MB, peak {one['peak_gb']:.2f} GB; {one['image_encodes']} "
          f"encodes ({one['encode_ms']:.1f} ms each, wall), "
          f"{one['image_feat_hits']} memo hits, "
          f"{one['rescored']} candidates rescored; in process "
          f"{time.perf_counter() - t0:.1f} s")
    del base, a, eng, model
    check_released(torch, "vlm ranks (a)")
    return runs, dict(one=one)


def vlm_ranks_check(torch, serve, pending, records, card):
    """``vlm_ranks_phase``'s gloo runs, from their records: (b) 16/16 LM
    heads and 8 tower heads a rank and half the weights, (c) the whole
    model, half the slots and pages a rank with mirror pages; each rank
    with (a)'s streams (``agree``), K1/K2 counts (``rank_launch_checks``)
    and ``vlm_checks``. Prints tokens/s, peak memory with the build,
    weight and KV bytes, the tower's encode time, encodes, hits and K4
    launches a rank beside the card. Returns ({run: launches}, the rank
    runs)."""
    one = pending["one"]
    runs, rank_runs, models = {}, [], {}
    for run, (mesh, (H, Hkv), vh) in VLM_RANK_RUNS.items():
        dp, mp = (int(x) for x in mesh.split(","))
        for rec in (r for r in records if r["run"] == f"llava {run}"):
            what = f"vlm ranks {run} --mesh {mesh} rank {rec['rank']}"
            check(rec["eager"] and rec["graphs"] == 0,
                  f"{what}: a gloo rank's body must run eagerly")
            check((rec["q_heads"], rec["kv_heads"], rec["vision_heads"],
                   rec["B_local"]) == (H, Hkv, vh, SERVE["slots"] // dp),
                  f"{what}: {rec['q_heads']}/{rec['kv_heads']} heads, "
                  f"{rec['vision_heads']} tower heads, {rec['B_local']} rows")
            share = rec["weight_bytes"] / one["weight_bytes"]
            check(abs(share - 1 / mp) < 0.01,
                  f"{what}: holds {share:.4f} of the weights, not 1/{mp}")
            rank_launch_checks(rec, what)
            vlm_checks(rec, one, what)
            agree(torch, serve, one["cfg"], VLM_RANKS_ARGV, rec["streams"],
                  one["streams"], what, models)
            name = f"llava-1.5-7b ranks {run} rank {rec['rank']}"
            runs[name] = rec["launches"]
            rank_runs.append(name)
            print(f"{what} at {tuple(rec['coords'])}: "
                  f"{rec['tokens_per_s']:.1f} tok/s ({card}), peak device "
                  f"memory {rec['peak_gb']:.2f} GB allocated, "
                  f"{rec['peak_reserved_gb']:.2f} GB reserved (build "
                  f"included), weights {rec['weight_bytes'] / 1e9:.3f} GB, "
                  f"KV {rec['kv_bytes'] / 1e6:.1f} MB ({rec['pool_pages']} "
                  f"pages: {rec['own_pages']} own of {rec['num_pages']}, "
                  f"{rec['mirror_pages']} mirror, {rec['mirror_peak']} used "
                  f"at peak), {rec['q_heads']}/{rec['kv_heads']} heads, "
                  f"{rec['vision_heads']} tower heads, {rec['B_local']} "
                  f"rows; {rec['image_encodes']} image encodes "
                  f"({rec['encode_ms']:.1f} ms each, wall), "
                  f"{rec['image_feat_hits']} memo hits, K4a/K4b "
                  f"{rec['launches']['xmodal_score_mean']}/"
                  f"{rec['launches']['xmodal_score_max']} launches for "
                  f"{rec['rescored']} rescored candidates; launches "
                  f"{rec['launches']}")
    del models
    free_memory(torch)
    return runs, tuple(rank_runs)


# MoE serving over ranks (moe_ranks_phase): full-width
# granite-moe-3b-a800m, fp32, CAMD, the ranks phase's 2 requests on its
# 290-page pool. (b) and (d), whose ~2-3 host-staged collectives a layer
# and step cost ~4 ms each, serve 4 of the 32 layers against a
# one-process run of those 4 layers ((a4)); (c) serves all 32
MOE_RANKS_ARGV = with_arg(GRANITE_ARGV, "--requests", 2) + [
    "--num-pages", str(MESH_PAGES)]
MOE_RANK_LAYERS = 4
GRANITE_KERNELS = ("flash_attention", "paged_decode_attention",
                   "moe_dispatch", "moe_combine")
# the gloo runs: (mesh, layers (0: all of them), the one-process run
# whose streams each must give); (d) on four ranks, then the
# expert-parallel check on the same four
MOE_RANK_RUNS = {"(b)": ("1,2", MOE_RANK_LAYERS, "(a4)"),
                 "(c)": ("2,1", 0, "(a)"),
                 "(d)": ("2,2", MOE_RANK_LAYERS, "(a4)")}
# moe_apply_shard_map on four gloo ranks: one granite layer
# at full width, 512 global tokens, a capacity factor of E / k, at which
# C_s is a rank's token count and nothing can drop
SHARD_MAP_TOKENS = 512


def shard_map_rank(torch, ops):
    """``moe_apply_shard_map`` on this rank of a (2, 2) world of the four
    gloo ranks: one seeded full-width granite-moe-3b-a800m MoE layer,
    the rank holding the router, its data rank's 20 experts at its model
    rank's 256 of their 512 hidden columns, and its 256 of 512 seeded
    global tokens. Through K5a/K5b (``impl="cuda"``, launches counted)
    and their plain versions, against each other and against
    ``moe_apply_dense`` on the whole layer; every aux term alike on every
    rank and nothing dropped. Returns the rank's record."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.context import release_world
    from repro_torch.launch.mesh import make_rank_mesh
    from repro_torch.models.moe import MoE, moe_apply_dense
    from repro_torch.models.moe_shard_map import moe_apply_shard_map
    cfg = get_config("granite-moe-3b-a800m").with_overrides(dtype="float32")
    e = cfg.moe
    world = make_rank_mesh(2, 2).world
    d, m = world.coords
    gen = torch.Generator(device="cuda").manual_seed(17)
    whole = MoE(cfg, device="cuda", gen=gen)
    x = torch.randn(SHARD_MAP_TOKENS, cfg.d_model, generator=gen,
                    device="cuda")
    E_loc, f_loc, n = e.num_experts // 2, e.expert_d_ff // 2, \
        SHARD_MAP_TOKENS // 2
    p = MoE(cfg.with_overrides(moe=dataclasses.replace(
        e, num_experts=E_loc, expert_d_ff=f_loc)), device="cuda")
    p.router = whole.router                 # (d, 40), whole on every rank
    eb, fb = slice(d * E_loc, (d + 1) * E_loc), slice(m * f_loc,
                                                      (m + 1) * f_loc)
    p.w_gate.copy_(whole.w_gate[eb, :, fb])
    p.w_up.copy_(whole.w_up[eb, :, fb])
    p.w_down.copy_(whole.w_down[eb, fb])
    x_loc = x[d * n:(d + 1) * n]
    cf = e.num_experts / e.top_k
    with torch.inference_mode():
        ops.reset_launches()
        got, aux = moe_apply_shard_map(p, cfg, x_loc, world, model_axis=True,
                                       capacity_factor=cf, impl="cuda")
        torch.cuda.synchronize()
        launches = dict(ops.LAUNCHES)
        plain, plain_aux = moe_apply_shard_map(
            p, cfg, x_loc, world, model_axis=True, capacity_factor=cf,
            impl="torch")
        dense = moe_apply_dense(whole, cfg, x)[d * n:(d + 1) * n]
    release_world(world)
    atol, rtol = TOL["float32"]
    return dict(
        rank=world.rank, coords=[d, m], experts=[eb.start, eb.stop],
        f=[fb.start, fb.stop], tokens=n, launches=launches,
        finite=bool(torch.isfinite(got).all()),
        err_plain=float((got - plain).abs().max()),
        err_dense=float((got - dense).abs().max()),
        ok_plain=bool(((got - plain).abs() <=
                       atol + rtol * plain.abs()).all()),
        ok_dense=bool(((got - dense).abs() <=
                       atol + rtol * dense.abs()).all()),
        aux={k: float(v) for k, v in aux.items()},
        plain_aux={k: float(v) for k, v in plain_aux.items()})


def moe_ranks_phase(torch, ops, serve, card):
    """Serving full-width granite-moe-3b-a800m in fp32 with CAMD over
    torch.distributed ranks, through the serve entry point
    (``MOE_RANKS_ARGV``): (a) one NCCL rank (world 1, its model built by
    the entry point for that world; one captured graph with its
    collectives, the MoE layers' gather of the decode rows among them)
    against the same run without a group on the same seeded weights: the
    same streams and K1/K2/K5a/K5b counts; and the one-process run (a4) of
    ``MOE_RANK_LAYERS`` layers. The models are released before the gloo
    ranks share the card. Returns ({run: launches}, what
    ``moe_ranks_check`` needs to hold the gloo runs (b) ``--mesh 1,2``,
    (c) ``--mesh 2,1`` and (d) ``--mesh 2,2``: the one-process streams
    they must give)."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    t0 = time.perf_counter()
    cfg = get_config("granite-moe-3b-a800m").with_overrides(dtype="float32")
    model = build_model(cfg, torch.float32, device="cuda", seed=0)
    runs = {}
    runs["granite-moe-3b-a800m ranks one process"], base = serve_phase(
        torch, ops, serve, MOE_RANKS_ARGV, GRANITE_KERNELS, model=model)
    moe_launch_checks(base, runs["granite-moe-3b-a800m ranks one process"])
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    base_tps, base_streams = base["tokens_per_s"], \
        stream_digest(base["results"])
    del base, model
    free_memory(torch)
    # the entry point builds (a)'s model for its world of one (the same
    # seeded weights), so that its MoE layers run their collectives
    with one_nccl_rank():
        runs["granite-moe-3b-a800m ranks (a)"], a = serve_phase(
            torch, ops, serve, MOE_RANKS_ARGV + ["--mesh", "1,1"],
            GRANITE_KERNELS)
    moe_launch_checks(a, runs["granite-moe-3b-a800m ranks (a)"])
    eng = a["engine"]
    check(eng.world is not None and eng.world.backend == "nccl" and
          not eng._eager_body and eng._graphs_captured == 1 and
          eng.model.layers[0].moe.world is eng.world,
          "moe ranks (a): not one NCCL rank replaying one captured graph "
          "with its MoE layers' collectives")
    check(stream_digest(a["results"]) == base_streams,
          "moe ranks (a): streams differ from the run without a group")
    for name in GRANITE_KERNELS:
        check(runs["granite-moe-3b-a800m ranks (a)"][name] ==
              runs["granite-moe-3b-a800m ranks one process"][name],
              f"moe ranks (a): {name} launched differently from the run "
              "without a group")
    one = {"(a)": dict(streams=base_streams, tps=a["tokens_per_s"],
                       peak_gb=a["peak_gb"], weight_bytes=weight_bytes,
                       card_gb=torch.cuda.get_device_properties(0)
                       .total_memory / 1e9),
           "cfg": cfg}
    print(f"moe ranks: (a) one NCCL rank {one['(a)']['tps']:.1f} tok/s, "
          f"without a group {base_tps:.1f} ({card}); weights "
          f"{weight_bytes / 1e9:.3f} GB, peak {one['(a)']['peak_gb']:.2f} "
          "GB")
    del a, eng
    free_memory(torch)
    small = build_model(cfg.with_overrides(num_layers=MOE_RANK_LAYERS),
                        torch.float32, device="cuda", seed=0)
    ops.reset_launches()
    o = serve.main(MOE_RANKS_ARGV + ["--num-layers", str(MOE_RANK_LAYERS)],
                   model=small)
    torch.cuda.synchronize()
    runs["granite-moe-3b-a800m ranks (a4)"] = dict(ops.LAUNCHES)
    one["(a4)"] = dict(streams=stream_digest(o["results"]),
                       tps=o["tokens_per_s"])
    print(f"moe ranks: {MOE_RANK_LAYERS} layers in one process (a4) "
          f"{one['(a4)']['tps']:.1f} tok/s; in process "
          f"{time.perf_counter() - t0:.1f} s")
    del o, small
    check_released(torch, "moe ranks (a)")
    return runs, dict(one=one)


def moe_ranks_check(torch, serve, pending, records, card):
    """``moe_ranks_phase``'s gloo runs (``MOE_RANK_RUNS``), from their
    records:
    every rank's body eager, its heads (24/8 over the model axis), rows
    and the experts the rule table gives it (all 40 at model 1, else the
    data rank's block) at its share of their width, its weights against
    the one-process model's, K1/K2 once a layer a prefill bucket and a
    step (``rank_launch_checks``) and K5a/K5b once each a layer a forward,
    and the streams of (a) for (c), of (a4) for (b) and (d) (``agree``).
    Prints tokens/s, per-rank peak memory, weight bytes, experts and
    heads beside the card. Returns ({run: launches}, the rank runs)."""
    one = pending["one"]
    E, f = one["cfg"].moe.num_experts, one["cfg"].moe.expert_d_ff
    runs, rank_runs, models = {}, [], {}
    for run, (mesh, layers, ref_run) in MOE_RANK_RUNS.items():
        dp, mp = (int(x) for x in mesh.split(","))
        cfg = one["cfg"].with_overrides(num_layers=layers) if layers \
            else one["cfg"]
        E_loc = E // dp if mp > 1 else E
        for rec in (r for r in records if r["run"] == f"granite {run}"):
            what = f"moe ranks {run} --mesh {mesh} rank {rec['rank']}"
            d = rec["coords"][0]
            e0 = d * E_loc if E_loc < E else 0
            check(rec["eager"] and rec["graphs"] == 0,
                  f"{what}: a gloo rank's body must run eagerly")
            check((rec["q_heads"], rec["kv_heads"], rec["B_local"],
                   rec["experts"], rec["expert_f"]) ==
                  (24 // mp, 8 // mp, SERVE["slots"] // dp,
                   [e0, e0 + E_loc], f // mp),
                  f"{what}: {rec['q_heads']}/{rec['kv_heads']} heads, "
                  f"{rec['B_local']} rows, experts {rec['experts']} at f "
                  f"{rec['expert_f']}")
            rank_launch_checks(rec, what)
            forwards = rec["prefill_calls"] + \
                rec["macro_launches"] * rec["macro_steps"]
            for name in ("moe_dispatch", "moe_combine"):
                check(rec["launches"][name] == rec["layers"] * forwards,
                      f"{what}: {name} launched {rec['launches'][name]} "
                      f"times, not {rec['layers']} x {forwards} forwards")
            check(rec["peak_reserved_gb"] < one["(a)"]["card_gb"],
                  f"{what}: {rec['peak_reserved_gb']:.1f} GB reserved")
            agree(torch, serve, cfg, MOE_RANKS_ARGV, rec["streams"],
                  one[ref_run]["streams"], what, models)
            name = f"granite-moe-3b-a800m ranks {run} rank {rec['rank']}"
            runs[name] = rec["launches"]
            rank_runs.append(name)
            print(f"{what} at {tuple(rec['coords'])}: "
                  f"{rec['tokens_per_s']:.1f} tok/s ({card}), peak device "
                  f"memory {rec['peak_gb']:.2f} GB allocated, "
                  f"{rec['peak_reserved_gb']:.2f} GB reserved (build "
                  f"included), weights {rec['weight_bytes'] / 1e9:.3f} GB "
                  f"({layers or cfg.num_layers} layers), experts "
                  f"[{rec['experts'][0]}, {rec['experts'][1]}) of {E} at f "
                  f"{rec['expert_f']} of {f}, {rec['q_heads']}/"
                  f"{rec['kv_heads']} heads, {rec['B_local']} rows; K5a/K5b "
                  f"{rec['launches']['moe_dispatch']}/"
                  f"{rec['launches']['moe_combine']} launches for "
                  f"{forwards} forwards of {rec['layers']} layers; launches "
                  f"{rec['launches']}")
    del models
    free_memory(torch)
    return runs, tuple(rank_runs)


def shard_map_check(records, card):
    """The four ranks' ``shard_map_rank`` records: each within fp32
    tolerance of the plain version and of the dense oracle, finite,
    K5a/K5b once each, nothing dropped, the aux alike on every rank and
    impl."""
    recs = [r for r in records if r["run"] == "granite shard_map"]
    check(len(recs) == 4, f"shard_map: {len(recs)} records")
    for rec in recs:
        what = f"shard_map rank {rec['rank']} at {tuple(rec['coords'])}"
        check(rec["finite"] and rec["ok_plain"] and rec["ok_dense"],
              f"{what}: max |err| {rec['err_plain']:.3e} against the plain "
              f"version, {rec['err_dense']:.3e} against the dense oracle")
        check(rec["launches"]["moe_dispatch"] == 1 ==
              rec["launches"]["moe_combine"],
              f"{what}: launches {rec['launches']}")
        check(rec["aux"] == recs[0]["aux"] and
              rec["aux"]["moe_drop_frac"] == 0.0,
              f"{what}: aux {rec['aux']} against rank 0's {recs[0]['aux']}")
        for k, v in rec["aux"].items():
            check(abs(v - rec["plain_aux"][k]) <= 1e-5,
                  f"{what}: {k} {v} against the plain {rec['plain_aux'][k]}")
        print(f"{what}: experts [{rec['experts'][0]}, {rec['experts'][1]}) "
              f"at f [{rec['f'][0]}, {rec['f'][1]}), {rec['tokens']} of "
              f"{SHARD_MAP_TOKENS} tokens; max |err| {rec['err_plain']:.3e} "
              f"against the plain version, {rec['err_dense']:.3e} against "
              f"moe_apply_dense; aux {rec['aux']}; K5a/K5b "
              f"{rec['launches']['moe_dispatch']}/"
              f"{rec['launches']['moe_combine']} ({card})")
    return {"granite-moe-3b-a800m shard_map": recs[0]["launches"]}


# recurrent and hybrid serving over ranks (recurrent_ranks_phase):
# full-width recurrentgemma-2b and mamba2-780m, fp32, ``--impl cuda``,
# the serve phases' 8 slots and 2 requests of 256 + 32 tokens, CAMD.
# Each recurrent request is prefilled alone and its state kept in an
# arena row of its own shard; CAMD's two rounds of 4 fill each shard's 4
# slots from its own rows, while greedy's one candidate a request puts
# request 1's in slot 1, on shard 0, its row on shard 1: the greedy runs
# of (b) and (d) seed a slot from a mirror row. (c) and (d) at 3 layers,
# one (RG-LRU, RG-LRU, local) period, the mamba2 (e) at 1,2 at 4 layers,
# against one-process runs of as many layers; (b) and (e) at 2,1 whole
RECURRENT_RANK_REQUESTS = 2
RECURRENT_RANK_LAYERS = {"recurrentgemma-2b": 3, "mamba2-780m": 4}
# run: (model, mesh, mode, layers (0: all of them))
RECURRENT_RANK_RUNS = {
    "(b)": ("recurrentgemma-2b", "2,1", "camd", 0),
    "(b) greedy": ("recurrentgemma-2b", "2,1", "greedy", 0),
    "(c)": ("recurrentgemma-2b", "1,2", "camd", 3),
    "(d)": ("recurrentgemma-2b", "2,2", "camd", 3),
    "(d) greedy": ("recurrentgemma-2b", "2,2", "greedy", 3),
    "(e)": ("mamba2-780m", "2,1", "camd", 0),
    "(e) 1,2": ("mamba2-780m", "1,2", "camd", 4),
}
# the runs whose streams must read an arena row across shards
RECURRENT_MIRROR_RUNS = ("(b) greedy", "(d) greedy")


def recurrent_ranks_argv(name, mode="camd", layers=0):
    """``name`` at the serve phases' shapes through ``--impl cuda``, with
    ``RECURRENT_RANK_REQUESTS`` requests, in ``mode``, at ``layers``
    layers (0: all of them)."""
    argv = with_arg(with_arg(with_arg(
        serve_argv(name, CACHE_LEN, RECURRENT_EOS[name]), "--impl", "cuda"),
        "--requests", RECURRENT_RANK_REQUESTS), "--mode", mode)
    return argv + (["--num-layers", str(layers)] if layers else [])


def recurrent_launch_want(eng, launches):
    """A recurrent or hybrid run's kernel launches: K2 once a local
    layer a prefill call, K3 once a local layer a decode step of every
    launch (masked steps included: a graph replays them, an eager body
    runs them), nothing else (mamba2: nothing at all)."""
    n_local = sum(k == "local" for k in eng.cfg.layer_kinds)
    want = {k: 0 for k in launches}
    want["flash_attention"] = n_local * eng.prefill_calls
    want["decode_attention"] = n_local * eng.macro_launches * \
        eng.macro_steps
    return want


def recurrent_run(torch, ops, serve, argv, model, what):
    """One recurrent or hybrid serve through the entry point on ``model``
    (launch counts set to 0 just before and read just after): every
    request resolved with a usable candidate, one graph captured, the
    launches ``recurrent_launch_want`` gives, the arena empty and
    audited. Returns (launches, output of serve.main, its peak device
    memory under "peak_gb")."""
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    out = serve.main(argv, model=model)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    eng = out["engine"]
    check(len(out["results"]) == RECURRENT_RANK_REQUESTS,
          f"{what}: {len(out['results'])} results")
    for r in out["results"]:
        check(r.n_candidates > 0 and 0 < len(r.tokens) <= SERVE["max_new"]
              and all(0 <= int(t) < eng.V for t in r.tokens) and
              math.isfinite(r.best_score),
              f"{what}: request {r.uid} has no usable candidate")
    check(eng._graphs_captured == 1 and eng.macro_launches > 0,
          f"{what}: {eng._graphs_captured} graphs captured")
    want = recurrent_launch_want(eng, launches)
    check(launches == want, f"{what}: launches {launches}, not {want}")
    eng.arena.check()
    check(eng.arena.in_use == 0, f"{what}: {eng.arena.in_use} rows held")
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return launches, out


def recurrent_ranks_phase(torch, ops, serve, card):
    """Serving full-width recurrentgemma-2b and mamba2-780m in fp32 over
    torch.distributed ranks, through the serve entry point
    (``recurrent_ranks_argv``), in process: (a) recurrentgemma-2b as one
    NCCL rank (world 1; one captured graph with its collectives) against
    the same run without a group on one seeded model: the same streams
    and K2/K3 counts; then the one-process runs whose streams the gloo
    runs (``RECURRENT_RANK_RUNS``) must give: recurrentgemma-2b greedy at
    full depth, CAMD and greedy at 3 layers, mamba2-780m CAMD at full
    depth and at 4 layers. Each model is released before the next.
    Returns ({run: launches}, what ``recurrent_ranks_check`` needs: the
    one-process records by (model, mode, layers))."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    t0 = time.perf_counter()
    runs, one, cfgs = {}, {}, {}

    def keep(key, out):
        eng = out["engine"]
        one[key] = dict(streams=stream_digest(out["results"]),
                        tps=out["tokens_per_s"], peak_gb=out["peak_gb"],
                        arena=eng.arena_stats(),
                        weight_bytes=sum(p.numel() * p.element_size()
                                         for p in eng.model.parameters()))
    for name in RECURRENT_EOS:
        cfg = get_config(name).with_overrides(dtype="float32")
        cfgs[name] = cfg
        small = RECURRENT_RANK_LAYERS[name]
        modes = {0: ("camd", "greedy"), small: ("camd", "greedy")} \
            if name == "recurrentgemma-2b" else {0: ("camd",),
                                                 small: ("camd",)}
        for layers, wanted in modes.items():
            model = build_model(cfg.with_overrides(num_layers=layers)
                                if layers else cfg, torch.float32,
                                device="cuda", seed=0)
            for mode in wanted:
                argv = recurrent_ranks_argv(name, mode, layers)
                run = f"{name} ranks one process {mode}" + (
                    f" {layers} layers" if layers else "")
                runs[run], out = recurrent_run(torch, ops, serve, argv,
                                               model, run)
                keep((name, mode, layers), out)
                if name != "recurrentgemma-2b" or layers or mode != "camd":
                    del out
                    continue
                with one_nccl_rank():
                    runs[f"{name} ranks (a)"], a = recurrent_run(
                        torch, ops, serve, argv + ["--mesh", "1,1"], model,
                        f"recurrent ranks (a) [{name}]")
                eng = a["engine"]
                check(eng.world is not None and eng.world.backend == "nccl"
                      and not eng._eager_body and eng._graphs_captured == 1,
                      "recurrent ranks (a): not one NCCL rank replaying one "
                      "captured graph")
                check(stream_digest(a["results"]) ==
                      one[name, mode, 0]["streams"],
                      "recurrent ranks (a): streams differ from the run "
                      "without a group")
                check(runs[f"{name} ranks (a)"] == runs[run],
                      "recurrent ranks (a): K2/K3 launched differently from "
                      "the run without a group")
                print(f"recurrent ranks: (a) [{name}] one NCCL rank "
                      f"{a['tokens_per_s']:.1f} tok/s, without a group "
                      f"{out['tokens_per_s']:.1f} ({card}); peak "
                      f"{a['peak_gb']:.2f} GB; launches "
                      f"{runs[f'{name} ranks (a)']}")
                del a, eng, out
            del model
            free_memory(torch)
    for (name, mode, layers), rec in one.items():
        print(f"recurrent ranks: one process [{name}, {mode}, "
              f"{layers or cfgs[name].num_layers} layers] "
              f"{rec['tps']:.1f} tok/s, weights "
              f"{rec['weight_bytes'] / 1e9:.3f} GB, peak {rec['peak_gb']:.2f}"
              f" GB ({card})")
    print(f"recurrent ranks: in process {time.perf_counter() - t0:.1f} s")
    check_released(torch, "recurrent ranks in process")
    return runs, dict(one=one, cfgs=cfgs)


# the reference's keys of ``arena_stats``, alike on every rank
ARENA_KEYS = ("num_rows", "num_shards", "free_rows", "in_use", "max_in_use",
              "alloc_count", "free_count", "sizing_stalls", "free_per_shard",
              "state_kind", "bytes_per_row", "resident_state_bytes")


def recurrent_ranks_check(torch, serve, pending, records, card):
    """``recurrent_ranks_phase``'s gloo runs (``RECURRENT_RANK_RUNS``),
    from their records: every rank's body eager, its rows, heads, SSD
    heads or RG-LRU width (a model rank's share; the one kv head whole),
    its arena rows (its shard's block and a mirror row a slot of its
    shard) and the arena's stats alike on every rank; K2 once a local
    layer a prefill call and K3 once a local layer a decode step on
    every recurrentgemma-2b rank, nothing on mamba2-780m's; the streams
    of the one-process run at the same depth and mode (``agree``); in
    ``RECURRENT_MIRROR_RUNS`` a row fetched across shards and held in a
    mirror. Prints tokens/s, per-rank weights and peak memory, the
    arena, collectives a decode step and heads beside the card. Returns
    ({run: launches}, the recurrentgemma-2b rank runs)."""
    one, cfgs = pending["one"], pending["cfgs"]
    runs, rg_runs, models = {}, [], {}
    for run, (name, mesh, mode, layers) in RECURRENT_RANK_RUNS.items():
        dp, mp = (int(x) for x in mesh.split(","))
        cfg = cfgs[name].with_overrides(num_layers=layers) if layers \
            else cfgs[name]
        ref_rec = one[name, mode, layers]
        recs = [r for r in records if r["run"] == f"recurrent {run}"]
        check(len(recs) == dp * mp, f"recurrent ranks {run}: {len(recs)} "
              "records")
        per_shard = 2 * SERVE["slots"] // dp + 4
        for rec in recs:
            what = f"recurrent ranks {run} [{name}] --mesh {mesh} rank " \
                f"{rec['rank']}"
            check(rec["eager"] and rec["graphs"] == 0,
                  f"{what}: a gloo rank's body must run eagerly")
            a = rec["arena"]
            widths = (rec["B_local"], rec["q_heads"], rec["kv_heads"],
                      rec["ssd_heads"], rec["rglru_width"])
            if name == "recurrentgemma-2b":
                want = (SERVE["slots"] // dp, 10 // mp, 1, 0, 2560 // mp)
            else:
                want = (SERVE["slots"] // dp, 0, 0, 48 // mp, 0)
            check(widths == want, f"{what}: rows, heads, SSD heads, RG-LRU "
                  f"width {widths}, not {want}")
            check(a["rank"]["rows"] == per_shard and
                  a["rank"]["mirror_rows"] ==
                  (SERVE["slots"] // dp if dp > 1 else 0),
                  f"{what}: arena rows {a['rank']}")
            check({k: a[k] for k in ARENA_KEYS} ==
                  {k: recs[0]["arena"][k] for k in ARENA_KEYS},
                  f"{what}: arena stats differ from rank 0's")
            check(a["num_rows"] == per_shard * dp and a["in_use"] == 0 and
                  a["bytes_per_row"] == ref_rec["arena"]["bytes_per_row"],
                  f"{what}: arena {a}")
            if mp == 1:
                check(rec["weight_bytes"] == ref_rec["weight_bytes"],
                      f"{what}: weights {rec['weight_bytes']} bytes, not the "
                      f"one process's {ref_rec['weight_bytes']}")
            n_local = rec["n_local"]
            steps = rec["macro_launches"] * rec["macro_steps"]
            want_l = {k: 0 for k in rec["launches"]}
            want_l["flash_attention"] = n_local * rec["prefill_calls"]
            want_l["decode_attention"] = n_local * steps
            check(rec["launches"] == want_l, f"{what}: launches "
                  f"{rec['launches']}, not {want_l}")
            check(rec["prefill_calls"] == RECURRENT_RANK_REQUESTS,
                  f"{what}: {rec['prefill_calls']} prefill calls")
            agree(torch, serve, cfg, recurrent_ranks_argv(name, mode, layers),
                  rec["streams"], ref_rec["streams"], what, models)
            key = f"{name} ranks {run} rank {rec['rank']}"
            runs[key] = rec["launches"]
            if n_local:
                rg_runs.append(key)
            c = rec["collectives"]
            print(f"{what} at {tuple(rec['coords'])}: "
                  f"{rec['tokens_per_s']:.1f} tok/s ({card}; one process "
                  f"{ref_rec['tps']:.1f}), peak device memory "
                  f"{rec['peak_gb']:.2f} GB (build included), weights "
                  f"{rec['weight_bytes'] / 1e9:.3f} GB "
                  f"({layers or cfg.num_layers} layers; one process "
                  f"{ref_rec['weight_bytes'] / 1e9:.3f}), {rec['B_local']} "
                  f"rows, {rec['q_heads']}/{rec['kv_heads']} heads, SSD heads"
                  f" {rec['ssd_heads']}, RG-LRU width {rec['rglru_width']}; "
                  f"arena {a['rank']['rows']} + {a['rank']['mirror_rows']} "
                  f"mirror rows of {a['rank']['bytes_per_row'] / 1e6:.3f} MB"
                  f" ({a['rank']['resident_state_bytes'] / 1e6:.1f} MB "
                  f"resident; whole rows {a['bytes_per_row'] / 1e6:.3f} MB, "
                  f"{a['num_rows']} of them), mirrors at peak "
                  f"{a['rank']['mirror_peak']}, rows fetched "
                  f"{a['rank']['row_fetches']}; collectives "
                  f"{c['body'] / max(c['steps'], 1):.2f} a decode step "
                  f"({c['body']} over {c['steps']} steps, {c['all']} in "
                  f"all); launches {rec['launches']}")
        if run in RECURRENT_MIRROR_RUNS:
            check(max(r["arena"]["rank"]["mirror_peak"] for r in recs) >= 1
                  and all(r["arena"]["rank"]["row_fetches"] >= 1
                          for r in recs),
                  f"recurrent ranks {run}: no arena row read across shards")
    del models
    free_memory(torch)
    return runs, tuple(rg_runs)


def spec_report(name, out, plain_tps):
    """A speculative serve run against the plain one of the same shapes:
    drafts proposed and accepted, tokens emitted per verify iteration and
    slot, tokens/s beside the plain run's, peak device memory."""
    eng = out["engine"]
    check(eng.spec and eng.spec_drafted > 0,
          f"{name}: {eng.spec_drafted} drafts proposed")
    per_iter = eng.total_tokens / max(eng.total_steps * eng.B, 1)
    print(f"speculative [{name}]: spec_k {eng.spec_k} ({eng.spec_mode}), "
          f"{eng.spec_drafted} drafted, {eng.spec_accepted} accepted "
          f"({eng.spec_accepted / eng.spec_drafted:.3f}); "
          f"{eng.total_tokens} tokens in {eng.total_steps} verify "
          f"iterations ({per_iter:.3f} a slot and iteration); "
          f"{out['tokens_per_s']:.1f} tok/s against the plain run's "
          f"{plain_tps:.1f} ({out['tokens_per_s'] / plain_tps:.3f}x); peak "
          f"device memory {out['peak_gb']:.1f} GB")


def wall_event_ms(torch, fn, reps: int = 5):
    """Mean host wall time (to a synchronize) and CUDA-event window of one
    call, after one warm-up call."""
    fn()
    walls, events = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        fn()
        end.record()
        end.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        events.append(start.elapsed_time(end))
    return sum(walls) / reps, sum(events) / reps


def graph_phase(torch, name, out, timer):
    """The served engine's CUDA graph: capture time, the device steps its
    launches ran against the real ones, the noise fill a launch needs, and
    one macro launch at the serve shape on the engine's idle slots (every
    iteration masked; the same kernels and shapes as a real launch):
    replayed against the same body run eagerly, each as host wall time,
    CUDA-event window and device busy time (the profiler's kernel sum,
    ``Timer.device_ms``: a window that lost a kernel's records is
    profiled again): the replay over 5 calls (3 profiled), the eager
    body, which takes up to 1.2 s a call on the 32-34B models, over 2 (1
    profiled)."""
    eng = out["engine"]
    K = max(eng.macro_steps, 1)
    masked = 1 - eng.total_steps / max(eng._steps_launched, 1)
    print(f"graph [{name}]: {eng._graphs_captured} captured in "
          f"{eng._capture_s:.3f} s (warm-up launch included); "
          f"{eng.macro_launches} replays of K {K} ran {eng._steps_launched} "
          f"steps for {eng.total_steps} real ones (masked share "
          f"{masked:.3f}); a replay counts {eng._graph_launches}")
    fill_wall, fill_ev = wall_event_ms(torch, lambda: eng._fill_noise(eng._t))
    with torch.inference_mode():
        rows = {}
        for how, fn, reps, prof_reps in (
                ("replay", eng._graph.replay, 5, 3),
                ("eager body", eng._macro_step, 2, 1)):
            wall, ev = wall_event_ms(torch, fn, reps)
            # every kernel of the launch at least once a call in the
            # window, as the timer checks, or profiled again
            busy = timer.device_ms(fn, reps=prof_reps, warmup=0,
                                   flush=False)
            rows[how] = (wall, ev, busy)
    print(f"graph [{name}]: noise fill {fill_wall:.3f} ms wall, "
          f"{fill_ev:.3f} ms CUDA events a launch; one macro launch "
          + "; ".join(f"{how} {w:.3f} ms wall, {e:.3f} ms events, {b:.3f} "
                      f"ms device busy (idle share {1 - b / w:.3f})"
                      for how, (w, e, b) in rows.items()))
    return rows


def image_checks(torch, serve, argv, out):
    """The image path of a multimodal serve run: one tower encode per
    distinct image drawn, every other request a memo hit, and finite
    kernel-rescored scores on every candidate."""
    from repro_torch.configs import get_config
    import hashlib
    eng, results = out["engine"], out["results"]
    args = serve.parse_args(argv)
    reqs = serve.make_requests(get_config(args.arch), args)
    distinct = len({hashlib.sha256(r.image.tobytes()).digest()
                    for r in reqs})
    check(eng.image_encodes == distinct,
          f"serve: {eng.image_encodes} tower encodes for {distinct} images")
    check(eng.image_encodes + eng.image_feat_hits == len(reqs),
          "serve: image encodes and memo hits do not cover the requests")
    for r in results:
        for c in r.candidates:
            check("s_align_xmodal" in c, f"serve: request {r.uid} candidate "
                  f"{c['uid']} was not rescored")
            check(bool(torch.isfinite(torch.tensor(
                [c["score"], c["s_align_xmodal"]])).all()),
                  f"serve: request {r.uid} has a non-finite score")
    print(f"image path: {distinct} distinct images, {eng.image_encodes} "
          f"tower encodes, {eng.image_feat_hits} memo hits, "
          f"{sum(r.n_candidates for r in results)} candidates rescored")


def image_prefill_timing(torch, out, timer):
    """Device time of one image encode and of one bucketed prefill of the
    serve phase's shape (8 rows of 576 image tokens + 256 prompt tokens,
    flash kernel), on the served model."""
    eng = out["engine"]
    model = eng.model
    v = model.cfg.vision
    g = torch.Generator(device="cuda").manual_seed(5)
    img = torch.randn(1, v.image_h, v.image_w, v.channels, generator=g,
                      device="cuda")
    with torch.inference_mode():
        encode_ms = timer.ms(lambda: model.encode_image(img), reps=3,
                             warmup=1)
        ev = model.encode_image(img).expand(SERVE["slots"], -1, -1)
        toks = torch.randint(2, model.cfg.vocab_size,
                             (SERVE["slots"], SERVE["prompt"]), generator=g,
                             device="cuda")
        lens = torch.full((SERVE["slots"],), SERVE["prompt"] + IMAGE_TOKENS,
                          dtype=torch.int32, device="cuda")
        cache = model.make_cache(SERVE["slots"], MM_CACHE_LEN)
        prefill_ms = timer.ms(lambda: model.prefill(
            toks, cache, ev, impl="cuda", lengths=lens), reps=3, warmup=1)
    print(f"image prefill: one tower encode {encode_ms:.2f} ms; one "
          f"bucketed prefill of {SERVE['slots']} x ({IMAGE_TOKENS} + "
          f"{SERVE['prompt']}) tokens {prefill_ms:.2f} ms (CUDA events, "
          "L2 flushed)")


def free_memory(torch) -> None:
    """Drop what a finished phase left (its model and caches) before the
    next phase's model is built."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def check_released(torch, phase: str) -> None:
    """After a serve phase's output is dropped: its model, KV pool and
    CUDA graph (with the graph's private memory pool) are gone; what stays
    is the timer's 256 MB flush buffer and small tables."""
    free_memory(torch)
    held = torch.cuda.memory_allocated() / 1e9
    print(f"{phase}: {held:.2f} GB of device memory held after release")
    check(held < 1.0, f"{phase}: {held:.2f} GB still held: the engine or "
          "its graph was not released")


def profile_phase(torch, ops, serve, argv, timer):
    """Where the serve phase's time goes, on a shorter run of the same
    shapes (2 requests fill the 8 slots): device busy time by kernel under
    torch.profiler, and the device's idle share against the same run's
    unprofiled wall time. (Processing the trace of the full 8-request run
    took minutes.) The window opens with the timer's head records, and
    must keep a record of every paged decode launch the run made, or the
    run is profiled again (``PROFILE_TRIES`` windows), as the timer's
    windows are."""
    from torch.profiler import ProfilerActivity, profile
    argv = list(argv)
    argv[argv.index("--requests") + 1] = "2"
    first = serve.main(argv)               # the engine's capture included
    wall_s, capture_s = first["seconds"], first["engine"]._capture_s
    del first
    free_memory(torch)
    for _ in range(PROFILE_TRIES):
        ops.reset_launches()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            timer._pad()
            out = serve.main(argv)
            torch.cuda.synchronize()
        times, counts = device_records(torch, prof)
        for k in timer._pad_keys:
            times.pop(k, None)
        # K1's split kernel runs once a launch: the records the profiler
        # kept against the launches the run made, the graph's replays and
        # its warm-up included
        eng = out["engine"]
        k1 = ops.LAUNCHES["paged_decode_attention"] + \
            eng._warmup_launches.get("paged_decode_attention", 0)
        seen = sum(n for k, n in counts.items()
                   if "split_decode_kernel" in k)
        print(f"profile: {seen} split_decode_kernel records for {k1} paged "
              f"decode launches ({eng.macro_launches} graph replays)")
        if seen == k1:
            break
        del out, eng
        free_memory(torch)
    check(seen == k1, f"profile: the profiler kept {seen} of {k1} paged "
          f"decode launches' records in {PROFILE_TRIES} windows")
    busy_us = sum(times.values())
    check(busy_us > 0, "profile: the profiler saw no device time")
    print(f"profile: device busy {busy_us / 1e3:.1f} ms; profiled wall "
          f"{out['seconds'] * 1e3:.1f} ms, unprofiled wall "
          f"{wall_s * 1e3:.1f} ms -> device idle share "
          f"{1 - busy_us / 1e6 / wall_s:.3f} of the unprofiled run, whose "
          f"graph capture (once an engine, warm-up launch included) took "
          f"{capture_s * 1e3:.1f} ms")
    for k, us in sorted(times.items(), key=lambda kv: -kv[1])[:10]:
        print(f"  {us / 1e3:9.2f} ms {100 * us / busy_us:5.1f}% "
              f"x{counts[k]:<6d} {k[:90]}")




def moe_launch_checks(out, launches):
    """Each forward of the served model (one per bucketed prefill, one per
    iteration of every macro launch) runs the MoE dispatch and combine
    once per layer (``serve_phase`` checks the attention kernels)."""
    eng = out["engine"]
    L = eng.cfg.num_layers
    steps = eng.macro_launches * eng.macro_steps
    forwards = eng.prefill_calls + steps
    for name in ("moe_dispatch", "moe_combine"):
        n = L * forwards
        check(launches[name] == n, f"serve: {name} launched "
              f"{launches[name]} times, not {n} ({L} layers)")
    print(f"moe path: {forwards} forwards ({eng.prefill_calls} prefill, "
          f"{steps} decode), {L} MoE layers each: moe_dispatch and "
          f"moe_combine {L * forwards} launches each, {L} per forward")


def granite_timing(torch, out, timer):
    """One bucketed prefill of the serve phase's shape (8 x 256 tokens)
    and one decode forward of 8 slots through the paged pool at position
    256, by CUDA events on the served model, and the decode forward's
    device time by kernel under torch.profiler."""
    model = out["engine"].model
    B, L, ps = SERVE["slots"], SERVE["prompt"], SERVE["page"]
    g = torch.Generator(device="cuda").manual_seed(7)
    toks = torch.randint(2, model.cfg.vocab_size, (B, L), generator=g,
                         device="cuda")
    lens = torch.full((B,), L, dtype=torch.int32, device="cuda")
    n = CACHE_LEN // ps
    with torch.inference_mode():
        cache = model.make_cache(B, CACHE_LEN)
        prefill_ms = timer.ms(lambda: model.prefill(
            toks, cache, impl="cuda", lengths=lens), reps=3, warmup=1)
        paged = model.make_paged_cache(B, CACHE_LEN, page_size=ps,
                                       num_pages=B * n + 1)
        paged["block_table"].copy_(1 + torch.arange(
            B * n, device="cuda", dtype=torch.int32).reshape(B, n))
        tok = toks[:, -1]

        def step():
            paged["pos"].fill_(L)
            model.decode_step(tok, paged, impl="cuda")

        decode_ms = timer.ms(step, reps=5, warmup=2)
        by_kernel = timer.kernel_times(step, 5)
    busy = sum(by_kernel.values()) / 5 / 1e3
    print(f"granite: one bucketed prefill of {B} x {L} tokens "
          f"{prefill_ms:.2f} ms; one decode forward of {B} slots "
          f"{decode_ms:.2f} ms (CUDA events, L2 flushed), of which "
          f"{busy:.2f} ms device time:")
    for k, v in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]:
        print(f"  {v / 5 / 1e3:8.3f} ms {100 * v / 5 / 1e3 / busy:5.1f}% "
              f"{k[:90]}")


QWEN_DENSE_ARGV = dense_argv("qwen3-0.6b", 96, 151936)
GRANITE_DENSE_ARGV = dense_argv("granite-moe-3b-a800m", 96, 49155)
LLAVA_DENSE_ARGV = dense_argv("llava-1.5-7b", IMAGE_TOKENS + 80, 32000,
                              IMAGE_EXTRA)


# the remaining attention-only configs: internvl2-2b's image requests in
# fp32, rescored (K4 at d 2048); the 32-34B ones in bf16 (eos outside each
# vocabulary)
INTERNVL_ARGV = serve_argv("internvl2-2b", INTERNVL_CACHE_LEN, 92553,
                           IMAGE_EXTRA)
LARGE_EOS = {"qwen2.5-32b": 152064, "yi-34b": 64000, "granite-34b": 49152}
DENSE_ARGVS = {
    "internvl2-2b": dense_argv("internvl2-2b", INTERNVL_TOKENS + 80, 92553,
                               IMAGE_EXTRA),
    **{name: dense_argv(name, 96, eos) for name, eos in LARGE_EOS.items()}}


def remaining_configs_phase(torch, ops, serve, timer):
    """The remaining attention-only configs at published widths: the
    4-layer fp32 dense checks of all four (granite-34b's through K1 and K3
    at 48 query heads over one kv head, internvl2-2b's with K4's
    rescoring), then each served at full depth (internvl2-2b in fp32 with
    image requests and ``--xmodal-rescore`` through the CLI, the others in
    bf16 through ``build_engine(..., param_dtype=torch.bfloat16)``), one
    model at a time, each released before the next: tokens/s, the
    whole-prompt prefill forward by CUDA events, the graph's capture and
    one replay's wall against its device busy time, peak device memory
    against the card's. Returns {run: launches}."""
    runs = {}
    for name, argv in DENSE_ARGVS.items():
        stamp(f"{name} dense check")
        kernels = ("flash_attention", "decode_attention") + (
            ("xmodal_score_mean", "xmodal_score_max")
            if name == "internvl2-2b" else ())
        runs[f"{name} dense check"] = dense_check(torch, ops, serve, argv,
                                                  kernels)
        free_memory(torch)
    for name, argv, dtype, kernels in (
            ("internvl2-2b", INTERNVL_ARGV, None, LLAVA_KERNELS),
            *((name, serve_argv(name, CACHE_LEN, eos), torch.bfloat16,
               TEXT_KERNELS) for name, eos in LARGE_EOS.items())):
        run = f"{name} serve"
        t0 = time.perf_counter()
        stamp(run)
        runs[run], out = serve_phase(torch, ops, serve, argv, kernels,
                                     timed=True, param_dtype=dtype)
        stamp(f"{run}: served")
        if name == "internvl2-2b":
            image_checks(torch, serve, argv, out)
        eng = out["engine"]
        ms, att_ms = prefill_times(
            {"prefill": out["spans"]["prefill"]})["prefill"]
        print(f"prefill [{name}, {eng.model.param_dtype}]: one whole-prompt "
              f"forward of {eng.prefill_tokens} tokens {ms:.2f} ms (CUDA "
              f"events), {att_ms:.2f} ms of it the flash kernel")
        graph_phase(torch, name, out, timer)
        stamp(f"{run}: graph timed")
        del out, eng
        check_released(torch, run)
        print(f"{run}: {time.perf_counter() - t0:.1f} s")
    return runs


# the recurrent (SSD) and hybrid (RG-LRU + local attention) models: eos
# outside each vocabulary; the dense check at 3 layers (recurrentgemma's
# one tile of RG-LRU, RG-LRU, local attention), full widths
RECURRENT_EOS = {"mamba2-780m": 50280, "recurrentgemma-2b": 256000}
RECURRENT_DENSE_LAYERS = 3


def recurrent_argv(name):
    """The serve phases' shapes (8 slots, 8 requests of 256 + 32 tokens,
    CAMD, K 8) through ``--impl cuda`` (a recurrent or hybrid model has no
    layer to page), the 8 requests arriving at once through the
    front-end (``--open-loop`` at 1000 requests/s), which times their
    first tokens."""
    return with_arg(serve_argv(name, CACHE_LEN, RECURRENT_EOS[name]),
                    "--impl", "cuda") + [
        "--open-loop", "--arrival", "poisson", "--arrival-rate", "1000"]


def step_bytes(eng):
    """Bytes one decode step of all slots must move at least: every
    weight read once (the tied table once, for the logits), every slot's
    recurrent state (SSD state and conv tails, RG-LRU h and conv tails)
    read and written once, and the local layers' rings read once."""
    weights = sum(p.numel() * p.element_size()
                  for p in eng.model.parameters())
    cache = eng.state.cache
    state = sum(cache[k].numel() * cache[k].element_size()
                for k in ("ssd", "ssm_conv", "h", "rglru_conv") if k in cache)
    rings = sum(cache[k].numel() * cache[k].element_size()
                for k in ("k", "v") if k in cache)
    return weights + 2 * state + rings, weights, state


def recurrent_serve_phase(torch, ops, serve, timer, name, card):
    """One model served at full width in fp32 through the serve entry
    point (``recurrent_argv``), launch counts set to 0 just before and
    read just after: mamba2-780m launches no kernel (its SSD path has
    none in the reference either), recurrentgemma-2b launches K2 once a
    local layer a prefill forward and K3 once a local layer a step of
    every replay, nothing else. One graph; every request resolved; the
    arena ends empty and audits clean. Prints tokens/s, TTFT, the arena's
    stats, the graph's capture and a replay's device time a step against
    the byte bound of one step. Returns (launches, seconds)."""
    t0 = time.perf_counter()
    argv = recurrent_argv(name)
    print(f"recurrent phase [{name}]: python -m repro_torch.launch.serve "
          + " ".join(argv))
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    with counting_prefills(torch) as (forwards, _):
        out = serve.main(argv)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    eng, m = out["engine"], out["metrics"]
    check(len(out["results"]) == SERVE["requests"] and
          m["completed"] == SERVE["requests"],
          f"recurrent [{name}]: unresolved requests: {m}")
    for r in out["results"]:
        check(r.n_candidates > 0 and 0 < len(r.tokens) <= SERVE["max_new"]
              and all(0 <= int(t) < eng.V for t in r.tokens) and
              math.isfinite(r.best_score),
              f"recurrent [{name}]: request {r.uid} has no usable candidate")
    check(eng._graphs_captured == 1 and eng.macro_launches > 0,
          f"recurrent [{name}]: {eng._graphs_captured} graphs captured")
    n_local = sum(k == "local" for k in eng.cfg.layer_kinds)
    want = {k: 0 for k in launches}
    want["flash_attention"] = n_local * forwards["prefill"]
    want["decode_attention"] = n_local * eng.macro_launches * eng.macro_steps
    check(launches == want, f"recurrent [{name}]: launches {launches}, not "
          f"{want} ({n_local} local layers, {forwards['prefill']} prefill "
          f"forwards, {eng.macro_launches} replays of {eng.macro_steps})")
    check(forwards["prefill"] == SERVE["requests"] and
          eng.prefill_calls == SERVE["requests"],
          f"recurrent [{name}]: {forwards['prefill']} prefill forwards")
    eng.arena.check()
    a = eng.arena_stats()
    check(a["in_use"] == 0 and a["alloc_count"] == a["free_count"] ==
          SERVE["requests"], f"recurrent [{name}]: arena {a}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"recurrent [{name}]: {out['tokens_per_s']:.1f} tok/s "
          f"({eng.total_tokens} tokens in {out['seconds']:.2f} s, "
          f"{eng.total_steps} decode steps, {eng.macro_launches} launches, "
          f"{eng.prefill_calls} prefills); TTFT p50 {m['ttft_p50_ms']:.1f} "
          f"ms, p99 {m['ttft_p99_ms']:.1f} ms; peak device memory "
          f"{peak_gb:.1f} GB; launches {launches} [{card}]")
    print(f"recurrent [{name}]: state arena [{a['state_kind']}] peak "
          f"{a['max_in_use']}/{a['num_rows']} rows of {a['bytes_per_row']} "
          f"bytes, resident_state_bytes {a['resident_state_bytes']}, "
          f"{a['sizing_stalls']} stalls")
    rows = graph_phase(torch, name, out, timer)
    K = eng.macro_steps
    total, weights, state = step_bytes(eng)
    bound = total / PEAK_BYTES_PER_S * 1e3
    busy = rows["replay"][2] / K
    print(f"recurrent [{name}]: graph captured in {eng._capture_s:.3f} s; "
          f"a replay's device time {busy:.4f} ms a step against the byte "
          f"bound {bound:.4f} ms ({weights / 1e9:.3f} GB of weights, "
          f"{state / 1e6:.1f} MB of {eng.B} slots' recurrent state read and "
          f"written, {(total - weights - 2 * state) / 1e6:.1f} MB of rings; "
          f"{bound / busy:.3f} of the bound) [{card}]")
    del out, eng
    check_released(torch, f"{name} serve")
    return launches, time.perf_counter() - t0


def recurrent_dense_check(torch, ops, serve, name):
    """At 3 layers, full widths, fp32: greedy streams of the plain (torch,
    K 8), kernel (cuda, K 8, the captured graph) and kernel legacy-loop
    (cuda, K 0) engines agree; the kernel runs launch K2 and K3 on
    recurrentgemma-2b's local layer and nothing on mamba2-780m. Returns
    the kernel graph run's launches."""
    argv = ["--arch", name, "--no-reduced", "--num-layers",
            str(RECURRENT_DENSE_LAYERS), "--mode", "greedy", "--requests",
            "4", "--prompt-len", "64", "--max-new", "16", "--cache-len",
            "96", "--eos-id", str(RECURRENT_EOS[name]), "--device", "cuda",
            "--seed", "1"]
    streams, launches = {}, {}
    for impl, K in (("torch", 8), ("cuda", 8), ("cuda", 0)):
        ops.reset_launches()
        out = serve.main(argv + ["--impl", impl, "--macro-steps", str(K)])
        torch.cuda.synchronize()
        eng = out["engine"]
        check(eng._graphs_captured == (K > 0) and eng.arena.in_use == 0,
              f"recurrent dense check [{name}]: {impl} K {K}: "
              f"{eng._graphs_captured} graphs, {eng.arena.in_use} rows held")
        launches[impl, K] = dict(ops.LAUNCHES)
        streams[impl, K] = [r.tokens.tolist() for r in
                            sorted(out["results"], key=lambda r: r.uid)]
        del out, eng
        free_memory(torch)
    local = name == "recurrentgemma-2b"
    check(sum(launches["torch", 8].values()) == 0, "recurrent dense check: "
          "the plain engine launched a kernel")
    for key in (("cuda", 8), ("cuda", 0)):
        check((launches[key]["flash_attention"] > 0 and
               launches[key]["decode_attention"] > 0) == local and
              sum(launches[key].values()) == launches[key]["flash_attention"]
              + launches[key]["decode_attention"],
              f"recurrent dense check [{name}]: {key} launches "
              f"{launches[key]}")
        check(streams[key] == streams["torch", 8],
              f"recurrent dense check [{name}]: {key} greedy streams differ "
              f"from torch's: {streams[key]} vs {streams['torch', 8]}")
    print(f"recurrent dense check [{name}]: greedy streams of torch (K 8), "
          f"cuda (K 8, graph) and cuda (K 0) agree "
          f"({sum(map(len, streams['torch', 8]))} tokens, "
          f"{RECURRENT_DENSE_LAYERS} layers); cuda launches "
          f"{launches['cuda', 8]}")
    return launches["cuda", 8]


def recurrent_phase(torch, ops, serve, timer, card):
    """The recurrent and hybrid models: each one's 3-layer dense check,
    then its full-width serve (``recurrent_serve_phase``), one model at a
    time, each released before the next. Returns {run: launches}."""
    runs = {}
    for name in RECURRENT_EOS:
        stamp(f"{name} dense check")
        runs[f"{name} dense check"] = recurrent_dense_check(
            torch, ops, serve, name)
        stamp(f"{name} serve")
        runs[f"{name} serve"], secs = recurrent_serve_phase(
            torch, ops, serve, timer, name, card)
        print(f"{name} serve: {secs:.1f} s")
    return runs


def dense_check(torch, ops, serve, argv, kernels):
    """Greedy streams of the plain, dense-kernel and paged-kernel engines
    must agree, and every kernel in ``kernels`` must have carried the
    dense-kernel run. Where candidates were rescored, the kernel impls'
    S_align must match the plain engine's within 1e-4. Returns the
    dense-kernel run's launches."""
    streams, launches, rescored = {}, {}, {}
    for impl in ("torch", "cuda", "paged_cuda"):
        print(f"dense check: --impl {impl}")
        ops.reset_launches()
        out = serve.main(argv + ["--impl", impl])
        torch.cuda.synchronize()
        launches[impl] = dict(ops.LAUNCHES)
        res = sorted(out["results"], key=lambda r: r.uid)
        streams[impl] = [r.tokens.tolist() for r in res]
        rescored[impl] = [c.get("s_align_xmodal") for r in res
                          for c in r.candidates]
        del out
        free_memory(torch)
    check(sum(launches["torch"].values()) == 0,
          "dense check: the plain engine launched a kernel")
    for name in kernels:
        check(launches["cuda"][name] > 0,
              f"dense check: {name} was never launched")
    check(launches["paged_cuda"]["paged_decode_attention"] > 0,
          "dense check: paged_decode_attention was never launched")
    for impl in ("cuda", "paged_cuda"):
        check(streams[impl] == streams["torch"],
              f"dense check: {impl} greedy streams differ from torch: "
              f"{streams[impl]} vs {streams['torch']}")
        for a, b in zip(rescored["torch"], rescored[impl]):
            check((a is None) == (b is None) and
                  (a is None or abs(a - b) <= 1e-4 + 1e-4 * abs(a)),
                  f"dense check: {impl} S_align {b} vs plain {a}")
    n_res = sum(a is not None for a in rescored["torch"])
    print("dense check: greedy streams of torch, cuda and paged_cuda agree "
          f"({sum(len(s) for s in streams['torch'])} tokens; {n_res} "
          "kernel-rescored S_align within 1e-4 of the plain engine's)")
    camd = {}
    for K in ("8", "0"):
        print(f"dense check: --impl paged_cuda --mode camd --macro-steps {K}")
        out = serve.main(argv + ["--impl", "paged_cuda", "--mode", "camd",
                                 "--macro-steps", K])
        eng = out["engine"]
        check(eng._graphs_captured == (K != "0"),
              f"dense check: K {K} captured {eng._graphs_captured} graphs")
        camd[K] = [[c["tokens"].tolist() for c in r.candidates]
                   for r in sorted(out["results"], key=lambda r: r.uid)]
        del out, eng
        free_memory(torch)
    check(camd["8"] == camd["0"], "dense check: CAMD streams of the graph "
          f"(K 8) differ from the eager loop's (K 0): {camd['8']} vs "
          f"{camd['0']}")
    print(f"dense check: CAMD streams of the graph (K 8) and the eager loop "
          f"(K 0) agree ({sum(len(c) for r in camd['8'] for c in r)} tokens "
          f"in {sum(len(r) for r in camd['8'])} candidates)")
    return launches["cuda"]


def quant_dense_check(torch, ops, serve, argv, kv_dtype):
    """At reduced depth, greedy streams of the plain (paged) and kernel
    (paged_cuda) engines on one quantized pool must agree, and the kernel
    engine's run must go through the paged decode kernel."""
    streams = {}
    for impl in ("paged", "paged_cuda"):
        ops.reset_launches()
        out = serve.main(argv + ["--impl", impl, "--kv-dtype", kv_dtype])
        torch.cuda.synchronize()
        check((ops.LAUNCHES["paged_decode_attention"] > 0) ==
              (impl == "paged_cuda"),
              f"quantized dense check: {impl} paged decode launches "
              f"{ops.LAUNCHES['paged_decode_attention']}")
        streams[impl] = [r.tokens.tolist() for r in
                         sorted(out["results"], key=lambda r: r.uid)]
        del out
        free_memory(torch)
    check(streams["paged"] == streams["paged_cuda"],
          f"quantized dense check [{kv_dtype}]: paged_cuda greedy streams "
          f"differ from paged: {streams['paged_cuda']} vs {streams['paged']}")
    print(f"quantized dense check [{kv_dtype}]: greedy streams of paged and "
          f"paged_cuda agree ({sum(len(s) for s in streams['paged'])} "
          "tokens)")


# ---------------------------------------------------------------------------
# prefix cache and chunked prefill
# ---------------------------------------------------------------------------

LLAVA_KERNELS = ("flash_attention", "paged_decode_attention",
                 "xmodal_score_mean", "xmodal_score_max")
TEXT_KERNELS = ("flash_attention", "paged_decode_attention")


def prefill_times(spans):
    """{forward kind: (ms, attention ms)} from ``counting_prefills``'s
    spans, the mean over the forwards of that kind after the first (which
    warms the shape up), or the one forward there is."""
    out = {}
    for name, runs in spans.items():
        runs = [(a.elapsed_time(b), sum(x.elapsed_time(y) for x, y in att))
                for (a, b), att in runs]
        check(bool(runs), f"prefix cache: no {name} forward was timed")
        warm = runs[1:] or runs
        out[name] = tuple(sum(x) / len(warm) for x in zip(*warm))
        print(f"  {name} forwards (ms, attention ms): "
              + ", ".join(f"({a:.2f}, {b:.2f})" for a, b in runs))
    return out


def prefix_phase(torch, ops, serve, plain_prefill_tokens):
    """llava-1.5-7b image requests with the prefix cache on: every request
    whose image an earlier one brought hits the 36 pages of its 576-token
    image span and prefills only its 256 prompt tokens against them (the
    first of each image prefills whole, through the flash kernel); the
    prefill tokens fall by the hit tokens against the run without the
    cache. Then a hit's prefill forward to its first-token logits against
    a miss's, CUDA events in the same run (``prefill_times``), and no page
    in use once the cache drops its holds."""
    import hashlib
    argv = LLAVA_ARGV + ["--prefix-cache"]
    launches, out = serve_phase(torch, ops, serve, argv, LLAVA_KERNELS,
                                timed=True)
    image_checks(torch, serve, argv, out)
    eng, fw = out["engine"], out["forwards"]
    args = serve.parse_args(argv)
    reqs = serve.make_requests(eng.cfg, args)
    distinct = len({hashlib.sha256(r.image.tobytes()).digest()
                    for r in reqs})
    span_pages = IMAGE_TOKENS // SERVE["page"]
    hits = len(reqs) - distinct
    pc = eng.kv_stats()["prefix_cache"]
    full = IMAGE_TOKENS + SERVE["prompt"]
    want = {"suffix forwards": (fw["prefill_suffix"], hits),
            "whole forwards": (fw["prefill"], distinct),
            "page hits": (pc["hits"], hits * span_pages),
            "hit tokens": (pc["hit_tokens"], hits * IMAGE_TOKENS),
            "prefill tokens": (eng.prefill_tokens,
                               distinct * full + hits * SERVE["prompt"]),
            "prefill tokens saved": (plain_prefill_tokens -
                                     eng.prefill_tokens, pc["hit_tokens"])}
    for what, (got, exp) in want.items():
        check(got == exp, f"prefix cache: {what} {got}, not {exp}")
    print(f"prefix cache: {hits} of {len(reqs)} requests hit "
          f"{span_pages} pages each ({pc['hits']} page hits, "
          f"{pc['hit_tokens']} prefill tokens skipped, "
          f"{pc['bytes_saved'] / 1e9:.2f} GB of KV writes saved); "
          f"{eng.prefill_tokens} prefill tokens run against "
          f"{plain_prefill_tokens} without the cache; {pc['cached_pages']} "
          f"pages cached")
    t = prefill_times(out["spans"])
    (hit_ms, hit_attn), (miss_ms, miss_attn) = t["prefill_suffix"], \
        t["prefill"]
    print(f"prefix cache: prefill forward to first-token logits (CUDA "
          f"events, mean of the warm ones): hit {hit_ms:.2f} ms (suffix "
          f"attention, plain sdpa against 576 cached positions: "
          f"{hit_attn:.2f} ms, {hit_attn / hit_ms:.3f}), miss {miss_ms:.2f} "
          f"ms (flash kernel {miss_attn:.2f} ms, {miss_attn / miss_ms:.3f}); "
          f"hit/miss {hit_ms / miss_ms:.3f}")
    eng.pool.prefix.drop_all()
    eng.pool.check()
    check(eng.pool.in_use == 0 and eng._reserved == 0,
          f"prefix cache: {eng.pool.in_use} pages in use after drop_all")
    print("prefix cache: no page in use after drop_all; pool check passed")
    return launches, out


def chunk_phase(torch, ops, serve, argv, kernels, chunk, plain_tps=None):
    """A serve run with chunked prefill: each prompt streams into the pool
    in chunks of ``chunk`` (the first a whole-prompt forward through the
    flash kernel, carrying an image span whole; the rest suffix forwards
    against the pages before them), interleaved with decode launches. Its
    chunk calls and tokens must be the prompt's. Returns serve_phase's
    output."""
    launches, out = serve_phase(torch, ops, serve, argv, kernels)
    eng, fw = out["engine"], out["forwards"]
    n = len(out["results"])
    args = serve.parse_args(argv)
    span = args.prompt_len + (IMAGE_TOKENS if eng.has_evidence else 0)
    per_req = -(-span // chunk)
    want = {"chunk size": (eng.chunk, chunk),
            "chunk calls": (eng.chunk_calls, n * per_req),
            "chunk tokens": (eng.chunk_tokens, n * span),
            "whole forwards": (fw["prefill"], n),
            "suffix forwards": (fw["prefill_suffix"], n * (per_req - 1)),
            "prefill calls": (eng.prefill_calls, n)}
    for what, (got, exp) in want.items():
        check(got == exp, f"chunked prefill: {what} {got}, not {exp}")
    print(f"chunked prefill: chunk {eng.chunk}, budget {eng.chunk_budget} "
          f"tokens a turn; {eng.chunk_calls} chunk calls over "
          f"{eng.chunk_tokens} tokens ({per_req} a request)"
          + (f"; {out['tokens_per_s']:.1f} tok/s against the unchunked "
             f"serve phase's {plain_tps:.1f}" if plain_tps else ""))
    return launches, out


def feature_check(torch, ops, serve, argv, flags, impls, waves, label=None):
    """At 4 layers: greedy streams with ``flags`` (the prefix cache, chunked
    prefill, speculation) on and off, over ``impls``, each engine serving
    ``waves`` submissions of the same requests (a later wave hits the
    pages the first one cached), must agree; the runs with the flags must
    hit the cache, chunk and draft where asked; the kernel impls must
    launch the flash kernel, and the paged decode kernel unless they
    speculate (the verify runs plain sdpa)."""
    from repro_torch.serving.engine import Request
    streams, stats = {}, {}
    for impl in impls:
        for on in (False, True):
            run = f"{impl}{' ' + ' '.join(flags) if on else ''}"
            args = serve.parse_args(argv + ["--impl", impl] +
                                    (flags if on else []))
            cfg, eng = serve.build_engine(args)
            ops.reset_launches()
            with torch.inference_mode():
                for w in range(waves):
                    for r in serve.make_requests(cfg, args):
                        eng.submit(Request(uid=100 * w + r.uid,
                                           prompt=r.prompt, image=r.image))
                    res = sorted(eng.run(), key=lambda r: r.uid)
            torch.cuda.synchronize()
            kernels = impl.endswith("cuda")
            check((ops.LAUNCHES["flash_attention"] > 0) == kernels and
                  (ops.LAUNCHES["paged_decode_attention"] > 0) ==
                  (kernels and not eng.spec),
                  f"feature check [{run}]: kernel launches {ops.LAUNCHES}")
            streams[run] = [r.tokens.tolist() for r in res]
            if on and "--prefix-cache" in flags:
                pc = eng.kv_stats()["prefix_cache"]
                stats[run] = (pc["hits"], eng.chunk_calls)
                check(pc["hits"] > 0, f"feature check [{run}]: no hit")
                check((eng.chunk_calls > 0) == ("--prefill-chunk" in flags),
                      f"feature check [{run}]: {eng.chunk_calls} chunks")
            if on and "--spec-k" in flags:
                stats[run] = (eng.spec_drafted, eng.spec_accepted)
                check(eng.spec_drafted > 0, f"feature check [{run}]: no "
                      "draft proposed")
            eng.pool.check()
            del eng
            free_memory(torch)
    first = next(iter(streams.values()))
    for run, st in streams.items():
        check(st == first, f"feature check: greedy streams of [{run}] "
              f"differ from [{next(iter(streams))}]: {st} vs {first}")
    what = "drafts proposed and accepted" if "--spec-k" in flags else \
        "page hits and chunk calls"
    print(f"feature check [{label or argv[1]}, 4 layers, "
          f"{waves} wave(s)]: greedy streams agree over "
          f"{', '.join(streams)} ({sum(len(s) for s in first)} tokens; "
          f"{what} with the flags: {stats})")


# ---------------------------------------------------------------------------
# open-loop serving: arrivals on their own clock, streams and cancels
# ---------------------------------------------------------------------------

OPEN_LOOP = dict(requests=16, load=0.7, seed=11, cancel_seed=13,
                 camd_requests=8)
OPEN_ARGV = with_arg(with_arg(QWEN_ARGV, "--mode", "greedy"), "--requests",
                     OPEN_LOOP["requests"])
# pump -> uids: 0, 3, 9, 10 running (9 and 10 admitted at pump 1), 11
# queued and never prefilled, 6 finished (16 tokens in two launches)
CANCEL_PLAN = {0: [0, 3, 11], 1: [9], 2: [6, 10]}


def assert_drained(eng, what):
    """No page, slot, reservation or commitment outlives a drained
    engine."""
    eng.pool.check()
    cached = eng.pool.prefix.cached_pages if eng.pool.prefix else 0
    check(eng.pool.in_use == cached and eng._reserved == 0,
          f"{what}: {eng.pool.in_use} pages in use ({cached} cached), "
          f"{eng._reserved} reserved: leaked")
    check(all(int(s) == -1 for s in eng._slot_req) and
          not bool(eng.state.active.any()), f"{what}: a slot is still busy")
    check(eng.scheduler.committed == 0,
          f"{what}: {eng.scheduler.committed} tokens still committed")


def drive_open(eng, reqs, arrivals, slo_ms, cancel_uids=()):
    """One open-loop cell through the port's async front-end and traffic
    loop (what ``run_open_loop`` does), also recording each request's
    delivered stream and each ``pump``'s host wall time (its launch's sync
    included; the event loop waits meanwhile) and whether it prefilled.
    Returns (traces, metrics, delivered, pumps)."""
    from repro_torch.serving import AsyncServeFrontend
    from repro_torch.serving.traffic import drive_open_loop, slo_metrics
    delivered = {r.uid: [] for r in reqs}
    pumps = []
    pump = eng.pump

    def timed_pump():
        calls, t0 = eng.prefill_calls, time.perf_counter()
        more = pump()
        pumps.append((time.perf_counter() - t0, eng.prefill_calls > calls))
        return more

    async def run():
        async with AsyncServeFrontend(eng) as fe:
            inner = fe.stream

            async def stream(uid):
                async for tok in inner(uid):
                    delivered[uid].append(int(tok))
                    yield tok
            fe.stream = stream
            return await drive_open_loop(fe, reqs, arrivals,
                                         cancel_uids=cancel_uids,
                                         cancel_after_tokens=1)

    eng.pump = timed_pump
    try:
        traces = asyncio.run(run())
    finally:
        del eng.pump
    return traces, slo_metrics(traces, slo_ttft_ms=slo_ms), delivered, \
        pumps


def open_loop_phase(torch, ops, serve, card):
    """Greedy open-loop serving on full-width qwen3-0.6b (``--impl
    paged_cuda``, eos outside the vocabulary: every request emits 32
    tokens), one engine over six waves of the same 16 prompts, as the
    reference bench's open-loop section runs them: warm-up (the capture),
    closed loop (golden streams, capacity), Poisson and bursty arrivals at
    0.7x capacity, saturation, Poisson with every third client cancelling
    after its first token. Each wave's launches and prefill forwards are
    counted from 0; one graph serves all six. Returns ({wave: launches},
    summary for the CAMD phase)."""
    import numpy as np
    from repro_torch.serving.engine import Request
    from repro_torch.serving.traffic import ARRIVALS, poisson_arrivals
    n, load = OPEN_LOOP["requests"], OPEN_LOOP["load"]
    args = serve.parse_args(OPEN_ARGV)
    cfg, eng = serve.build_engine(args)
    base = serve.make_requests(cfg, args)
    L, K = eng.cfg.num_layers, eng.macro_steps
    print(f"open loop: {cfg.name} {L}L d{cfg.d_model}, greedy, {eng.B} "
          f"slots, {n} requests of {args.prompt_len} + {args.max_new} "
          f"tokens, K {K}, --impl {args.impl} [{card}]")

    def reqs(uid0):
        return [Request(uid=uid0 + r.uid, prompt=r.prompt) for r in base]

    runs = {}

    def wave(name, fn):
        eng.reset_stats()
        torch.cuda.synchronize()
        ops.reset_launches()
        with counting_prefills(torch) as (forwards, _):
            t0 = time.perf_counter()
            with torch.inference_mode():
                got = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        want = {"flash_attention": L * forwards["prefill"],
                "paged_decode_attention": L * eng.macro_launches * K}
        for kernel, exp in want.items():
            check(launches[kernel] == exp, f"open loop [{name}]: {kernel} "
                  f"launched {launches[kernel]} times, not {exp} ({L} "
                  f"layers, {forwards['prefill']} prefills, "
                  f"{eng.macro_launches} replays of {K} steps)")
        check(forwards["prefill_suffix"] == 0 and eng._graphs_captured == 1,
              f"open loop [{name}]: {forwards['prefill_suffix']} suffix "
              f"forwards, {eng._graphs_captured} graphs captured")
        assert_drained(eng, f"open loop [{name}]")
        runs[f"qwen3-0.6b open loop {name}"] = launches
        print(f"open loop [{name}]: {wall:.3f} s, {eng.macro_launches} "
              f"replays, {eng.host_syncs} host syncs, {forwards['prefill']} "
              f"prefill forwards, {eng.total_tokens} tokens; launches "
              f"{launches}")
        return got, wall

    def closed(uid0):
        for r in reqs(uid0):
            eng.submit(r)
        return {r.uid - uid0: [int(t) for t in r.tokens]
                for r in eng.run() if uid0 <= r.uid < uid0 + n}

    _, warm = wave("warm-up", lambda: closed(10_000))
    print(f"open loop [warm-up]: graph captured in {eng._capture_s:.3f} s "
          f"of the wave's {warm:.3f} s")
    ref, closed_wall = wave("closed", lambda: closed(0))
    check(len(ref) == n and all(len(t) == args.max_new
                                for t in ref.values()),
          "open loop [closed]: a request did not emit max-new tokens")
    capacity = n / closed_wall
    closed_tps = n * args.max_new / closed_wall
    slo_ms = max(250.0, 4e3 * closed_wall / n)
    rate = load * capacity
    print(f"open loop [closed]: capacity {capacity:.3f} requests/s, "
          f"{closed_tps:.1f} tok/s; offered {rate:.3f} requests/s "
          f"({load}x); TTFT SLO {slo_ms:.1f} ms [{card}]")
    cells = {}
    for i, name in enumerate(("poisson", "bursty", "saturation", "cancel")):
        uid0 = 1000 * (i + 1)
        arrivals = np.zeros(n) if name == "saturation" else \
            poisson_arrivals(rate, n, seed=OPEN_LOOP["cancel_seed"]) \
            if name == "cancel" else \
            ARRIVALS[name](rate, n, seed=OPEN_LOOP["seed"])
        cancels = tuple(uid0 + j for j in range(0, n, 3)) \
            if name == "cancel" else ()
        (traces, m, delivered, pumps), _ = wave(name, lambda: drive_open(
            eng, reqs(uid0), arrivals, slo_ms, cancels))
        for tr in traces:
            want = ref[tr.uid - uid0]
            got = delivered[tr.uid]
            check(tr.t_done is not None and
                  tr.cancelled == (tr.uid in cancels),
                  f"open loop [{name}]: request {tr.uid} unresolved or "
                  f"cancelled {tr.cancelled}")
            if tr.cancelled:
                check(0 < len(got) < len(want) and got == want[:len(got)],
                      f"open loop [{name}]: cancelled stream {tr.uid} "
                      f"{got} is not a prefix of {want}")
            else:
                check(got == want and [int(t) for t in eng.result(
                    tr.uid).tokens] == want,
                      f"open loop [{name}]: stream {tr.uid} differs from "
                      f"the closed loop's: {got} vs {want}")
        check(m["completed"] == n - len(cancels) and
              m["cancelled"] == len(cancels) == eng.cancelled_requests,
              f"open loop [{name}]: {m['completed']} completed, "
              f"{m['cancelled']} cancelled, engine counted "
              f"{eng.cancelled_requests}")
        late = max(tr.t_submit - tr.t_arrival for tr in traces)
        pre = sorted(t for t, p in pumps if p)
        dec = sorted(t for t, p in pumps if not p)
        m["pumps"] = {"n": len(pumps), "with_prefill": len(pre),
                      "p50_ms": 1e3 * sorted(t for t, _ in pumps)[
                          len(pumps) // 2],
                      "max_ms": 1e3 * max(t for t, _ in pumps),
                      "prefill_p50_ms": 1e3 * pre[len(pre) // 2]
                      if pre else None,
                      "launch_only_p50_ms": 1e3 * dec[len(dec) // 2]
                      if dec else None}
        m["generator_late_max_ms"] = late * 1e3
        cells[name] = m
        print(f"open loop [{name}]: TTFT p50 {m['ttft_p50_ms']:.1f} / p99 "
              f"{m['ttft_p99_ms']:.1f} ms, TPOT p50 {m['tpot_p50_ms']:.2f} "
              f"/ p99 {m['tpot_p99_ms']:.2f} ms, goodput "
              f"{m['goodput_rps']:.3f} requests/s ({m['good_requests']}/"
              f"{m['completed']} within {slo_ms:.1f} ms), "
              f"{m['tokens_per_s']:.1f} tok/s over {m['span_s']:.3f} s; "
              f"{m['cancelled']} cancelled; generator at most "
              f"{late * 1e3:.1f} ms late; {len(pumps)} pumps, p50 "
              f"{m['pumps']['p50_ms']:.1f} ms, max "
              f"{m['pumps']['max_ms']:.1f} ms, {len(pre)} with a prefill "
              f"[{card}]")
    print("open loop: surviving streams equal the closed loop's in every "
          "cell; no page, slot or commitment leaked; one graph over six "
          "waves")
    print("open loop json: " + json.dumps(
        {"card": card, "capacity_rps": capacity, "closed_tokens_per_s":
         closed_tps, "capture_s": eng._capture_s, "slo_ms": slo_ms,
         "rate_rps": rate, "cells": cells}))
    return runs, {"capacity": capacity, "slo_ms": slo_ms}


def camd_open_loop_phase(torch, ops, serve, summary):
    """CAMD requests through the serve CLI's ``--open-loop`` at the same
    shapes (Poisson arrivals; a CAMD request runs rounds of 4 candidates,
    so the offered rate is the greedy capacity's 0.7x over 4): streams
    arrive at completion; every request resolves with a usable candidate,
    one graph, no leak (``serve_phase``'s checks, K1 and K2 counts
    included)."""
    rate = OPEN_LOOP["load"] * summary["capacity"] / 4
    argv = with_arg(QWEN_ARGV, "--requests", OPEN_LOOP["camd_requests"]) + \
        ["--open-loop", "--arrival", "poisson", "--arrival-rate",
         f"{rate:.4f}", "--slo-ms", f"{summary['slo_ms']:.1f}"]
    launches, out = serve_phase(torch, ops, serve, argv, TEXT_KERNELS)
    eng, m = out["engine"], out["metrics"]
    check(len(out["traces"]) == OPEN_LOOP["camd_requests"] and
          all(tr.t_done is not None and not tr.cancelled and
              tr.n_tokens > 0 for tr in out["traces"]) and
          m["completed"] == OPEN_LOOP["camd_requests"],
          f"open loop [camd]: unresolved requests: {m}")
    assert_drained(eng, "open loop [camd]")
    check(not eng.stream_tokens and not eng.stream_events,
          "open loop [camd]: the front-end left streaming on")
    del out, eng
    return launches


def cancel_check(torch, ops, serve):
    """At 4 layers: the plain (paged) and kernel (paged_cuda) greedy
    engines, 12 requests on 8 slots with streaming on, pumped through one
    cancel plan (queued and running requests, at fixed pump boundaries):
    the delivered streams, the cancelled sets and (steps, launches, host
    syncs) must agree, and nothing leaks."""
    from repro_torch.serving.engine import Request
    argv = with_arg(QWEN_DENSE_ARGV, "--requests", 12)
    seen = {}
    for impl in ("paged", "paged_cuda"):
        args = serve.parse_args(argv + ["--impl", impl])
        cfg, eng = serve.build_engine(args)
        eng.stream_tokens = True
        for r in serve.make_requests(cfg, args):
            eng.submit(Request(uid=r.uid, prompt=r.prompt))
        ops.reset_launches()
        streams, i = {}, 0
        with torch.inference_mode():
            while True:
                more = eng.pump()
                for uid, _cand, toks in eng.drain_stream_events():
                    streams.setdefault(uid, []).extend(int(t) for t in toks)
                for uid in CANCEL_PLAN.get(i, ()):
                    eng.cancel(uid)
                i += 1
                if not more:
                    break
        torch.cuda.synchronize()
        kernels = impl == "paged_cuda"
        check((ops.LAUNCHES["flash_attention"] > 0) == kernels and
              (ops.LAUNCHES["paged_decode_attention"] > 0) == kernels,
              f"cancel check [{impl}]: kernel launches {ops.LAUNCHES}")
        assert_drained(eng, f"cancel check [{impl}]")
        check(eng._graphs_captured == 1, f"cancel check [{impl}]: "
              f"{eng._graphs_captured} graphs captured")
        res = [eng.result(u) for u in range(args.requests)]
        for r in res:
            check(r.cancelled or streams.get(r.uid) ==
                  [int(t) for t in r.tokens],
                  f"cancel check [{impl}]: request {r.uid}'s stream "
                  "differs from its result")
        seen[impl] = (streams, [r.uid for r in res if r.cancelled],
                      (eng.total_steps, eng.macro_launches, eng.host_syncs),
                      eng.cancelled_requests)
        del eng
        free_memory(torch)
    check(seen["paged_cuda"] == seen["paged"],
          f"cancel check: paged_cuda {seen['paged_cuda'][1:]} differs from "
          f"paged {seen['paged'][1:]} (or their streams differ)")
    streams, cancelled, loop, _ = seen["paged"]
    check(cancelled and len(cancelled) < len(streams),
          f"cancel check: cancelled {cancelled}")
    print(f"cancel check [qwen3-0.6b, 4 layers]: paged and paged_cuda agree "
          f"under the cancel plan {CANCEL_PLAN}: {len(cancelled)} cancelled "
          f"{cancelled}, {sum(len(s) for s in streams.values())} tokens "
          f"streamed, (steps, launches, host syncs) {loop}")


# ---------------------------------------------------------------------------
# training and rescoring: the full-sequence forward
# ---------------------------------------------------------------------------

# the reference CLI's defaults (repro/launch/train.py:18-30) but for the
# steps: qwen3-0.6b for 20 of its 50 (the script's time), granite-moe for
# 10 (3.30 B params: fp32 weights, grads, m and v ~53 GB)
TRAIN_QWEN_ARGV = ["--arch", "qwen3-0.6b", "--steps", "20", "--batch", "8",
                   "--seq", "128", "--lr", "1e-3", "--device", "cuda"]
TRAIN_GRANITE_ARGV = ["--arch", "granite-moe-3b-a800m", "--steps", "10",
                      "--batch", "8", "--seq", "128", "--lr", "1e-3",
                      "--device", "cuda"]
# the recurrent (0.78 B params, 12.5 GB to train) and the hybrid (2.15 B,
# 34.4 GB) model through the same launcher
TRAIN_MAMBA_ARGV = ["--arch", "mamba2-780m", "--steps", "10", "--batch",
                    "8", "--seq", "128", "--lr", "1e-3", "--device", "cuda"]
TRAIN_RG_ARGV = ["--arch", "recurrentgemma-2b", "--steps", "5", "--batch",
                 "8", "--seq", "128", "--lr", "1e-3", "--device", "cuda"]
# the encoder-decoder (1.63 B, 26 GB) through training.train on lm_batches
# with evidence_batch's 512 frames a row (the CLI draws no evidence, as
# the reference's)
TRAIN_SEAMLESS = dict(steps=5, batch=8, seq=128, lr=1e-3)
# three steps on the card and on the host's CPU, full widths at reduced
# depth (arch: layer overrides, batch, seq); the losses (and the MoE's aux
# terms) must agree within this relative tolerance (fp32, TF32 off: the
# two sum in other orders, and AdamW's normalised step turns a
# near-cancelling gradient's rounding into a visible share of lr). The
# CPU side computes full-width logits: 256000-way for recurrentgemma and
# seamless, so their rows are shorter. recurrentgemma's 3 layers hold one
# local-attention layer; seamless's 2 + 2 take 512 frames a row.
TRAIN_CHECK = {
    "qwen3-0.6b": (dict(num_layers=2), 2, 64),
    "granite-moe-3b-a800m": (dict(num_layers=2), 2, 64),
    "mamba2-780m": (dict(num_layers=2), 2, 64),
    "recurrentgemma-2b": (dict(num_layers=3), 2, 32),
    "seamless-m4t-large-v2": (dict(num_layers=2, num_encoder_layers=2), 2,
                              32),
}
TRAIN_CHECK_STEPS = 3
# glibc's mallopt parameters and defaults (malloc.h)
M_TRIM_THRESHOLD, M_MMAP_MAX = -1, -4
MALLOC_DEFAULTS = {M_TRIM_THRESHOLD: 128 * 1024, M_MMAP_MAX: 65536}
TRAIN_CHECK_KEYS = ("loss", "moe_lb_loss", "moe_drop_frac")
TRAIN_CHECK_RTOL = 1e-4
# a round of candidates rescored by camd_wrap: 8 candidates of 32 tokens
# after a 32-token prompt (llava: behind its 576 image rows)
RESCORE = dict(K=8, prompt=32, cand=32)
# rescoring's cuda impl against its torch impl: scores and terms within
# atol + rtol * |value| (fp32: K2's 3xTF32 and K4/K5 against plain sdpa,
# einsums and gathers, through every layer); p_star within 1e-5
RESCORE_TOL = TOL["float32"]
RESCORE_P_STAR_ATOL = 1e-5


@contextlib.contextmanager
def timing_adamw(torch):
    """The CUDA-event span of every AdamW update the train step runs,
    under "spans", read once the device has synchronized."""
    from repro_torch.training import train_loop
    saved = train_loop.adamw_update
    spans = []

    def timed(*args, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = saved(*args, **kw)
        end.record()
        spans.append((start, end))
        return out

    train_loop.adamw_update = timed
    try:
        yield spans
    finally:
        train_loop.adamw_update = saved


def _train_seamless(torch):
    """``training.train`` on full-width seamless-m4t-large-v2, fp32, remat
    on: ``TRAIN_SEAMLESS`` steps of ``lm_batches`` rows with
    ``evidence_batch``'s frames, warm-up and schedule as the CLI sets
    them. Returns (history with each step's "seconds", argument view)."""
    from types import SimpleNamespace
    from repro_torch.config import TrainConfig
    from repro_torch.configs import get_config
    from repro_torch.data import lm_batches
    from repro_torch.models.model import build_model
    from repro_torch.training import train
    c = TRAIN_SEAMLESS
    cfg = get_config(SEAMLESS["name"]).with_overrides(dtype="float32")
    tc = TrainConfig(total_steps=c["steps"], warmup_steps=c["steps"] // 10,
                     learning_rate=c["lr"])
    model = build_model(cfg, torch.float32, device="cuda", seed=tc.seed)
    data = lm_batches(cfg.vocab_size, c["batch"], c["seq"], seed=0,
                      evidence={"num_tokens": cfg.num_evidence_tokens,
                                "dim": cfg.evidence_dim})
    hist = train(model, tc, data, steps=c["steps"], log_every=1)[2]
    prev = 0.0
    for h in hist:
        h["seconds"], prev = h["elapsed_s"] - prev, h["elapsed_s"]
    del model
    return hist, SimpleNamespace(arch=cfg.name, steps=c["steps"],
                                 batch=c["batch"], seq=c["seq"],
                                 vocab=cfg.vocab_size)


def train_phase(torch, ops, card):
    """Trains full-width qwen3-0.6b (20 steps), granite-moe-3b-a800m (10),
    mamba2-780m (10) and recurrentgemma-2b (5) in fp32 through
    ``repro_torch.launch.train.main``, and seamless-m4t-large-v2 (5, with
    512 evidence frames a row) through ``training.train``, remat on as the
    reference's TrainConfig has it, on the plain ``torch`` impl (the
    counterpart of the reference's ``xla`` training path: no kernel
    launches). Every loss finite, qwen3's last logged loss below its
    first, the peak device memory under the card's. Prints the median
    step after two warm-up steps, tokens/s (decoder tokens), the AdamW
    update's median (CUDA events), the fp32 logits' size (their gradient
    is as large) and, for granite, the MoE router's load-balance loss and
    dropped share. Returns {run: launches}."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    runs = {}
    total_gb = torch.cuda.get_device_properties(0).total_memory / 1e9
    jobs = [(argv, lambda argv=argv: (train.main(argv),
                                      train.parse_args(argv)))
            for argv in (TRAIN_QWEN_ARGV, TRAIN_GRANITE_ARGV,
                         TRAIN_MAMBA_ARGV, TRAIN_RG_ARGV)]
    jobs.append((None, lambda: _train_seamless(torch)))
    for argv, job in jobs:
        if argv is None:
            print(f"train phase: training.train on {SEAMLESS['name']}, "
                  f"{TRAIN_SEAMLESS} with 512 evidence frames a row")
        else:
            print("train phase: python -m repro_torch.launch.train " +
                  " ".join(argv))
        free_memory(torch)
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t0 = time.perf_counter()
        with timing_adamw(torch) as spans:
            hist, args = job()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        run = f"{args.arch} train"
        runs[run] = dict(ops.LAUNCHES)
        check(not any(runs[run].values()), f"{run}: kernels launched in "
              f"training: {runs[run]}")
        check(len(hist) == args.steps, f"{run}: {len(hist)} steps")
        losses = [h["loss"] for h in hist]
        check(all(math.isfinite(x) for x in losses), f"{run}: loss not "
              f"finite: {losses}")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        check(peak_gb < total_gb, f"{run}: peak {peak_gb:.1f} GB")
        step_s = statistics.median(h["seconds"] for h in hist[2:])
        adamw_ms = statistics.median(a.elapsed_time(b)
                                     for a, b in spans[2:])
        tokens = args.batch * args.seq
        logits_gb = tokens * get_config(args.arch).vocab_size * 4 / 1e9
        moe = ""
        if "moe_lb_loss" in hist[-1]:
            moe = (f"; moe_lb_loss {hist[0]['moe_lb_loss']:.4f} -> "
                   f"{hist[-1]['moe_lb_loss']:.4f}, moe_drop_frac "
                   f"{hist[0]['moe_drop_frac']:.4f} -> "
                   f"{hist[-1]['moe_drop_frac']:.4f}")
        print(f"train [{run}]: {args.steps} steps in {wall:.1f} s; loss "
              f"{losses[0]:.4f} -> {losses[-1]:.4f}, accuracy "
              f"{hist[0]['accuracy']:.3f} -> {hist[-1]['accuracy']:.3f}; "
              f"median step {step_s * 1e3:.1f} ms after two warm-up steps "
              f"({tokens / step_s:.0f} tokens/s), AdamW update "
              f"{adamw_ms:.2f} ms; fp32 logits {logits_gb:.2f} GB; peak "
              f"device memory {peak_gb:.1f} GB of the card's "
              f"{total_gb:.1f}{moe}  [{card}]")
        if args.arch == "qwen3-0.6b":
            check(losses[-1] < losses[0], f"{run}: loss did not fall "
                  f"({losses[0]:.4f} -> {losses[-1]:.4f})")
        del hist, spans
        free_memory(torch)
    return runs


@contextlib.contextmanager
def host_heap_kept():
    """While open, this process's allocator (glibc) serves large blocks
    from its heap and keeps what is freed there. By default it maps each
    block afresh and unmaps it on free, so every temporary of a
    full-width update on the host (2.6 GB for recurrentgemma-2b's tied
    table) page-faults anew, and the host side of ``train_check`` takes
    about twice as long. On leaving, the defaults come back and the kept
    memory is returned."""
    import ctypes
    libc = ctypes.CDLL("libc.so.6")
    set_ok = (libc.mallopt(M_MMAP_MAX, 0) == 1 and
              libc.mallopt(M_TRIM_THRESHOLD, 2 ** 31 - 1) == 1)
    print(f"host allocator: large blocks from the heap, kept "
          f"({'set' if set_ok else 'NOT set: mallopt refused'})")
    try:
        yield
    finally:
        for param, value in MALLOC_DEFAULTS.items():
            libc.mallopt(param, value)
        libc.malloc_trim(0)


def train_check(torch):
    """Full widths at reduced depth (``TRAIN_CHECK``): 2-layer qwen3-0.6b,
    granite-moe-3b-a800m and mamba2-780m, 3-layer recurrentgemma-2b (two
    RG-LRU layers and a local-attention one) and 2 + 2-layer
    seamless-m4t-large-v2 (with its 512 evidence frames a row): three
    ``training.train`` steps on the card against the same three on the
    host's CPU, from the same weights and batches; the loss and, for the
    MoE, its load-balance loss and dropped share agree within
    ``TRAIN_CHECK_RTOL`` at every step. Then a checkpoint round trip on
    the card: qwen3's trained weights saved, loaded into a fresh model,
    the same logits bit for bit. Returns {arch: max relative
    difference}."""
    from repro_torch.config import TrainConfig
    tc = TrainConfig(total_steps=TRAIN_CHECK_STEPS, warmup_steps=1,
                     learning_rate=1e-3)
    rels = {}
    with host_heap_kept():
        for arch, (over, batch, seq) in TRAIN_CHECK.items():
            rels[arch] = _train_check_arch(torch, tc, arch, over, batch, seq)
    return rels


def _train_check_arch(torch, tc, arch, over, batch, seq):
    """One entry of ``TRAIN_CHECK``; returns the max relative
    difference."""
    import copy
    import itertools
    from repro_torch.configs import get_config
    from repro_torch.data import lm_batches
    from repro_torch.models.model import build_model
    from repro_torch.training import train
    from repro_torch.training.train_loop import batch_to
    n = tc.total_steps
    cfg = get_config(arch).with_overrides(dtype="float32", **over)
    ev = None
    if cfg.is_encoder_decoder:
        ev = {"num_tokens": cfg.num_evidence_tokens,
              "dim": cfg.evidence_dim}
    data = list(itertools.islice(lm_batches(cfg.vocab_size, batch, seq,
                                            seed=0, evidence=ev), n))
    gpu = build_model(cfg, torch.float32, device="cuda", seed=0)
    # the same weights on the host, without the host drawing random
    # ones of its own first (~7 s for recurrentgemma's 0.85 B)
    cpu = copy.deepcopy(gpu).cpu()
    cpu.device = torch.device("cpu")
    t0 = time.perf_counter()
    hist = {name: train(model, tc, iter(data), steps=n, log_every=1)[2]
            for name, model in (("cuda", gpu), ("cpu", cpu))}
    keys = [k for k in TRAIN_CHECK_KEYS if k in hist["cpu"][0]]
    vals = {name: {k: [h[k] for h in hs] for k in keys}
            for name, hs in hist.items()}
    rel = max(abs(a - b) / max(abs(b), 1e-30)
              for k in keys
              for a, b in zip(vals["cuda"][k], vals["cpu"][k]))
    layers = "+".join(str(over[k]) for k in sorted(over, reverse=True))
    print(f"train check [{layers}-layer {arch}, B {batch}, L {seq}]: "
          f"card {vals['cuda']}, CPU {vals['cpu']}; max rel diff "
          f"{rel:.2e} (tol {TRAIN_CHECK_RTOL:g}); "
          f"{time.perf_counter() - t0:.1f} s")
    check(rel <= TRAIN_CHECK_RTOL, f"train check [{arch}]: card and "
          f"CPU {'/'.join(keys)} differ by {rel:.2e}")
    del cpu
    if arch == "qwen3-0.6b":
        checkpoint_check(torch, cfg, gpu, batch_to(data[0], "cuda"), n)
    del gpu
    free_memory(torch)
    return rel


def checkpoint_check(torch, cfg, trained, batch, steps):
    """Saves ``trained``'s weights, loads them into a model made from
    another seed, and holds the two models' logits equal bit for bit."""
    from repro_torch.models.model import build_model
    from repro_torch.training import load_checkpoint, save_checkpoint
    path = str(ROOT / "build" / "ckpt" / "qwen3-2l")
    t0 = time.perf_counter()
    save_checkpoint(path, trained.state_dict(), step=steps)
    fresh = build_model(cfg, torch.float32, device="cuda", seed=1)
    sd, step_n = load_checkpoint(path, fresh.state_dict())
    fresh.load_state_dict(sd)
    with torch.no_grad():
        same = torch.equal(trained.forward(batch["tokens"])[0],
                           fresh.forward(batch["tokens"])[0])
    for ext in (".npz", ".json"):
        Path(path + ext).unlink()
    print(f"checkpoint: {step_n} steps, {len(sd)} tensors saved and "
          f"loaded on the card in {time.perf_counter() - t0:.1f} s; "
          f"logits of the loaded model {'equal' if same else 'DIFFER'}")
    check(step_n == steps and same, "checkpoint round trip differs")


@contextlib.contextmanager
def recording_kernels(ops):
    """The inputs of the first call of each kernel wrapper while open
    (cloned), to hold each kernel against its plain version afterwards at
    the shapes the run gave it."""
    names = ("flash_attention", "xmodal_mean_sum", "xmodal_max_sum",
             "moe_dispatch", "moe_combine")
    saved = {name: getattr(ops, name) for name in names}
    seen = {}

    def recorded(name, fn):
        def call(*args, **kw):
            if name not in seen:
                seen[name] = ([a.clone() for a in args], dict(kw))
            return fn(*args, **kw)
        return call

    for name, fn in saved.items():
        setattr(ops, name, recorded(name, fn))
    try:
        yield seen
    finally:
        for name, fn in saved.items():
            setattr(ops, name, fn)


def rescore_phase(torch, ops, ref, card):
    """``core.rescore.camd_wrap`` at full width, fp32, a round of
    ``RESCORE`` candidates: llava-1.5-7b with the vision tower's 576 rows
    of one seeded image as evidence, granite-moe-3b-a800m without, and
    the encoder-decoder seamless-m4t-large-v2 with 512 seeded audio frames
    into its encoder (its decoder's logits carry no evidence offset). Each
    impl runs once with the launch counts set to 0 just before: ``torch``
    launches nothing; ``cuda`` launches K2 once a (decoder) layer, K4a and
    K4b once each (llava, seamless), K5a and K5b once a layer (granite);
    the encoder's and the cross attention run plain sdpa on both. Their
    scores and terms agree within ``RESCORE_TOL``, ``stop`` and
    ``best_uid`` are equal, ``p_star`` within ``RESCORE_P_STAR_ATOL``; so
    are the decisions of a second call of both impls at cluster threshold
    1.0, where every candidate is a cluster of its own (random weights
    leave the candidates' mean hidden states nearly parallel: one cluster
    at the default 0.85, p_star 1 on both). Each kernel's first
    call is held against its plain version on the same inputs; the
    teacher-forced forward is timed by CUDA events on both impls. Returns
    {run: launches of the cuda run}."""
    from repro_torch.config import CAMDConfig
    from repro_torch.configs import get_config
    from repro_torch.core import rescore
    from repro_torch.models.model import build_model
    r = RESCORE
    runs = {}
    camd, camd_split = CAMDConfig(), CAMDConfig(cluster_threshold=1.0)
    for arch in ("llava-1.5-7b", "granite-moe-3b-a800m", SEAMLESS["name"]):
        free_memory(torch)
        torch.cuda.reset_peak_memory_stats()
        cfg = get_config(arch).with_overrides(dtype="float32")
        model = build_model(cfg, torch.float32, device="cuda", seed=0)
        g = torch.Generator(device="cuda").manual_seed(7)
        V, L = cfg.vocab_size, cfg.num_layers
        prompt = torch.randint(2, V, (r["prompt"],), generator=g,
                               device="cuda", dtype=torch.int32)
        cands = torch.randint(2, V, (r["K"], r["cand"]), generator=g,
                              device="cuda", dtype=torch.int32)
        mask = torch.ones(r["K"], r["cand"], device="cuda")
        mask[-1, r["cand"] // 2:] = 0          # a shorter candidate
        evidence = None
        if model.has_vision_tower:
            v = cfg.vision
            image = torch.rand((1, v.image_h, v.image_w, v.channels),
                               generator=g, device="cuda")
            with torch.no_grad():
                evidence = model.encode_image(image)[0]
        elif cfg.is_encoder_decoder:
            evidence = torch.randn((cfg.num_evidence_tokens,
                                    cfg.evidence_dim), generator=g,
                                   device="cuda")
        dec, launches, clusters, split = {}, {}, {}, {}
        for impl in ("torch", "cuda"):
            ops.reset_launches()
            with recording_kernels(ops) as seen:
                state, dec[impl] = rescore.camd_wrap(
                    model, camd, prompt, cands, mask, evidence, impl=impl)
                torch.cuda.synchronize()
            launches[impl] = dict(ops.LAUNCHES)
            clusters[impl] = int(state.table.n_clusters[0])
            # every candidate a cluster of its own: p_star is the largest
            # posterior weight, a smooth function of the scores
            split[impl] = rescore.camd_wrap(model, camd_split, prompt, cands,
                                            mask, evidence, impl=impl)[1]
        run = f"{arch} rescore"
        runs[run] = launches["cuda"]
        check(not any(launches["torch"].values()),
              f"{run}: the torch impl launched {launches['torch']}")
        want = {"flash_attention": L}
        if evidence is not None:
            want.update(xmodal_score_mean=1, xmodal_score_max=1)
        if cfg.moe is not None:
            want.update(moe_dispatch=L, moe_combine=L)
        for name, n in launches["cuda"].items():
            check(n == want.get(name, 0), f"{run}: {name} launched {n} "
                  f"times, not {want.get(name, 0)}")
        a, b = dec["cuda"], dec["torch"]
        errs = {}
        for key in ("scores", "s_gen", "s_align", "s_coh"):
            x = a["scores"] if key == "scores" else a["terms"][key]
            y = b["scores"] if key == "scores" else b["terms"][key]
            check(bool(torch.isfinite(x).all()), f"{run}: {key} not finite")
            atol, rtol = RESCORE_TOL
            err = (x - y).abs()
            errs[key] = float(err.max())
            check(bool((err <= atol + rtol * y.abs()).all()),
                  f"{run}: {key} cuda vs torch {errs[key]:.3e}")
        dps = []
        for a_, b_ in ((a, b), (split["cuda"], split["torch"])):
            dps.append(abs(float(a_["p_star"]) - float(b_["p_star"])))
            check(bool(a_["stop"]) == bool(b_["stop"]) and
                  int(a_["best_uid"]) == int(b_["best_uid"]) and
                  dps[-1] <= RESCORE_P_STAR_ATOL,
                  f"{run}: decisions differ: stop {bool(a_['stop'])}/"
                  f"{bool(b_['stop'])}, best {int(a_['best_uid'])}/"
                  f"{int(b_['best_uid'])}, p_star diff {dps[-1]:.2e}")
        # each kernel's first call against its plain version
        for name, (args, kw) in seen.items():
            out = getattr(ops, name)(*args, **kw)
            exp = getattr(ref, name + "_ref")(*args, **kw)
            shape = "x".join(str(d) for d in args[
                -1 if name == "moe_combine" else 0].shape)
            if name == "moe_dispatch":
                check(torch.equal(out, exp), f"{run}: moe_dispatch differs "
                      "from its plain version")
                print(f"  {name:24s} {run} {shape}: bit for bit")
            else:
                compare(torch, name, f"{run} {shape}", out, exp, "float32")
        check(clusters["cuda"] == clusters["torch"],
              f"{run}: {clusters} clusters")
        hm = rescore.rescore_candidates(model, camd, prompt, cands, mask,
                                        evidence)["hidden_mean"]
        hm = hm / hm.norm(dim=-1, keepdim=True)
        cos = (hm @ hm.T)[~torch.eye(r["K"], dtype=torch.bool,
                                     device="cuda")]
        print(f"rescore [{arch}]: {clusters['cuda']} clusters at threshold "
              f"{camd.cluster_threshold}; candidates' mean hidden states "
              f"cos {float(cos.min()):.6f} .. {float(cos.max()):.6f}; a "
              f"cluster each (threshold 1.0): p_star "
              f"{float(split['cuda']['p_star']):.7f} (torch "
              f"{float(split['torch']['p_star']):.7f}, diff {dps[1]:.2e}), "
              f"best uid {int(split['cuda']['best_uid'])}")
        fwd = {}
        for impl in ("torch", "cuda"):
            fwd[impl] = wall_event_ms(torch, lambda: rescore.
                                      teacher_forced_stats(
                                          model, prompt, cands, mask,
                                          evidence, impl=impl), reps=3)[1]
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        print(f"rescore [{arch}, {L}L]: {r['K']} candidates x {r['cand']} "
              f"tokens after a {r['prompt']}-token prompt"
              + (f" and {evidence.shape[0]} evidence rows" if evidence
                 is not None else "") + "; "
              f"stop {bool(a['stop'])}, p_star {float(a['p_star']):.6f} "
              f"(torch {float(b['p_star']):.6f}), best uid "
              f"{int(a['best_uid'])}; cuda vs torch max err "
              + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()) +
              f"; teacher-forced forward {fwd['cuda']:.2f} ms (cuda) / "
              f"{fwd['torch']:.2f} ms (torch), CUDA events; peak "
              f"{peak_gb:.1f} GB; launches {launches['cuda']}  [{card}]")
        del model, evidence, dec
        free_memory(torch)
    return runs


def grad_guard_check(torch, ops):
    """No kernel has a backward: each kernel of the rescore path, called
    on the card with an input that requires grad under grad mode, raises
    and launches nothing."""
    g = torch.Generator(device="cuda").manual_seed(9)

    def rand(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    q, k, v = rand(1, 64, 4, 64), rand(1, 64, 2, 64), rand(1, 64, 2, 64)
    tok, vis, txt = rand(1, 8, 64), rand(1, 16, 64), rand(1, 4, 64)
    idx = torch.zeros((1, 2, 8), dtype=torch.int32, device="cuda")
    x = rand(1, 4, 64)
    slot = torch.zeros((1, 4, 2), dtype=torch.int32, device="cuda")
    gates, eo = rand(1, 4, 2), rand(1, 2, 8, 64)
    calls = {
        "flash_attention": lambda t: ops.flash_attention(t(q), k, v),
        "xmodal_score": lambda t: ops.xmodal_score(
            t(tok), torch.ones(1, 8, device="cuda"), vis, txt),
        "moe_dispatch": lambda t: ops.moe_dispatch(idx, t(x)),
        "moe_combine": lambda t: ops.moe_combine(slot, t(gates), eo),
    }
    ops.reset_launches()
    for name, call in calls.items():
        try:
            call(lambda t: t.detach().requires_grad_(True))
        except RuntimeError as e:
            check("requires grad" in str(e), f"{name}: {e}")
        else:
            fail(f"grad guard: {name} ran on an input that requires grad")
    check(not any(ops.LAUNCHES.values()), f"grad guard: launched "
          f"{ops.LAUNCHES}")
    print(f"grad guard: {', '.join(calls)} raise on inputs that require "
          "grad, with nothing launched")


# the CAMD core on the card against the CPU: elementwise values within
# fp32 ulps of each other's math library (atol, rtol), the expected
# improvement's cancelling tail within 1e-6 abs (|z| std ulps of erf near
# -1), the round's bias as rescoring holds it (2e-4 rel, 1e-4 abs)
CORE_TOL = (1e-5, 1e-5)
CORE_EI_TOL = (1e-6, 1e-3)
CORE_BIAS_TOL = (1e-4, 2e-4)
CORE_ROUND = dict(N=8, R=8, d=1024, V=4096)


def core_check(torch):
    """The §3.2 stop rules, two rounds of ``controller.round_update`` over
    ``CORE_ROUND`` requests, ``score_candidates`` and ``core.theory``'s
    functions on CUDA tensors against the same on the CPU: decisions,
    counters and cluster counts equal, values within ``CORE_TOL`` (the
    expected improvement ``CORE_EI_TOL``, the bias ``CORE_BIAS_TOL``); the
    samplers draw on the card from a CUDA generator, in [0, 1], with a
    two-sample Kolmogorov-Smirnov statistic against the CPU's draws under
    the level-1e-3 critical value."""
    from repro_torch.config import CAMDConfig
    from repro_torch.core import controller as ctrl
    from repro_torch.core import posterior, theory
    t0 = time.perf_counter()
    g = torch.Generator(device="cpu").manual_seed(21)
    errs = {}

    def same(name, a, b, tol=CORE_TOL):
        a, b = a.cpu(), b
        if a.dtype == torch.bool or not a.is_floating_point():
            check(torch.equal(a, b), f"core check: {name} differs")
            return
        atol, rtol = tol
        err = (a - b).abs()
        errs[name] = max(errs.get(name, 0.0), float(err.max()))
        check(bool((err <= atol + rtol * b.abs()).all()),
              f"core check: {name} card vs CPU {errs[name]:.3e}")

    def both(fn, *xs, **kw):
        return (fn(*(x.cuda() for x in xs), **kw), fn(*xs, **kw))

    def rand(*shape, lo=0.0, hi=1.0):
        return torch.rand(shape, generator=g) * (hi - lo) + lo

    best, prev = rand(4096), rand(4096)
    prev[::3] = best[::3]
    n = torch.randint(0, 4, (4096,), generator=g, dtype=torch.int32)
    (cs, cr), (hs, hr) = both(posterior.threshold_stop, best, prev, n,
                              tau=0.9, patience=3)
    same("threshold_stop", cs, hs)
    same("threshold rounds", cr, hr)
    trials = torch.randint(0, 40, (4096,), generator=g).float()
    succ = torch.floor(trials * rand(4096))
    (cs, cm), (hs, hm) = both(posterior.beta_bernoulli_stop, succ, trials,
                              delta=0.1)
    same("beta_bernoulli_stop", cs, hs)
    same("beta mean_fail", cm, hm)
    mean, std = rand(4096, lo=-2.0, hi=2.0), rand(4096, hi=1.5)
    toks = torch.randint(1, 200, (4096,), generator=g).float()
    (cs, ce), (hs, he) = both(posterior.expected_improvement_stop, best,
                              mean, std, toks, cost_per_token=1e-3)
    same("expected_improvement_stop", cs, hs)
    same("expected improvement", ce, he, CORE_EI_TOL)

    c = CORE_ROUND
    camd = CAMDConfig(max_clusters=8, min_samples=4, delta=0.3,
                      cluster_threshold=0.9)
    states = {dev: ctrl.init_state(camd, c["N"], c["d"], c["V"], device=dev)
              for dev in ("cuda", "cpu")}
    for rnd in range(2):
        centres = torch.randn((3, c["d"]), generator=g)
        pick = torch.randint(0, 2, (c["N"], c["R"]), generator=g)
        valid = torch.ones((c["N"], c["R"]), dtype=torch.bool)
        valid[-1, -1] = False
        inp = ctrl.RoundInputs(
            scores=torch.randn((c["N"], c["R"]), generator=g),
            embs=centres[pick] + 0.1 * torch.randn(
                (c["N"], c["R"], c["d"]), generator=g),
            token_counts=torch.randint(0, 3, (c["N"], c["R"], c["V"]),
                                       generator=g).float(),
            lengths=torch.randint(1, 64, (c["N"], c["R"]), generator=g,
                                  dtype=torch.int32),
            valid=valid,
            uids=torch.arange(c["N"] * c["R"], dtype=torch.int32).reshape(
                c["N"], c["R"]) + 100 * rnd)
        bias = {}
        for dev in ("cuda", "cpu"):
            states[dev], bias[dev] = ctrl.round_update(
                camd, states[dev],
                ctrl.RoundInputs(*(x.to(dev) for x in inp)))
        same("round bias", bias["cuda"], bias["cpu"], CORE_BIAS_TOL)
        for name in ("k_t", "rounds", "stopped", "best_uid",
                     "best_cluster", "tokens_spent", "p_star",
                     "best_score", "alpha"):
            same(f"round {name}", getattr(states["cuda"], name),
                 getattr(states["cpu"], name))
        same("round clusters", states["cuda"].table.n_clusters,
             states["cpu"].table.n_clusters)
    lp = -3 * rand(8, 32)
    mask = torch.ones(8, 32)
    feats = dict(hidden=torch.randn((8, 32, 256), generator=g),
                 token_embs=torch.randn((8, 32, 256), generator=g),
                 visual_feats=torch.randn((8, 64, 256), generator=g),
                 text_feats=torch.randn((8, 16, 256), generator=g))
    card_s = ctrl.score_candidates(camd, lp.cuda(), mask.cuda(), **{
        k: v.cuda() for k, v in feats.items()})
    same("score_candidates", card_s,
         ctrl.score_candidates(camd, lp, mask, **feats))

    s = rand(20000)
    Ks = torch.tensor([1, 2, 4, 8, 16, 32, 64])
    for fn in (theory.coverage, theory.residual_risk):
        same(fn.__name__, fn(Ks.cuda(), s.cuda()), fn(Ks, s))
    same("n_delta", theory.n_delta(s.cuda(), 0.05), theory.n_delta(s, 0.05))
    same("heavy_tail_rate", theory.heavy_tail_rate(Ks.cuda(), 0.5),
         theory.heavy_tail_rate(Ks, 0.5))
    deltas = theory.residual_risk(Ks, s)
    fits = [theory.fit_power_law(Ks.cuda(), deltas.cuda()),
            theory.fit_power_law(Ks, deltas)]
    check(fits[0] == fits[1], f"core check: fits differ {fits}")
    n_draw = 100_000
    ks_bound = math.sqrt(-math.log(1e-3 / 2) / 2) * math.sqrt(2 / n_draw)
    ks = {}
    for name in ("sample_heavy_tail", "sample_stretched_exp",
                 "sample_light_tail"):
        fn = getattr(theory, name)
        on_card = fn(torch.Generator(device="cuda").manual_seed(5), n_draw)
        on_cpu = fn(torch.Generator(device="cpu").manual_seed(5), n_draw,
                    device="cpu")
        check(on_card.device.type == "cuda" and on_card.shape == (n_draw,)
              and bool(((on_card >= 0) & (on_card <= 1)).all()),
              f"core check: {name} draws on the card")
        a, b = on_card.cpu().sort().values, on_cpu.sort().values
        x = torch.cat([a, b])
        ks[name] = float((torch.searchsorted(a, x, right=True) -
                          torch.searchsorted(b, x, right=True)).abs().max()
                         / n_draw)
        check(ks[name] < ks_bound, f"core check: {name} KS {ks[name]:.4f} "
              f">= {ks_bound:.4f}")
    torch.cuda.synchronize()
    print(f"core check: stop rules over 4096 inputs, two rounds of "
          f"round_update over {c['N']} requests x {c['R']} candidates, "
          f"score_candidates and the theory's functions, card against CPU; "
          f"max |diff| " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()
                                     if v) +
          "; samplers' KS against the CPU's draws " +
          ", ".join(f"{k} {v:.4f}" for k, v in ks.items()) +
          f" (bound {ks_bound:.4f}); {time.perf_counter() - t0:.2f} s")


# ---------------------------------------------------------------------------
# the timer's windows
# ---------------------------------------------------------------------------

TIMER_SESSIONS = 40


def _window_records(torch, prof, fn_key: str):
    """What one profiled window kept of its device records: the head's
    spinning kernels, the flushes, the kernels whose name holds
    ``fn_key`` (one record a call each) and the fewest records of one of
    them, hidden records, and the first record's start after the
    window's start (ms, None when the window kept nothing)."""
    cuda = torch.autograd.DeviceType.CUDA
    res = prof.profiler.kineto_results
    recs = [(e.start_ns(), e.name(),
             getattr(e, "is_hidden_event", lambda: False)())
            for e in res.events() if e.device_type() == cuda]
    calls: dict = {}
    for _, name, _ in recs:
        if fn_key in name:
            calls[name] = calls.get(name, 0) + 1
    return {"head": sum("sleep" in n or "spin" in n for _, n, _ in recs),
            "flush": sum("bitwise_not" in n for _, n, _ in recs),
            "call": min(calls.values(), default=0), "kinds": len(calls),
            "hidden": sum(h for _, _, h in recs),
            "lead": (min(t for t, _, _ in recs) - res.trace_start_ns()) / 1e6
            if recs else None}


def _one_pad_window(torch, timer, fn, reps: int):
    """A window of ``reps`` flushed calls opened by one spinning kernel of
    ~1 ms in place of the head records: time ahead of the calls, but one
    record. The profile, for ``_window_records``."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1 << 21)
        for _ in range(reps):
            timer._flush()
            fn()
        torch.cuda.synchronize()
    return prof


def timer_check(torch, ops, timer, when: str):
    """The timer's fault (the profiler lost records of K4a's kernels on
    three profiles in a row, failing a correct tree): K4a's timed call at
    llava's shape, ``TIMER_SESSIONS`` profiled windows of 20 flushed calls
    each way, in turns: with no head (as the timer did before,
    ``Timer._kernel_times(pad=False)``), behind one spinning kernel of
    ~1 ms (``_one_pad_window``), and the timer's way, behind
    ``HEAD_RECORDS`` spinning kernels of a few cycles; run ``when`` the
    process is fresh and again after every other phase, millions of
    profiled records later. Prints, for each way, the windows that lost a
    record of the calls (a flush or a K4a kernel), the fewest of the
    calls' records and of the head's that a window kept, the hidden
    records and the first record's start after the window's start. It
    asserts nothing: each timed call checks its own records
    (``Timer.device_ms``)."""
    g = torch.Generator(device="cuda").manual_seed(12)
    B, L, Nv, d = 1, SERVE["max_new"], IMAGE_TOKENS, 4096
    tok, vis = (torch.randn(B, n, d, generator=g, device="cuda")
                for n in (L, Nv))
    mask = torch.ones(B, L, device="cuda")
    fn = lambda: ops.xmodal_mean_sum(tok, mask, vis)   # noqa: E731
    for _ in range(3):
        fn()
    reps = 20
    ways = {"no head": lambda: timer._kernel_times(fn, reps, pad=False),
            "one 1 ms pad": lambda: setattr(timer, "prof", _one_pad_window(
                torch, timer, fn, reps)),
            "timer": lambda: timer._kernel_times(fn, reps)}
    seen = {way: [] for way in ways}
    for _ in range(TIMER_SESSIONS):
        for way, run in ways.items():
            run()
            seen[way].append(_window_records(torch, timer.prof,
                                             "xmodal_mean_kernel"))
    bad = {}
    for way, rows in seen.items():
        bad[way] = [r for r in rows if r["flush"] < reps or
                    r["call"] < reps or r["kinds"] < 2]
        leads = [r["lead"] for r in rows if r["lead"] is not None]
        print(f"timer check [{when}, {way}]: {len(bad[way])} of {len(rows)} "
              f"windows lost records of the calls (fewest kept: flush "
              f"{min(r['flush'] for r in rows)}, K4a "
              f"{min(r['call'] for r in rows)} of {reps}; head "
              f"{min(r['head'] for r in rows)}-{max(r['head'] for r in rows)}"
              f"); {sum(r['hidden'] for r in rows)} hidden records; first "
              f"record {min(leads, default=math.nan):.3f}-"
              f"{max(leads, default=math.nan):.3f} ms after the window's "
              "start")
    del tok, vis


# ---------------------------------------------------------------------------
# the encoder-decoder: seamless-m4t-large-v2
# ---------------------------------------------------------------------------

def seamless_attention_phase(torch, ops, ref, timer):
    """K2 and K3 at seamless-m4t-large-v2's decoder self-attention
    (``SEAMLESS``: 16 query heads over 16 kv heads of width 64), fp32,
    each against its plain version and twice for the same bits: K2 at the
    served one-row prefill (B 1, L 256, no key lengths: the
    encoder-decoder prefills a request alone, with no bucket) and a
    ragged L 77; K3 at the served decode (B 8, S 288, a ring mask), at
    S 16 (one split) and at a row with no valid key. Then timed: K2 at
    the served prefill beside SDPA and its bounds, K3 at the served
    decode (``decode_timing``). Returns ({kernel: {entry: times}},
    {kernel: max_abs_err})."""
    F = torch.nn.functional
    g = torch.Generator(device="cuda").manual_seed(13)
    H, Hkv, hd = (SEAMLESS[k] for k in ("H", "Hkv", "hd"))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    errs = {"flash_attention": [], "decode_attention": []}
    for L in (SERVE["prompt"], 77):
        q, k, v = (torch.randn(1, L, h, hd, generator=g, device="cuda")
                   for h in (H, Hkv, Hkv))
        case = f"float32 B1 L{L} H{H}/{Hkv} hd{hd} causal"
        out = ops.flash_attention(q, k, v)
        errs["flash_attention"].append(compare(
            torch, "flash_attention", case, out,
            ref.flash_attention_ref(q, k, v), "float32"))
        check(torch.equal(out, ops.flash_attention(q, k, v)),
              f"flash_attention {case}: two runs differ")
    plans = set()
    for B, S, kind in ((8, CACHE_LEN, "ring"), (8, 16, "ring"),
                       (3, CACHE_LEN, "empty row")):
        q, k, v = (torch.randn(B, n_, h, hd, generator=g, device="cuda")
                   for n_, h in ((1, H), (S, Hkv), (S, Hkv)))
        pos = torch.randint(0, S, (B,), generator=g, device="cuda")
        mask = ring_mask(torch, pos, S)
        if kind == "empty row":
            mask[1] = False
        n_split, rows = ops.decode_splits(B, Hkv, S, sms)
        plans.add(n_split > 1)
        case = f"float32 B{B} S{S} H{H}/{Hkv} hd{hd} {kind} " \
            f"{n_split}x{rows}"
        out = ops.decode_attention(q, k, v, mask)
        errs["decode_attention"].append(compare(
            torch, "decode_attention", case, out,
            ref.decode_attention_ref(q, k, v, mask), "float32"))
        check(torch.equal(out, ops.decode_attention(q, k, v, mask)),
              f"decode_attention {case}: two runs differ")
    check(plans == {False, True},
          "decode_attention: the seamless cases must take one split and "
          "several")
    timed = {"flash_attention": {}, "decode_attention": {}}
    L = SERVE["prompt"]
    q, k, v = (torch.randn(1, L, h, hd, generator=g, device="cuda")
               for h in (H, Hkv, Hkv))
    shape = f"fp32 B1 L{L} H{H} Hkv{Hkv} hd{hd} causal"
    errs["flash_attention"].append(compare(
        torch, "flash_attention", f"{shape} (timed)",
        ops.flash_attention(q, k, v), ref.flash_attention_ref(q, k, v),
        "float32"))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    t = times(timer, lambda: ops.flash_attention(q, k, v), "flash_kernel",
              lambda: ref.flash_attention_ref(q, k, v),
              lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                     is_causal=True))
    t["bound_ms"], t["bound_by"], b = flash_bounds(1, L, H, Hkv, hd)
    t.update({f"bound_{k_}_ms": val for k_, val in b.items()})
    t["shape"] = shape
    print(f"  flash_attention {SEAMLESS['name']}: kernel {t['ms']:.4f} ms "
          f"(call {t['call_ms']:.4f}), plain {t['plain_ms']:.4f}, SDPA "
          f"{t['library_ms']:.4f}; bounds: bytes {b['bytes']:.5f}, fp32 "
          f"SIMT {b['simt']:.5f}, 3xTF32 {b['tf32x3']:.5f} ms ({shape})")
    timed["flash_attention"][SEAMLESS["name"]] = {
        k_: t[k_] for k_ in SUB_KEYS + TF32_BOUNDS}
    del q, k, v, qt, kt, vt
    t, err = decode_timing(torch, ops, ref, timer, g, CACHE_LEN, H=H,
                           Hkv=Hkv, hd=hd)
    errs["decode_attention"].append(err)
    timed["decode_attention"][SEAMLESS["name"]] = {
        k_: t[k_] for k_ in SUB_KEYS + ("by_kernel",)}
    return timed, {k_: max(v_) for k_, v_ in errs.items()}


def seamless_argv(impl="cuda", extra=()):
    """The serve phases' shapes (8 slots, 8 requests of 256 prompt tokens
    and 512 random audio frames, 32 new tokens, CAMD, K 8) through
    ``--impl cuda`` (an encoder-decoder has no layer to page) with
    cross-modal rescoring, the 8 requests arriving at once through the
    front-end (``--open-loop`` at 1000 requests/s), which times their
    first tokens. The ring holds prompt and new tokens (288): the frames
    are the encoder's."""
    return with_arg(serve_argv(SEAMLESS["name"], CACHE_LEN, SEAMLESS["eos"],
                               ("--xmodal-rescore",)), "--impl", impl) + [
        "--open-loop", "--arrival", "poisson", "--arrival-rate", "1000",
        *extra]


def seamless_step_bytes(eng):
    """Bytes one decode step of all slots must move at least: the decoder's
    weights a step reads once (self-attention, the cross-attention's
    ``wq``/``wo``, MLP, norms, the final norm and the untied unembedding;
    not the cross ``wk``/``wv``, whose K/V sit in the cache, nor the
    encoder's), each slot's token embedding, every slot's cross K/V, and
    the self-attention rings up to the mean position of a request's
    decode (prompt + max_new / 2). Returns (total, weights, cross, ring)."""
    m, cache = eng.model, eng.state.cache
    weights = sum(p.numel() * p.element_size()
                  for n, p in m.named_parameters()
                  if n.startswith(("dec_layers.", "final_norm.", "unembed."))
                  and ".xattn.wk." not in n and ".xattn.wv." not in n)
    weights += eng.B * m.embed.table.shape[1] * m.embed.table.element_size()
    cross = sum(cache[k].numel() * cache[k].element_size()
                for k in ("cross_k", "cross_v"))
    n, B, S, Hkv, hd = cache["k"].shape
    live = min(S, SERVE["prompt"] + SERVE["max_new"] // 2)
    ring = 2 * n * B * live * Hkv * hd * cache["k"].element_size()
    return weights + cross + ring, weights, cross, ring


def seamless_dense_check(torch, ops, serve):
    """At 4 encoder and 4 decoder layers, full widths, fp32: greedy streams
    of the plain (torch, K 8), kernel (cuda, K 8, the captured graph) and
    kernel legacy-loop (cuda, K 0) engines agree; the kernel runs launch
    K2 once a decoder layer a prefill forward and K3 once a decoder layer
    a step, nothing else; ``--impl paged_cuda`` is refused (no layer to
    page). Returns the kernel graph run's launches."""
    name, n = SEAMLESS["name"], SEAMLESS_DENSE_LAYERS
    argv = ["--arch", name, "--no-reduced", "--num-layers", str(n),
            "--mode", "greedy", "--requests", "4", "--prompt-len", "64",
            "--max-new", "16", "--cache-len", "96", "--eos-id",
            str(SEAMLESS["eos"]), "--device", "cuda", "--seed", "1"]
    streams, launches = {}, {}
    for impl, K in (("torch", 8), ("cuda", 8), ("cuda", 0)):
        ops.reset_launches()
        with counting_prefills(torch) as (forwards, _):
            out = serve.main(argv + ["--impl", impl, "--macro-steps",
                                     str(K)])
        torch.cuda.synchronize()
        eng = out["engine"]
        got = dict(ops.LAUNCHES)
        want = {k_: 0 for k_ in got}
        if impl == "cuda":
            want["flash_attention"] = n * forwards["prefill"]
            want["decode_attention"] = n * eng.total_steps if K == 0 else \
                n * eng.macro_launches * eng.macro_steps
        check(got == want and eng._graphs_captured == (K > 0) and
              forwards["prefill"] == eng.prefill_calls == 4,
              f"seamless dense check: {impl} K {K}: launches {got}, not "
              f"{want}; {eng._graphs_captured} graphs, "
              f"{forwards['prefill']} prefill forwards")
        launches[impl, K] = got
        streams[impl, K] = [r.tokens.tolist() for r in
                            sorted(out["results"], key=lambda r: r.uid)]
        del out, eng
        free_memory(torch)
    for key in (("cuda", 8), ("cuda", 0)):
        check(streams[key] == streams["torch", 8],
              f"seamless dense check: {key} greedy streams differ from "
              f"torch's: {streams[key]} vs {streams['torch', 8]}")
    try:
        serve.main(argv + ["--impl", "paged_cuda"])
    except ValueError as e:
        check("pageable" in str(e), f"seamless dense check: paged_cuda "
              f"raised {e!r}")
        print(f"seamless dense check: --impl paged_cuda refused: {e}")
    else:
        check(False, "seamless dense check: --impl paged_cuda served")
    free_memory(torch)
    print(f"seamless dense check: greedy streams of torch (K 8), cuda (K 8, "
          f"graph) and cuda (K 0) agree ({sum(map(len, streams['torch', 8]))}"
          f" tokens, {n} + {n} layers); cuda launches {launches['cuda', 8]}")
    return launches["cuda", 8]


def seamless_serve_phase(torch, ops, serve, timer, card):
    """seamless-m4t-large-v2 served at full width (24 encoder and 24
    decoder layers, d 1024, vocabulary 256206, 512 frames) in fp32 through
    the serve entry point (``seamless_argv``), launch counts set to 0 just
    before and read just after: K2 once a decoder layer a prefill forward
    (one a request), K3 once a decoder layer a step of every replay, K4a
    and K4b once a rescored candidate, nothing else. One graph; every
    request resolved, every candidate rescored with a finite S_align; the
    prefill counts the prompts' tokens only. Prints tokens/s, TTFT, peak
    memory, the graph's capture and a replay's device time a step against
    the byte bound of one step. Returns (launches, seconds)."""
    t0 = time.perf_counter()
    name = SEAMLESS["name"]
    argv = seamless_argv()
    print(f"encoder-decoder phase [{name}]: python -m "
          "repro_torch.launch.serve " + " ".join(argv))
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    with counting_prefills(torch) as (forwards, _):
        out = serve.main(argv)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    eng, m, results = out["engine"], out["metrics"], out["results"]
    cfg = eng.cfg
    check((cfg.num_layers, cfg.num_encoder_layers, cfg.d_model,
           cfg.vocab_size, cfg.num_evidence_tokens) ==
          (SEAMLESS["layers"], SEAMLESS["layers"], SEAMLESS["d"], 256206,
           SEAMLESS["frames"]), f"{name}: not at full width: {cfg}")
    check(len(results) == SERVE["requests"] and
          m["completed"] == SERVE["requests"],
          f"{name}: unresolved requests: {m}")
    rescored = 0
    for r in results:
        check(r.n_candidates > 0 and 0 < len(r.tokens) <= SERVE["max_new"]
              and all(0 <= int(t_) < eng.V for t_ in r.tokens) and
              math.isfinite(r.best_score),
              f"{name}: request {r.uid} has no usable candidate")
        check(all(math.isfinite(c.get("s_align_xmodal", math.nan))
                  for c in r.candidates),
              f"{name}: request {r.uid} has a candidate not rescored")
        rescored += len(r.candidates)
    check(eng._graphs_captured == 1 and eng.macro_launches > 0,
          f"{name}: {eng._graphs_captured} graphs captured")
    L = cfg.num_layers
    want = {k_: 0 for k_ in launches}
    want["flash_attention"] = L * forwards["prefill"]
    want["decode_attention"] = L * eng.macro_launches * eng.macro_steps
    want["xmodal_score_mean"] = want["xmodal_score_max"] = rescored
    check(launches == want, f"{name}: launches {launches}, not {want} ({L} "
          f"decoder layers, {forwards['prefill']} prefill forwards, "
          f"{eng.macro_launches} replays of {eng.macro_steps}, {rescored} "
          "rescored candidates)")
    check(forwards["prefill"] == eng.prefill_calls == SERVE["requests"] and
          eng.prefill_tokens == SERVE["requests"] * SERVE["prompt"],
          f"{name}: {forwards['prefill']} prefill forwards over "
          f"{eng.prefill_tokens} tokens")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"encoder-decoder [{name}]: {out['tokens_per_s']:.1f} tok/s "
          f"({eng.total_tokens} tokens in {out['seconds']:.2f} s, "
          f"{eng.total_steps} decode steps, {eng.macro_launches} launches, "
          f"{eng.prefill_calls} prefills, {rescored} candidates rescored); "
          f"TTFT p50 {m['ttft_p50_ms']:.1f} ms, p99 {m['ttft_p99_ms']:.1f} "
          f"ms; peak device memory {peak_gb:.2f} GB; launches {launches} "
          f"[{card}]")
    rows = graph_phase(torch, name, out, timer)
    K = eng.macro_steps
    total, weights, cross, ring = seamless_step_bytes(eng)
    bound = total / PEAK_BYTES_PER_S * 1e3
    busy = rows["replay"][2] / K
    print(f"encoder-decoder [{name}]: graph captured in {eng._capture_s:.3f}"
          f" s; a replay's device time {busy:.4f} ms a step against the "
          f"byte bound {bound:.4f} ms ({weights / 1e9:.3f} GB of decoder "
          f"weights, {cross / 1e9:.3f} GB of {eng.B} slots' cross K/V, "
          f"{ring / 1e9:.3f} GB of rings; {bound / busy:.3f} of the bound) "
          f"[{card}]")
    del out, eng
    check_released(torch, f"{name} serve")
    return launches, time.perf_counter() - t0


def encdec_phase(torch, ops, serve, timer, card):
    """seamless-m4t-large-v2: its 4 + 4-layer dense check, then its
    full-width serve. Returns {run: launches}."""
    name = SEAMLESS["name"]
    runs = {}
    stamp(f"{name} dense check")
    runs[f"{name} dense check"] = seamless_dense_check(torch, ops, serve)
    stamp(f"{name} serve")
    runs[f"{name} serve"], secs = seamless_serve_phase(
        torch, ops, serve, timer, card)
    print(f"{name} serve: {secs:.1f} s")
    return runs


def main() -> None:
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        fail("run from the root of a checkout: src/repro_torch not found")
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")

    from repro_torch.kernels import build, ops, ref
    from repro_torch.launch import serve
    from repro_torch.models.attention import kv_quantize

    t0 = time.perf_counter()
    # training launches no kernel, so the card-against-CPU training check
    # (mostly the host's full-width updates) runs while nvcc builds
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        building = pool.submit(build.build_all)
        stamp("training check, while the kernels build")
        train_check(torch)
        info = building.result()
    print(f"kernel build: {time.perf_counter() - t0:.1f}s wall, parallel, "
          "beside the training check")
    for name, rec in info.items():
        log = str(rec["log"])
        regs = [int(x) for x in re.findall(r"Used (\d+) registers", log)]
        stack = [int(x) for x in re.findall(r"(\d+) bytes stack frame", log)]
        spills = [int(x) for x in re.findall(r"(\d+) bytes spill stores",
                                             log)]
        print(f"  {name}: nvcc {rec['seconds']:.1f}s; {len(regs)} kernels, "
              f"registers {min(regs, default=0)}-{max(regs, default=0)}, "
              f"stack <= {max(stack, default=0)} bytes, spill stores "
              f"{sum(spills)} bytes")
        build.load(name)
    for src in ("flash_attention", "xmodal_score"):
        hmma = sass_count(build.lib_path(src), "HMMA")
        print(f"  {src}: {hmma} HMMA (tensor-core) instructions in its SASS")
        check(hmma > 0, f"{src}: no tensor-core instruction in SASS")

    timer = Timer(torch)
    timer_check(torch, ops, timer, "first")
    print("kernel phase:")
    timings = {"flash_attention": flash_phase(torch, ops, ref, timer),
               "decode_attention": decode_phase(torch, ops, ref, timer),
               "paged_decode_attention": paged_phase(torch, ops, ref, timer,
                                                     kv_quantize),
               **xmodal_phase(torch, ops, ref, timer),
               **moe_phase(torch, ops, ref, timer)}
    for entries, errs in (any_g_phase(torch, ops, ref, timer, kv_quantize),
                          hd256_phase(torch, ops, ref, timer),
                          seamless_attention_phase(torch, ops, ref, timer),
                          rank_shape_phase(torch, ops, ref, timer)):
        for name, by_key in entries.items():
            timings[name].update(by_key)
            timings[name]["max_abs_err"] = max(timings[name]["max_abs_err"],
                                               errs[name])
    print(f"kernel phase: {time.perf_counter() - t0:.1f} s since the build "
          "began")
    for name, t in timings.items():
        lib = "null" if t["library_ms"] is None else f"{t['library_ms']:.4f}"
        print(f"  {name}: {t['shape']}: kernel {t['ms']:.4f} ms (call "
              f"{t['call_ms']:.4f} ms), plain "
              f"{t['plain_ms']:.4f} ms, library {lib} ms, bound "
              f"{t['bound_ms']:.4f} ms ({t['bound_by']})")
        if "floor_ms" in t:
            print(f"  {name}: L2 warm {t['warm_ms']:.5f} ms; an empty "
                  f"kernel {t['floor_ms']:.5f} ms (the floor)")
        for key in ("prefill", "verify", "long", "llava", "granite", "int8",
                    "fp8") + NEW_ENTRIES:
            if key not in t:
                continue
            tp = t[key]
            lib = "null" if tp["library_ms"] is None else \
                f"{tp['library_ms']:.4f}"
            print(f"  {name}: {tp['shape']}: kernel {tp['ms']:.4f} ms "
                  f"(call {tp['call_ms']:.4f} ms), plain "
                  f"{tp['plain_ms']:.4f} ms, library {lib} ms, bound "
                  f"{tp['bound_ms']:.4f} ms ({tp['bound_by']})")

    stamp("qwen3-0.6b")
    # qwen3-0.6b, text requests
    runs = {}
    runs["qwen3-0.6b serve"], out = serve_phase(
        torch, ops, serve, QWEN_ARGV,
        ("flash_attention", "paged_decode_attention"))
    graph_phase(torch, "qwen3-0.6b", out, timer)
    fp32_bpp = out["engine"].kv_stats()["bytes_per_page"]
    qwen_tps = out["tokens_per_s"]
    stamp("mesh serving")
    # mesh serving on 2 and 4 logical data shards, the same weights
    mesh_serves = tuple(mesh_phase(torch, ops, serve, out["engine"].model,
                                   card).items())
    runs.update(mesh_serves)
    stamp("serving over ranks")
    # one NCCL rank for qwen3-0.6b, then for full-width llava-1.5-7b image
    # requests with K4 rescoring, for full-width granite-moe and for
    # full-width recurrentgemma-2b (with the one-process runs of it and of
    # mamba2-780m the gloo ranks are held to); then the five models' gloo
    # runs on the card, in one torchrun of four worker processes started
    # now, its start beside the in-process runs
    launch = start_gloo_ranks(gloo_spec())
    try:
        rank_runs, rank_pending = ranks_phase(torch, ops, serve,
                                              out["engine"].model, card)
        runs.update(rank_runs)
        del out
        check_released(torch, "qwen3-0.6b serve")
        stamp("vlm over ranks")
        vlm_runs, vlm_pending = vlm_ranks_phase(torch, ops, serve, card)
        runs.update(vlm_runs)
        stamp("moe over ranks")
        moe_runs, moe_pending = moe_ranks_phase(torch, ops, serve, card)
        runs.update(moe_runs)
        stamp("recurrent and hybrid over ranks")
        rec_runs, rec_pending = recurrent_ranks_phase(torch, ops, serve,
                                                      card)
        runs.update(rec_runs)
        stamp("gloo ranks")
        records = gloo_ranks(launch)
    finally:
        stop_gloo_ranks(launch)
    gloo_runs, rank_paged, rank_dense = ranks_check(
        torch, serve, rank_pending, records, card)
    runs.update(gloo_runs)
    gloo_runs, vlm_rank_runs = vlm_ranks_check(torch, serve, vlm_pending,
                                               records, card)
    runs.update(gloo_runs)
    vlm_runs = tuple(vlm_runs) + vlm_rank_runs
    gloo_runs, moe_rank_runs = moe_ranks_check(torch, serve, moe_pending,
                                               records, card)
    runs.update(gloo_runs)
    runs.update(shard_map_check(records, card))
    moe_runs = tuple(moe_runs) + moe_rank_runs
    gloo_runs, rg_rank_runs = recurrent_ranks_check(
        torch, serve, rec_pending, records, card)
    runs.update(gloo_runs)
    # recurrentgemma-2b's runs over ranks, in process and on every gloo
    # rank: K2 and K3 in its local layers
    rg_rank_runs = tuple(r for r in rec_runs
                         if r.startswith("recurrentgemma-2b")) + rg_rank_runs
    check_released(torch, "ranks")
    profile_phase(torch, ops, serve, QWEN_ARGV, timer)
    free_memory(torch)
    runs["qwen3-0.6b dense check"] = dense_check(
        torch, ops, serve, QWEN_DENSE_ARGV,
        ("flash_attention", "decode_attention"))
    free_memory(torch)
    stamp("llava-1.5-7b")
    # llava-1.5-7b, image requests
    runs["llava-1.5-7b serve"], out = serve_phase(
        torch, ops, serve, LLAVA_ARGV, LLAVA_KERNELS)
    image_checks(torch, serve, LLAVA_ARGV, out)
    llava_prefill_tokens = out["engine"].prefill_tokens
    llava_tps = out["tokens_per_s"]
    graph_phase(torch, "llava-1.5-7b", out, timer)
    image_prefill_timing(torch, out, timer)
    del out
    check_released(torch, "llava-1.5-7b serve")
    profile_phase(torch, ops, serve, LLAVA_ARGV, timer)
    free_memory(torch)
    runs["llava-1.5-7b dense check"] = dense_check(
        torch, ops, serve, LLAVA_DENSE_ARGV,
        ("flash_attention", "decode_attention", "xmodal_score_mean",
         "xmodal_score_max"))
    free_memory(torch)
    stamp("llava-1.5-7b prefix cache and chunks")
    # llava-1.5-7b with the prefix cache (repeated images hit), and with
    # chunked prefill (the first chunk carries the image span)
    new_runs = ("llava-1.5-7b serve prefix cache", "llava-1.5-7b serve chunked",
                "qwen3-0.6b serve chunked")
    runs[new_runs[0]], out = prefix_phase(torch, ops, serve,
                                          llava_prefill_tokens)
    del out
    check_released(torch, new_runs[0])
    runs[new_runs[1]], out = chunk_phase(
        torch, ops, serve, with_arg(LLAVA_ARGV, "--requests", 4) +
        ["--prefill-chunk", "640"], LLAVA_KERNELS, 640)
    del out
    check_released(torch, new_runs[1])
    feature_check(torch, ops, serve, LLAVA_DENSE_ARGV, ["--prefix-cache"],
                  ("paged", "paged_cuda"), 1)
    free_memory(torch)
    stamp("granite-moe-3b-a800m")
    # granite-moe-3b-a800m, text requests through the MoE layers
    runs["granite-moe-3b-a800m serve"], out = serve_phase(
        torch, ops, serve, GRANITE_ARGV,
        ("flash_attention", "paged_decode_attention", "moe_dispatch",
         "moe_combine"))
    moe_launch_checks(out, runs["granite-moe-3b-a800m serve"])
    granite_tps = out["tokens_per_s"]
    graph_phase(torch, "granite-moe-3b-a800m", out, timer)
    granite_timing(torch, out, timer)
    del out
    check_released(torch, "granite-moe-3b-a800m serve")
    profile_phase(torch, ops, serve, GRANITE_ARGV, timer)
    free_memory(torch)
    runs["granite-moe-3b-a800m dense check"] = dense_check(
        torch, ops, serve, GRANITE_DENSE_ARGV,
        ("flash_attention", "decode_attention", "moe_dispatch",
         "moe_combine"))
    free_memory(torch)
    stamp("qwen3-0.6b int8/fp8")
    # qwen3-0.6b from int8 and fp8 KV pools, through K1's dequant path
    quant = []
    for kv_dtype in ("int8", "fp8"):
        run = f"qwen3-0.6b serve {kv_dtype}"
        quant.append(run)
        runs[run], out = serve_phase(
            torch, ops, serve, QWEN_ARGV + ["--kv-dtype", kv_dtype],
            ("flash_attention", "paged_decode_attention"))
        graph_phase(torch, f"qwen3-0.6b {kv_dtype}", out, timer)
        bpp = out["engine"].kv_stats()["bytes_per_page"]
        print(f"kv pool [{kv_dtype}]: {bpp} bytes a page against fp32's "
              f"{fp32_bpp} ({bpp / fp32_bpp:.4f})")
        del out
        check_released(torch, run)
        quant_dense_check(torch, ops, serve, QWEN_DENSE_ARGV, kv_dtype)
    stamp("qwen3-0.6b chunked")
    # qwen3-0.6b with chunked prefill: 256-token prompts in chunks of 64,
    # at most 128 chunk tokens between two decode launches
    runs[new_runs[2]], out = chunk_phase(
        torch, ops, serve, QWEN_ARGV + ["--prefill-chunk", "64",
                                        "--prefill-chunk-budget", "128"],
        TEXT_KERNELS, 64, qwen_tps)
    del out
    check_released(torch, new_runs[2])
    feature_check(torch, ops, serve, QWEN_DENSE_ARGV,
                  ["--prefix-cache", "--prefill-chunk", "16"],
                  ("paged", "paged_cuda"), 2)

    stamp("speculative")
    # speculative decoding: n-gram drafts of 3 tokens verified in one block
    # forward an iteration, inside the engine's one captured graph; the
    # verify runs plain sdpa on the gathered pages, as the reference's, so
    # the paged decode kernel leaves the decode path
    spec = ["--spec-k", "4"]
    spec_runs = ("qwen3-0.6b serve spec", "llava-1.5-7b serve spec",
                 "granite-moe-3b-a800m serve spec")
    for run, argv, kernels, plain_tps in (
            (spec_runs[0], QWEN_ARGV, ("flash_attention",), qwen_tps),
            (spec_runs[1], LLAVA_ARGV, ("flash_attention", "xmodal_score_mean",
                                        "xmodal_score_max"), llava_tps),
            (spec_runs[2], GRANITE_ARGV, ("flash_attention", "moe_dispatch",
                                          "moe_combine"), granite_tps)):
        runs[run], out = serve_phase(torch, ops, serve, argv + spec, kernels)
        if "moe_dispatch" in kernels:
            moe_launch_checks(out, runs[run])
        if "xmodal_score_max" in kernels:
            image_checks(torch, serve, argv + spec, out)
        spec_report(run, out, plain_tps)
        graph_phase(torch, run.replace(" serve", ""), out, timer)
        del out
        check_released(torch, run)
    for argv, label in ((QWEN_DENSE_ARGV, None),
                        (QWEN_DENSE_ARGV + ["--kv-dtype", "int8"],
                         "qwen3-0.6b int8"),
                        (LLAVA_DENSE_ARGV, None)):
        feature_check(torch, ops, serve, argv, spec, ("paged", "paged_cuda"),
                      1, label)
        free_memory(torch)

    stamp("open loop")
    # open-loop serving: requests arrive on their own clock, stream their
    # tokens and some cancel, through the async front-end
    t0 = time.perf_counter()
    open_runs, summary = open_loop_phase(torch, ops, serve, card)
    runs.update(open_runs)
    check_released(torch, "qwen3-0.6b open loop")
    runs["qwen3-0.6b open loop camd"] = camd_open_loop_phase(
        torch, ops, serve, summary)
    check_released(torch, "qwen3-0.6b open loop camd")
    cancel_check(torch, ops, serve)
    print(f"open-loop phases: {time.perf_counter() - t0:.1f} s")

    stamp("remaining configs")
    # the remaining attention-only configs: internvl2-2b (fp32, images),
    # qwen2.5-32b, yi-34b and granite-34b (bf16) at published widths
    t0 = time.perf_counter()
    new_cfg_runs = remaining_configs_phase(torch, ops, serve, timer)
    runs.update(new_cfg_runs)
    print(f"remaining-config phases: {time.perf_counter() - t0:.1f} s")
    new_serves = tuple(r for r in new_cfg_runs if r.endswith(" serve"))
    new_dense = tuple(r for r in new_cfg_runs if r.endswith("dense check"))

    stamp("recurrent and hybrid")
    # mamba2-780m (SSD, no kernel on its path) and recurrentgemma-2b (K2
    # and K3 at head_dim 256 in its local layers) through the state arena
    t0 = time.perf_counter()
    runs.update(recurrent_phase(torch, ops, serve, timer, card))
    print(f"recurrent phases: {time.perf_counter() - t0:.1f} s")
    rg_runs = ("recurrentgemma-2b serve", "recurrentgemma-2b dense check")

    stamp("encoder-decoder")
    # seamless-m4t-large-v2: 512 audio frames into its encoder, K2 and K3
    # in its decoder's self-attention, K4 rescoring against the frames
    t0 = time.perf_counter()
    runs.update(encdec_phase(torch, ops, serve, timer, card))
    print(f"encoder-decoder phases: {time.perf_counter() - t0:.1f} s")
    ed_runs = (f"{SEAMLESS['name']} serve", f"{SEAMLESS['name']} dense check")

    stamp("training")
    # training at full width on the plain impl (the recurrent, hybrid and
    # encoder-decoder models too; the card against the CPU at 2-3 layers
    # and the checkpoint round trip ran beside the build); then
    # plug-and-play rescoring through K2, K4
    # and K5 (seamless: K2 and K4); kernels refuse inputs that require
    # grad; the CAMD core's stop rules, round update and theory on the
    # card against the CPU
    t0 = time.perf_counter()
    free_memory(torch)
    train_runs = train_phase(torch, ops, card)
    stamp("rescoring")
    rescore_runs = rescore_phase(torch, ops, ref, card)
    runs.update(rescore_runs)
    grad_guard_check(torch, ops)
    core_check(torch)
    launched = sum(sum(r.values()) for r in train_runs.values())
    print(f"training and rescoring phases: {time.perf_counter() - t0:.1f} s "
          f"(training launched {launched} kernels)")

    timer_check(torch, ops, timer, "last")
    stamp("launches")
    # launches: the serve phases for the kernels the serving path runs,
    # the dense checks for the dense decode kernel (K3), which only the
    # dense impls run
    paths = {"decode_attention": ("qwen3-0.6b dense check",
                                  "llava-1.5-7b dense check",
                                  "granite-moe-3b-a800m dense check") +
             new_dense + rg_runs + ed_runs}
    serves = ("qwen3-0.6b serve", "llava-1.5-7b serve",
              "granite-moe-3b-a800m serve")
    # the quantized pools', the prefix cache's, the chunked and the
    # speculative serve runs go through the prefill and paged decode
    # kernels too (the speculative ones launch the latter 0 times)
    paths.update({name: serves + tuple(quant) + new_runs + spec_runs +
                  tuple(open_runs) + ("qwen3-0.6b open loop camd",) +
                  new_serves + tuple(run for run, _ in mesh_serves) +
                  ("qwen3-0.6b ranks one process", "qwen3-0.6b ranks (a)") +
                  rank_paged + tuple(vlm_runs) + moe_runs
                  for name in ("flash_attention", "paged_decode_attention")})
    paths["decode_attention"] += ("qwen3-0.6b ranks (d0)",) + rank_dense + \
        rg_rank_runs
    paths["flash_attention"] += tuple(rescore_runs) + rg_runs + ed_runs + \
        ("qwen3-0.6b ranks (d0)",) + rank_dense + rg_rank_runs
    paths.update({name: serves + spec_runs[1:2] + (
        "internvl2-2b serve", "llava-1.5-7b rescore", ed_runs[0],
        f"{SEAMLESS['name']} rescore") + tuple(vlm_runs)
        for name in ("xmodal_score_mean", "xmodal_score_max")})
    paths.update({name: serves + spec_runs[2:] +
                  ("granite-moe-3b-a800m rescore",) + moe_runs +
                  ("granite-moe-3b-a800m shard_map",)
                  for name in ("moe_dispatch", "moe_combine")})
    meta = {
        "flash_attention": ("flash_attention",
                            "kernels/flash_attention.py:89"),
        "decode_attention": ("decode_attention",
                             "kernels/decode_attention.py:81"),
        "paged_decode_attention": ("paged_decode_attention",
                                   "kernels/paged_decode_attention.py:171"),
        "xmodal_score_mean": ("xmodal_score",
                              "kernels/xmodal_score.py:112"),
        "xmodal_score_max": ("xmodal_score", "kernels/xmodal_score.py:127"),
        "moe_dispatch": ("moe_dispatch", "kernels/moe_dispatch.py:67"),
        "moe_combine": ("moe_dispatch", "kernels/moe_dispatch.py:88"),
    }
    kernels = []
    for name, (src, replaces) in meta.items():
        t = timings[name]
        by_run = {run: runs[run][name] for run in paths.get(name, serves)}
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}.cu",
            "replaces": f"src/repro/{replaces}",
            "launches": sum(by_run.values()), "launches_by_run": by_run,
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "call_ms": t["call_ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "shape": t["shape"],
            **{key: t[key] for key in ("sdpa_on_gathered_ms", "prefill",
                                       "verify", "warm_ms", "floor_ms",
                                       "long", "llava", "granite", "int8",
                                       "fp8", "sweep", "by_kernel",
                                       "splits") + TF32_BOUNDS + NEW_ENTRIES
               if key in t}})
    print("kernels: " + ", ".join(k["name"] for k in kernels))
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ranks-worker"]:
        ranks_worker(*sys.argv[2:4])
    else:
        main()

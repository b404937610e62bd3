"""Serving launcher of the port: build a model and serve CAMD requests.

    python -m repro_torch.launch.serve --arch qwen3-0.6b --mode camd \
        --impl paged_cuda --requests 8 --prompt-len 256 --max-new 32
    python -m repro_torch.launch.serve --arch llava-1.5-7b --no-reduced \
        --impl paged_cuda --xmodal-rescore --image-pool 2 --cache-len 864
    python -m repro_torch.launch.serve --impl paged_cuda --kv-dtype int8
    python -m repro_torch.launch.serve --impl paged_cuda --prefix-cache \
        --prefill-chunk 64 --prompt-len 256
    python -m repro_torch.launch.serve --impl paged_cuda --spec-k 4
    python -m repro_torch.launch.serve --impl paged_cuda --serve-dp 2 \
        --prefill-shards 1 --prefix-cache
    python -m repro_torch.launch.serve --impl paged_cuda --open-loop \
        --arrival poisson --arrival-rate 8 --slo-ms 500
    python -m repro_torch.launch.serve --arch recurrentgemma-2b --impl cuda
    python -m repro_torch.launch.serve --arch seamless-m4t-large-v2 \
        --impl cuda --mode camd --xmodal-rescore

Configs with a vision tower serve image requests: synthetic images drawn
from a pool of ``--image-pool`` distinct ones, encoded at submit time and
prefilled ahead of the prompt; configs with evidence tokens but no tower
get random precomputed evidence: the encoder-decoder
seamless-m4t-large-v2 takes 512 audio frames a request into its
encoder (``--impl torch|cuda``; it has no layer to page). The random
draws follow the reference CLI's order (``repro/launch/serve.py:197-216``),
so one seed makes the same requests in both packages.

The recurrent (mamba2-780m) and hybrid (recurrentgemma-2b) configs serve
on ``--impl torch|cuda`` only (a paged impl raises: they have no layer to
page); their prompt state sits in the engine's state arena, reported as
``state arena [kind]: peak R/N rows of X kB`` (rows held at once against
the arena's 2 * slots + 4, the bytes of one row over every cache leaf).

Weights are random, made from seed 0 (no checkpoint is in the
repository), and the model runs in fp32, as in the reference CLI; a
caller of ``build_engine`` or ``main`` may pass another ``param_dtype``
(bf16 serves the 32-34B configs on one 80 GB card, as the reference's
``build_model(cfg, param_dtype)`` takes one). A config whose weights
exceed the device's memory is refused before anything is allocated.
``--reduced`` (the default, as in the reference CLI) serves the
CPU-smoke-size variant of the config; ``--no-reduced`` serves it at its
published widths, and ``--num-layers`` cuts its depth (an
encoder-decoder's encoder and decoder both). Runs on the CUDA
device unless ``--device cpu``; there each macro launch (``--macro-steps``
K > 0) replays one CUDA graph of the K-step body, and the legacy loop
(``--macro-steps 0``) runs eagerly. ``--open-loop`` serves the same
requests through the async front-end, each submitted at its time in a
seeded Poisson or bursty arrival process, and reports TTFT and TPOT
percentiles and the goodput at a TTFT SLO.

``--serve-dp N`` (or ``--mesh N,model``, not both) serves over a mesh of
N data shards (``launch.mesh.make_serve_mesh``): slots, the page pool and the
state arena partition into N shards with shard-local admission, all on
the one device (logical shards; a ``model`` above 1 raises, as does a
mesh over several devices). ``--prefill-shards K`` puts prompt and chunk
pages on the first K shards. The run prints a ``serving mesh:`` line and
the candidates admitted per shard.

Under ``torchrun``, ``--mesh dp,model`` equal to the world serves as
ranks (``launch.mesh.make_rank_mesh``): the process joins the group
(``--dist-backend``, NCCL by default; gloo only when named), cuts the
model for its rank and serves its data shard's slots and pages::

    python -m torch.distributed.run --nproc-per-node 2 \
        -m repro_torch.launch.serve --no-reduced --impl paged_cuda \
        --mesh 1,2 --dist-backend gloo
    python -m torch.distributed.run --nproc-per-node 2 \
        -m repro_torch.launch.serve --device cpu --mesh 2,1 \
        --dist-backend gloo

NCCL takes one card a rank; ranks sharing a card run over gloo, whose
macro body runs eagerly (``graph: off (gloo)`` on the ``serving mesh:``
line). Rank 0 prints the results; every rank prints its kernel launches
(``rank R launches: {...}``, with a vision config its image encodes,
feature-memo hits and candidates rescored) and returns them under
``launches``. Image requests and ``--xmodal-rescore`` serve over ranks::

    python -m torch.distributed.run --nproc-per-node 2 \
        -m repro_torch.launch.serve --device cpu --arch llava-1.5-7b \
        --xmodal-rescore --mesh 1,2 --dist-backend gloo

and so do MoE models, each rank holding the experts and the share of
their hidden width the rule table gives it (``--mesh 2,2``: half the
experts and half of each one's width), which its launch line prints::

    python -m torch.distributed.run --nproc-per-node 4 \
        -m repro_torch.launch.serve --arch granite-moe-3b-a800m \
        --no-reduced --impl paged_cuda --mesh 2,2 --dist-backend gloo

and so do the recurrent and hybrid models on the dense impls, each data
rank holding its shard's rows of the state arena and each model rank its
SSD heads or RG-LRU width and its query heads beside the one kv head
(the ``serving mesh:`` and launch lines print them)::

    python -m torch.distributed.run --nproc-per-node 4 \
        -m repro_torch.launch.serve --arch recurrentgemma-2b \
        --no-reduced --impl cuda --mesh 2,2 --dist-backend gloo
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import device_memory_bytes, resolve_device
from repro_torch.config import (ATTN, LOCAL_ATTN, RGLRU, SSM, CAMDConfig,
                                PagedKVConfig, SamplingConfig, VisionConfig)
from repro_torch.configs import get_config
from repro_torch.distributed import context
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_rank_mesh, make_serve_mesh
from repro_torch.models.model import build_model
from repro_torch.models.moe import expert_range
from repro_torch.serving.engine import IMPLS, Request, ServeEngine
from repro_torch.serving.traffic import ARRIVALS, run_open_loop


def mesh_shape(text: str) -> Tuple[int, int]:
    """``--mesh``'s value: exactly 'dp,model', two positive ints."""
    parts = text.split(",")
    if len(parts) != 2 or not all(p.isdigit() and int(p) > 0
                                  for p in parts):
        raise argparse.ArgumentTypeError(
            f"expected 'dp,model' as two positive ints, got {text!r}")
    return int(parts[0]), int(parts[1])


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", "--config", default="qwen3-0.6b",
                    help="arch id ('qwen3-0.6b') or module name")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="serve the CPU-smoke-size variant of the config "
                         "(--no-reduced: its published widths)")
    ap.add_argument("--num-layers", type=int, default=0,
                    help="cut the model to this many layers, an "
                         "encoder-decoder's encoder and decoder each "
                         "(0 = keep)")
    ap.add_argument("--image-tokens", type=int, default=0,
                    help="vision configs: encode the synthetic images into "
                         "N image tokens each (the tower's patch grid is "
                         "cut to N; 0 = the config's count)")
    ap.add_argument("--image-pool", type=int, default=2,
                    help="distinct images the synthetic requests draw "
                         "from; repeats hit the submit-time feature memo")
    ap.add_argument("--xmodal-rescore", action="store_true",
                    help="rescore finished candidates' S_align by the "
                         "cross-modal score (Eq. 8-9; the K4 kernels under "
                         "the cuda impls) instead of the incremental "
                         "aggregate")
    ap.add_argument("--mode", default="camd",
                    choices=["camd", "best_of_n", "self_consistency",
                             "greedy"])
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--cache-len", type=int, default=128,
                    help="per-slot KV capacity (prompt + new tokens)")
    ap.add_argument("--eos-id", type=int, default=1,
                    help="end-of-sequence token; an id outside the vocab "
                         "makes every candidate run to its token limit")
    ap.add_argument("--impl", default="torch", choices=list(IMPLS),
                    help="torch/paged: plain PyTorch attention; cuda/"
                         "paged_cuda: the hand-written kernels")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--num-pages", type=int, default=0,
                    help="KV pool size; 0 = dense-equivalent worst case")
    ap.add_argument("--kv-dtype", default="auto",
                    choices=["auto", "fp32", "bf16", "int8", "fp8"],
                    help="paged KV pool storage: auto = the param dtype; "
                         "int8/fp8 store quantized pages with per-(page, "
                         "slot, kv-head) scales, dequantized inside the "
                         "paged decode kernel")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="cross-request prompt-prefix KV reuse (paged "
                         "impls on all-attention decoders)")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="chunked prefill: split long prompts into "
                         "page-aligned chunks of this many tokens and "
                         "interleave them with decode launches (0 = "
                         "whole-prompt prefill; paged all-attention "
                         "decoders only, others run unchunked)")
    ap.add_argument("--prefill-chunk-budget", type=int, default=0,
                    help="most chunk tokens prefilled between two decode "
                         "launches (0 = one chunk)")
    ap.add_argument("--prefill-shards", type=int, default=0,
                    help="prefill/decode disaggregation: place prompt and "
                         "chunk pages on the first N data shards; decode "
                         "slots on every shard read them (0 = prompt pages "
                         "follow the admitting slot)")
    shards = ap.add_mutually_exclusive_group()
    shards.add_argument("--serve-dp", type=int, default=0,
                        help="serve over N data shards of the one device "
                             "(slots, page pool and state arena "
                             "partitioned, shard-local admission; 0 = "
                             "unsharded)")
    shards.add_argument("--mesh", type=mesh_shape, default=None,
                        help="serving mesh as 'dp,model', two positive "
                             "ints: under torchrun a mesh of that many ranks "
                             "(one process each); alone, dp logical shards "
                             "of the one device (a model axis above 1 "
                             "raises there)")
    ap.add_argument("--dist-backend", choices=context.BACKENDS, default=None,
                    help="torch.distributed backend of a rank mesh: nccl "
                         "(the default; a card a rank) or gloo (ranks "
                         "sharing a card, or the CPU), never chosen for "
                         "you")
    ap.add_argument("--kv-byte-budget", type=int, default=0,
                    help="resident-KV byte ceiling for the prefix cache: "
                         "cached-only pages are evicted until resident KV "
                         "bytes (scales included) fit (0 = unbounded)")
    ap.add_argument("--macro-steps", type=int, default=8,
                    help="device decode steps per launch; 0 = legacy "
                         "per-token host loop")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="speculative block length: draft up to K-1 "
                         "tokens per slot from the n-gram table and "
                         "verify them in one target forward (0/1 = off; "
                         "requires --macro-steps >= 1 and an "
                         "all-attention decoder)")
    ap.add_argument("--spec-mode", default="coverage",
                    choices=["coverage", "fixed"],
                    help="coverage: per-slot draft length shrinks toward "
                         "1 as the request's posterior coverage deficit "
                         "closes; fixed: always draft spec-k - 1 tokens")
    ap.add_argument("--sched-policy", default="fifo",
                    choices=["fifo", "coverage"])
    ap.add_argument("--global-budget", type=int, default=0,
                    help="hard token budget across the stream (0 = none)")
    ap.add_argument("--no-bucket-prefill", action="store_true")
    ap.add_argument("--prefill-bucket-min", type=int, default=16)
    ap.add_argument("--open-loop", action="store_true",
                    help="serve through the async streaming front-end "
                         "with timed arrivals instead of a pre-staged "
                         "batch, and report SLO metrics (TTFT/TPOT "
                         "percentiles, goodput); needs --macro-steps >= 1")
    ap.add_argument("--arrival", default="poisson",
                    choices=["poisson", "bursty"],
                    help="open-loop arrival process")
    ap.add_argument("--arrival-rate", type=float, default=8.0,
                    help="open-loop offered load, requests/s")
    ap.add_argument("--slo-ms", type=float, default=500.0,
                    help="TTFT SLO for the goodput metric, milliseconds")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    ap.add_argument("--seed", type=int, default=0,
                    help="sampling and request seed")
    return ap.parse_args(argv)


def make_requests(cfg, args) -> List[Request]:
    """The synthetic requests, drawn in the reference CLI's order: first
    the pool images, then per request its prompt followed by its image
    index (or, without a tower, its raw evidence)."""
    rng = np.random.default_rng(args.seed)
    images = []
    if cfg.num_evidence_tokens and cfg.vision is not None:
        v = cfg.vision
        images = [rng.standard_normal(
            (v.image_h, v.image_w, v.channels)).astype(np.float32)
            for _ in range(max(1, args.image_pool))]
    reqs = []
    for i in range(args.requests):
        prompt = rng.integers(2, cfg.vocab_size,
                              size=args.prompt_len).astype(np.int32)
        if images:
            reqs.append(Request(uid=i, prompt=prompt,
                                image=images[int(rng.integers(len(images)))]))
            continue
        ev = None
        if cfg.num_evidence_tokens:
            ev = rng.standard_normal((cfg.num_evidence_tokens,
                                      cfg.evidence_dim)).astype(np.float32)
        reqs.append(Request(uid=i, prompt=prompt, evidence=ev))
    return reqs


def _join_ranks(args: argparse.Namespace):
    """The rank mesh ``args`` ask for, or None: under torchrun
    (``WORLD_SIZE`` set) or in an initialized process group, ``--mesh``
    names a mesh of the world's ranks. Joins the default group (env://,
    ``--dist-backend``, NCCL unless gloo is named) when it is not up
    yet."""
    if not (dist.is_initialized() or "WORLD_SIZE" in os.environ):
        if args.dist_backend:
            raise SystemExit("--dist-backend needs ranks: run under torchrun "
                             "(python -m torch.distributed.run)")
        return None
    if not args.mesh:
        raise SystemExit("serving as ranks needs --mesh dp,model equal to "
                         "the world")
    backend = args.dist_backend or "nccl"
    if backend == "nccl" and (not torch.cuda.is_available() or (
            args.device and torch.device(args.device).type != "cuda")):
        raise SystemExit("NCCL serves ranks on CUDA devices: name "
                         "--dist-backend gloo for ranks on the CPU")
    if not dist.is_initialized():
        if backend == "nccl":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group(backend, init_method="env://")
    elif dist.get_backend() != backend:
        raise SystemExit(f"the process group runs {dist.get_backend()}, "
                         f"not --dist-backend {backend}")
    dp, mp = args.mesh
    if dp * mp != dist.get_world_size():
        raise SystemExit(f"--mesh {dp},{mp} is {dp * mp} ranks; the world "
                         f"has {dist.get_world_size()}")
    return make_rank_mesh(dp, mp, device=args.device)


def build_engine(args: argparse.Namespace, param_dtype=torch.float32,
                 model=None):
    """The served config and the engine that ``args`` ask for (model
    weights made from seed 0, in ``param_dtype``: fp32 as the reference
    CLI serves; not a CLI flag). Raises ``SystemExit`` before allocating
    when the weights alone exceed the device's memory. ``model`` (not a
    CLI flag either) serves an already built model instead, which must
    be the config, dtype and device ``args`` ask for (on a rank mesh with
    a model axis, cut for the rank). As a rank (``_join_ranks``) the
    model is built for the rank's world on its device; a failed build
    releases the world's groups. Returns (cfg, engine)."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.num_layers:
        cfg = cfg.with_overrides(num_layers=args.num_layers)
        if cfg.is_encoder_decoder:
            cfg = cfg.with_overrides(num_encoder_layers=args.num_layers)
    # fp32 by default, as the reference CLI
    cfg = cfg.with_overrides(dtype=str(param_dtype).replace("torch.", ""))
    if args.image_tokens:
        if cfg.vision is None:
            raise SystemExit(f"--image-tokens needs a vision config; "
                             f"{cfg.name} has no vision tower")
        v = cfg.vision
        cfg = cfg.with_overrides(
            num_evidence_tokens=args.image_tokens,
            vision=VisionConfig.for_tokens(
                args.image_tokens, patch=v.patch, num_layers=v.num_layers,
                d_model=v.d_model, num_heads=v.num_heads, d_ff=v.d_ff))
    mesh = _join_ranks(args)
    world = mesh.world if mesh is not None else None
    try:
        return _build(args, cfg, param_dtype, model, mesh, world)
    except BaseException:
        if world is not None:
            context.release_world(world)
        raise


def _build(args, cfg, param_dtype, model, mesh, world):
    """``build_engine`` once the config and the rank world are known."""
    device = world.device if world is not None else resolve_device(
        args.device)
    if model is not None:
        if (model.cfg, model.param_dtype, model.device.type) != \
                (cfg, param_dtype, device.type):
            raise ValueError(f"the given model ({model.cfg.name}, "
                             f"{model.param_dtype}, {model.device}) is not "
                             f"the one asked for ({cfg.name}, {param_dtype}, "
                             f"{device})")
    else:
        total = device_memory_bytes(device)
        need = cfg.num_params() * torch.finfo(param_dtype).bits // 8
        if total is not None and need > total:
            raise SystemExit(
                f"{cfg.name}: {cfg.num_params() / 1e9:.2f}B parameters need "
                f"{need / 1e9:.1f} GB of {param_dtype} weights, more than "
                f"the {total / 1e9:.1f} GB of {device}; serve it reduced "
                "(--reduced or --num-layers) or in a smaller param dtype")
        model = build_model(cfg, param_dtype, device=device, seed=0,
                            world=world)
    if world is None and (args.mesh or args.serve_dp > 1):
        dp, mp = args.mesh or (args.serve_dp, 1)
        mesh = make_serve_mesh(dp, model=mp, device=device)
    eng = ServeEngine(
        model, slots=args.slots, cache_len=args.cache_len,
        sampling=SamplingConfig(max_new_tokens=args.max_new),
        camd=CAMDConfig(), mode=args.mode, max_new_tokens=args.max_new,
        eos_id=args.eos_id, impl=args.impl,
        paged_kv=PagedKVConfig(page_size=args.page_size,
                               num_pages=args.num_pages,
                               kv_dtype=args.kv_dtype,
                               kv_byte_budget=args.kv_byte_budget),
        macro_steps=args.macro_steps,
        bucket_prefill=not args.no_bucket_prefill,
        prefill_bucket_min=args.prefill_bucket_min,
        sched_policy=args.sched_policy, global_budget=args.global_budget,
        prefix_cache=args.prefix_cache, prefill_chunk=args.prefill_chunk,
        prefill_chunk_budget=args.prefill_chunk_budget,
        prefill_shards=args.prefill_shards, mesh=mesh, spec_k=args.spec_k,
        spec_mode=args.spec_mode,
        xmodal_rescore=args.xmodal_rescore, seed=args.seed)
    return cfg, eng


def main(argv: Optional[List[str]] = None, param_dtype=torch.float32,
         model=None) -> Dict[str, object]:
    """Serve synthetic requests, as one pre-staged batch or (``--open-loop``)
    arriving on their own clock; prints results and telemetry and returns
    them (``engine``, ``results``, ``seconds``, ``tokens_per_s``,
    ``launches`` (this process's kernel launches), and with
    ``--open-loop`` the per-request ``traces`` and their ``metrics``).
    ``param_dtype`` and ``model`` go to ``build_engine``. As a rank, it
    releases its mesh's groups on return; the default process group
    stays up for its starter."""
    args = parse_args(argv)
    if args.open_loop and args.macro_steps < 1:
        raise SystemExit("--open-loop drives the fused macro-step loop; "
                         "use --macro-steps >= 1")
    t_build = time.perf_counter()
    cfg, eng = build_engine(args, param_dtype, model)
    try:
        return _serve(args, cfg, eng, param_dtype, t_build)
    finally:
        if eng.world is not None:
            context.release_world(eng.world)


def rank_widths(eng) -> str:
    """What a rank holds of a model's widths (its query and kv heads, SSD
    heads, RG-LRU width) and of a recurrent engine's arena (its shard's
    rows and mirror rows), for the ``serving mesh:`` and launches
    lines."""
    cfg, model = eng.cfg, eng.model
    parts = []
    for blk in model.layers:
        if blk.kind in (ATTN, LOCAL_ATTN) and "heads" not in parts:
            q = blk.attn.wq.kernel.shape[1] // cfg.resolved_head_dim
            parts += ["heads", f"query heads {q} of {cfg.num_heads}, kv "
                      f"heads {model.kv_heads} of {cfg.num_kv_heads}"]
        elif blk.kind == SSM and "ssd" not in parts:
            parts += ["ssd", f"SSD heads {blk.ssm.A_log.shape[0]} of "
                      f"{cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim}"]
        elif blk.kind == RGLRU and "rglru" not in parts:
            parts += ["rglru", f"RG-LRU width {blk.rglru.lam.shape[0]} of "
                      f"{cfg.rglru.lru_width or cfg.d_model}"]
    out = parts[1::2]
    if eng.arena is not None:
        out.append(f"arena rows {eng._arena_own} of {eng.arena.num_rows} "
                   f"+ {eng._n_row_mirror} mirror rows")
    return "".join(f"; {p}" for p in out)


def _serve(args, cfg, eng, param_dtype, t_build) -> Dict[str, object]:
    """``main`` once the engine is built. Rank 0 of a rank mesh prints the
    run; every rank prints its kernel launches."""
    world = eng.world
    say = print if world is None or world.rank == 0 else \
        (lambda *a, **kw: None)
    model = eng.model
    if model.device.type == "cuda":
        torch.cuda.synchronize()
    say(f"model [{cfg.name}]: {cfg.num_params() / 1e6:.1f}M parameters "
        f"in {str(param_dtype).replace('torch.', '')}, built with the "
        f"engine in {time.perf_counter() - t_build:.2f}s")
    if eng.mesh is not None:
        ranks = "" if world is None else (
            f"; rank {world.rank} at {world.coords} of {world.dp} x "
            f"{world.model} ranks over {world.backend}, graph: " +
            ("off (gloo)" if eng._eager_body else
             "on" if model.device.type == "cuda" else "off (cpu)"))
        say(f"serving mesh: {dict(eng.mesh.shape)}, {eng.dp} data shards "
            f"of {eng.slots_per_shard} slots on {model.device}{ranks}"
            + ("" if world is None else rank_widths(eng)))
    reqs = make_requests(cfg, args)
    if not args.open_loop:
        for req in reqs:
            eng.submit(req)
    sync = torch.cuda.synchronize if model.device.type == "cuda" \
        else (lambda: None)
    traces = metrics = None
    sync()
    t0 = time.perf_counter()
    with torch.inference_mode():
        if args.open_loop:
            arrivals = ARRIVALS[args.arrival](args.arrival_rate,
                                              args.requests, seed=args.seed)
            traces, metrics = run_open_loop(eng, reqs, arrivals,
                                            slo_ttft_ms=args.slo_ms)
            results = [eng.result(tr.uid) for tr in traces]
        else:
            results = eng.run()
    sync()
    secs = time.perf_counter() - t0
    if args.open_loop:
        for tr in traces:
            say(f"req {tr.uid}: arrival {tr.t_arrival * 1e3:7.1f}ms  "
                f"ttft {(tr.t_first - tr.t_arrival) * 1e3:7.1f}ms  "
                f"tokens={tr.n_tokens}")
        say(f"open loop [{args.arrival} @ {args.arrival_rate:.1f} rps]: "
            f"{metrics['completed']} completed over "
            f"{metrics['span_s']:.2f}s")
        say(f"  ttft p50/p99 {metrics['ttft_p50_ms']:.1f}/"
            f"{metrics['ttft_p99_ms']:.1f} ms   "
            f"tpot p50/p99 {metrics['tpot_p50_ms']:.1f}/"
            f"{metrics['tpot_p99_ms']:.1f} ms")
        say(f"  goodput {metrics['goodput_rps']:.2f} rps at "
            f"{args.slo_ms:.0f}ms TTFT SLO "
            f"({metrics['good_requests']}/{metrics['completed']}), "
            f"{metrics['tokens_per_s']:.1f} tok/s")
    else:
        for r in results:
            say(f"req {r.uid}: candidates={r.n_candidates} "
                f"rounds={r.rounds} tokens={r.tokens_spent} "
                f"p*={r.p_star:.3f} early={r.stopped_early} "
                f"out={r.tokens[:8].tolist()}")
    say(f"engine [{cfg.name}, {cfg.num_layers}L d{cfg.d_model}, "
        f"{str(model.param_dtype).replace('torch.', '')}, "
        f"{args.impl} on {model.device}]: {eng.total_steps} steps, "
        f"{eng.total_tokens} tokens in {secs:.3f}s "
        f"({eng.total_tokens / secs:.1f} tok/s, prefill included)")
    say(f"macro-step: K={eng.macro_steps}, {eng.macro_launches} launches"
        f"{' (CUDA graph replays)' if eng._graphs_captured else ''}, "
        f"{eng.host_syncs} host syncs")
    if eng.spec:
        say(f"speculative: K={eng.spec_k} ({eng.spec_mode}), "
            f"{eng.spec_drafted} drafted, {eng.spec_accepted} accepted "
            f"({eng.spec_accepted / max(eng.spec_drafted, 1):.0%})")
    ss = eng.sched_stats()
    say(f"scheduler: {ss['policy']} admitted={ss['admitted_candidates']} "
        f"spent={ss['spent']}/{ss['global_budget'] or 'inf'} "
        f"declined={ss['declined_rounds']} starved={ss['starved']}")
    say(f"prefill: {ss['prefill_calls']} calls over "
        f"{ss['prefill_tokens']} tokens")
    if eng.chunked:
        say(f"chunked prefill: chunk={eng.chunk} budget="
            f"{eng.chunk_budget} tok/turn, {ss['chunk_calls']} chunk "
            f"calls over {ss['chunk_tokens']} tokens"
            + (f", prefill shards 0..{eng.prefill_shards - 1} of "
               f"{eng.dp}" if eng.prefill_shards else ""))
    if "admitted_per_shard" in ss:
        say(f"shards: admitted per shard {ss['admitted_per_shard']}"
            + (f", prompt pages on shards 0..{eng.prefill_shards - 1}"
               if eng.prefill_shards else ""))
    if eng.paged:
        s = eng.kv_stats()
        say(f"paged kv [{s['kv_dtype']}]: peak {s['max_in_use']}/"
            f"{s['num_pages']} pages "
            f"({s['peak_kv_bytes'] / 1e6:.2f} MB resident at peak vs "
            f"{s['dense_equiv_bytes'] / 1e6:.2f} MB dense-equivalent)")
        if "prefix_cache" in s:
            pc = s["prefix_cache"]
            say(f"prefix cache: {pc['hits']} page hits, "
                f"{pc['hit_tokens']} prefill tokens skipped, "
                f"{pc['bytes_saved'] / 1e6:.2f} MB KV writes saved")
        if s.get("kv_byte_budget"):
            say(f"kv byte budget: {s['kv_byte_budget'] / 1e6:.2f} MB "
                f"ceiling, {s['budget_evictions']} budget evictions")
    if eng.arena is not None:
        a = eng.arena_stats()
        say(f"state arena [{a['state_kind']}]: peak {a['max_in_use']}/"
            f"{a['num_rows']} rows of {a['bytes_per_row'] / 1e3:.1f} kB "
            f"({a['alloc_count']} allocs, {a['sizing_stalls']} stalls)")
    if eng.image_encodes or eng.image_feat_hits:
        say(f"vision frontend: {eng.image_encodes} tower encodes "
            f"({eng.image_encode_s * 1e3:.1f} ms), {eng.image_feat_hits} "
            "feature-memo hits")
    launches = dict(ops.LAUNCHES)
    if world is not None:
        line = f"rank {world.rank} launches: {launches}"
        if eng.has_evidence:
            line += (f"; image encodes {eng.image_encodes}, feature-memo "
                     f"hits {eng.image_feat_hits}, candidates rescored "
                     f"{eng.xmodal_rescored} ({eng.xmodal_parted} parted "
                     "from rank 0's S_align)")
        if eng.arena is not None:
            a = eng.arena_stats()["rank"]
            line += (f"; {rank_widths(eng)[2:]}, mirror rows held at peak "
                     f"{a['mirror_peak']}, rows fetched {a['row_fetches']}")
        if cfg.moe is not None:
            moe = model.layers[0].moe
            e0, e1 = expert_range(moe, cfg, world)
            line += (f"; experts [{e0}, {e1}) of {cfg.moe.num_experts}, f "
                     f"{moe.w_gate.shape[2]} of {cfg.moe.expert_d_ff}")
        print(line)
    return {"engine": eng, "results": results, "seconds": secs,
            "tokens_per_s": eng.total_tokens / secs, "traces": traces,
            "metrics": metrics, "launches": launches}


if __name__ == "__main__":
    try:
        main()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()

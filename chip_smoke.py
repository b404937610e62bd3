#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. It
  1. prints the card's name and power limit (nvidia-smi);
  2. builds every CUDA kernel of the port from ``src/repro_torch/kernels/
     csrc`` with nvcc, one process per source, all at once;
  3. kernel phase: holds each kernel against its plain PyTorch version on
     the card (fp32 and bf16, head_dim 64 and 128, the serving shapes and
     ragged edges, int8/fp8 pools for the paged kernel, ragged row counts
     for the cross-modal score) and times kernel, plain version and —
     where one PyTorch call computes the same function —
     ``scaled_dot_product_attention``, beside a bound from bytes and
     operations;
  4. serve phase: serves CAMD requests on full-width qwen3-0.6b through
     the port's serve entry point with ``--impl paged_cuda`` and checks
     that the flash and paged decode kernels carried it;
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
and prints a JSON line describing every kernel, the card line again, and
last ``{"ok": true, "device": {...}}``. Any failure exits nonzero. It
exits with an error, printing no result, without a CUDA device or outside
a checkout of the repository.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PEAK_BYTES_PER_S = 3.35e12            # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_FLOPS = {"float32": 67e12,       # fp32 outside the tensor cores
              "bfloat16": 989e12}     # dense bf16 tensor cores
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (2e-2, 2e-2)}   # (atol, rtol)

# serving configuration of the main path
SERVE = dict(slots=8, page=16, requests=8, prompt=256, max_new=32)
CACHE_LEN = SERVE["prompt"] + SERVE["max_new"]     # 288, a page multiple
# the multimodal path: llava-1.5-7b's 576 image tokens ahead of the prompt
IMAGE_TOKENS = 576
MM_CACHE_LEN = IMAGE_TOKENS + CACHE_LEN            # 864, a page multiple


def fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


class Timer:
    """Per-launch timing with the L2 cache flushed before each launch (the
    serving path meets every layer's K/V cold): ``device_ms`` sums the
    device durations of the call's kernels under torch.profiler (launch
    gaps and host time excluded), ``ms`` reads CUDA events around the
    call (the host's work inside the call included, where the device
    waits on it)."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
        self._flush_keys = set(self._kernel_times(self._flush, 1))

    def _flush(self):
        self.flush.bitwise_not_()

    def _kernel_times(self, fn, reps: int):
        """{kernel name: summed device microseconds} over ``reps`` calls,
        each after an L2 flush."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                self._flush()
                fn()
            torch.cuda.synchronize()
        return {e.key: e.self_device_time_total for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA}

    def device_ms(self, fn, kernel: str = None, reps: int = 20,
                  warmup: int = 3) -> float:
        """Device time per call: the call's kernels (only those whose name
        holds ``kernel``, when given), the flush left out."""
        for _ in range(warmup):
            fn()
        times = {k: v for k, v in self._kernel_times(fn, reps).items()
                 if k not in self._flush_keys and (kernel is None or
                                                   kernel in k)}
        check(bool(times), f"timer: the profiler saw no kernel "
              f"{kernel or ''} in the call")
        return sum(times.values()) / reps / 1e3

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

def flash_phase(torch, ops, ref, timer):
    F = torch.nn.functional
    g = torch.Generator(device="cuda").manual_seed(1)
    errs = []
    cases = [  # (B, L, H, Hkv, hd, causal, window)
        (8, 256, 16, 8, 128, True, 0),     # serving prefill bucket
        (2, 200, 4, 2, 64, True, 0),       # L not a tile multiple
        (2, 300, 4, 4, 128, True, 96),     # causal + sliding window
        (1, 37, 2, 1, 64, False, 0),       # tiny, non-causal, MQA
    ]
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        for B, L, H, Hkv, hd, causal, window in cases:
            q = torch.randn(B, L, H, hd, generator=g, device="cuda").to(dt)
            k = torch.randn(B, L, Hkv, hd, generator=g, device="cuda").to(dt)
            v = torch.randn(B, L, Hkv, hd, generator=g, device="cuda").to(dt)
            out = ops.flash_attention(q, k, v, causal=causal, window=window)
            exp = ref.flash_attention_ref(q, k, v, causal=causal,
                                          window=window)
            errs.append(compare(
                torch, "flash_attention", f"{dtype} B{B} L{L} H{H}/{Hkv} "
                f"hd{hd} causal={int(causal)} w={window}", out, exp, dtype))
    # timing at the serving shape (fp32, as the serve phase runs)
    B, L, H, Hkv, hd = 8, SERVE["prompt"], 16, 8, 128
    q = torch.randn(B, L, H, hd, generator=g, device="cuda")
    k = torch.randn(B, L, Hkv, hd, generator=g, device="cuda")
    v = torch.randn(B, L, Hkv, hd, generator=g, device="cuda")
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    t = times(timer, lambda: ops.flash_attention(q, k, v), "flash_kernel",
              lambda: ref.flash_attention_ref(q, k, v),
              lambda: F.scaled_dot_product_attention(
                  qt, kt, vt, is_causal=True, enable_gqa=True))
    nbytes = 4 * (2 * q.numel() + 2 * k.numel())
    flops = 4 * B * H * hd * (L * (L + 1) // 2)
    t["bound_ms"], t["bound_by"] = bound_ms(nbytes, flops, "float32")
    t["max_abs_err"] = max(errs)
    t["shape"] = f"fp32 B{B} L{L} H{H} Hkv{Hkv} hd{hd} causal"
    return t


def ring_mask(torch, pos, S):
    slot = torch.arange(S, device="cuda")
    p = pos[:, None]
    return p - torch.remainder(p - slot[None, :], S) >= 0


def decode_phase(torch, ops, ref, timer):
    F = torch.nn.functional
    g = torch.Generator(device="cuda").manual_seed(2)
    errs = []
    cases = [  # (B, S, H, Hkv, hd, mask kind)
        (8, CACHE_LEN, 16, 8, 128, "ring"),    # serving decode, mid-run
        (2, 300, 8, 2, 64, "random"),          # S not a tile multiple, G=4
        (3, 128, 4, 4, 128, "ring"),           # G = 1
    ]
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        for B, S, H, Hkv, hd, kind in cases:
            q = torch.randn(B, 1, H, hd, generator=g, device="cuda").to(dt)
            k = torch.randn(B, S, Hkv, hd, generator=g, device="cuda").to(dt)
            v = torch.randn(B, S, Hkv, hd, generator=g, device="cuda").to(dt)
            if kind == "ring":
                pos = torch.randint(0, S, (B,), generator=g, device="cuda")
                mask = ring_mask(torch, pos, S)
            else:
                mask = torch.rand(B, S, generator=g, device="cuda") < 0.75
                mask[:, :2] = True
            out = ops.decode_attention(q, k, v, mask)
            exp = ref.decode_attention_ref(q, k, v, mask)
            errs.append(compare(torch, "decode_attention",
                                f"{dtype} B{B} S{S} H{H}/{Hkv} hd{hd} {kind}",
                                out, exp, dtype))
    B, S, H, Hkv, hd = 8, CACHE_LEN, 16, 8, 128
    q = torch.randn(B, 1, H, hd, generator=g, device="cuda")
    k = torch.randn(B, S, Hkv, hd, generator=g, device="cuda")
    v = torch.randn(B, S, Hkv, hd, generator=g, device="cuda")
    pos = torch.randint(SERVE["prompt"], S, (B,), generator=g, device="cuda")
    mask = ring_mask(torch, pos, S)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    am = mask[:, None, None, :]
    t = times(timer, lambda: ops.decode_attention(q, k, v, mask),
              "decode_kernel",
              lambda: ref.decode_attention_ref(q, k, v, mask),
              lambda: F.scaled_dot_product_attention(
                  qt, kt, vt, attn_mask=am, enable_gqa=True))
    live = int(mask.sum())
    nbytes = 4 * 2 * q.numel() + mask.numel() + 4 * 2 * live * Hkv * hd
    flops = 4 * H * hd * live
    t["bound_ms"], t["bound_by"] = bound_ms(nbytes, flops, "float32")
    t["max_abs_err"] = max(errs)
    t["shape"] = f"fp32 B{B} S{S} H{H} Hkv{Hkv} hd{hd} ring mask"
    return t


def paged_setup(torch, g, B, H, Hkv, hd, ps, n, lengths, pool_dtype, q_dtype,
                kv_quantize):
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
    F = torch.nn.functional
    g = torch.Generator(device="cuda").manual_seed(3)
    n_serve = CACHE_LEN // SERVE["page"]
    serve_lens = [SERVE["prompt"] + 1 + 4 * i for i in range(8)]
    errs = []
    cases = [  # (B, H, Hkv, hd, ps, n, lengths)
        (8, 16, 8, 128, SERVE["page"], n_serve, serve_lens),
        (3, 8, 2, 64, 16, 5, [1, 37, 80]),      # length 1, non-multiples
        (3, 4, 4, 128, 64, 3, [64, 130, 5]),
    ]
    kinds = [("float32", torch.float32), ("bfloat16", torch.bfloat16),
             ("float32", torch.int8), ("bfloat16", torch.int8),
             ("float32", torch.float8_e4m3fn)]
    for qname, pool_dtype in kinds:
        q_dtype = getattr(torch, qname)
        for B, H, Hkv, hd, ps, n, lens in cases:
            q, kp, vp, bt, ln, ks, vs = paged_setup(
                torch, g, B, H, Hkv, hd, ps, n, lens, pool_dtype, q_dtype,
                kv_quantize)
            out = ops.paged_decode_attention(q, kp, vp, bt, ln, k_scale=ks,
                                             v_scale=vs)
            exp = ref.paged_decode_attention_ref(q, kp, vp, bt, ln,
                                                 k_scale=ks, v_scale=vs)
            pname = str(pool_dtype).replace("torch.", "")
            errs.append(compare(
                torch, "paged_decode_attention",
                f"q {qname} pool {pname} B{B} H{H}/{Hkv} hd{hd} ps{ps}",
                out, exp, qname))
    B, H, Hkv, hd, ps = 8, 16, 8, 128, SERVE["page"]
    q, kp, vp, bt, ln, _, _ = paged_setup(
        torch, g, B, H, Hkv, hd, ps, n_serve, serve_lens, torch.float32,
        torch.float32, kv_quantize)
    t = times(timer, lambda: ops.paged_decode_attention(q, kp, vp, bt, ln),
              "paged_decode_kernel",
              lambda: ref.paged_decode_attention_ref(q, kp, vp, bt, ln))
    # no single PyTorch call reads a block table: library_ms stays null;
    # SDPA over the dense view gathered from the same pages is a yardstick
    k = kp[bt.long()].reshape(B, -1, Hkv, hd).transpose(1, 2)
    v = vp[bt.long()].reshape(B, -1, Hkv, hd).transpose(1, 2)
    am = (torch.arange(k.shape[2], device="cuda")[None, :] <
          ln[:, None])[:, None, None, :]
    qt = q.transpose(1, 2)
    t["sdpa_on_gathered_ms"] = timer.device_ms(
        lambda: F.scaled_dot_product_attention(qt, k, v, attn_mask=am,
                                               enable_gqa=True))
    live = int(ln.sum())
    nbytes = 4 * 2 * q.numel() + 4 * (bt.numel() + B) + \
        4 * 2 * live * Hkv * hd
    flops = 4 * H * hd * live
    t["bound_ms"], t["bound_by"] = bound_ms(nbytes, flops, "float32")
    t["max_abs_err"] = max(errs)
    t["shape"] = f"fp32 B{B} H{H} Hkv{Hkv} hd{hd} ps{ps} lengths " \
        f"{serve_lens[0]}..{serve_lens[-1]}"
    return t


def xmodal_phase(torch, ops, ref, timer):
    """K4a (masked token-visual cosine sum) and K4b (sum of each text row's
    best visual cosine), each against its plain version, and the composed
    score. Both compute in fp32 from the same input values, so bf16 inputs
    take the fp32 tolerance."""
    g = torch.Generator(device="cuda").manual_seed(4)
    serving = (1, SERVE["max_new"], IMAGE_TOKENS, SERVE["prompt"], 4096)
    cases = [serving,                      # (B, L, Nv, Nt, d)
             (3, 1, 7, 129, 48),           # ragged rows, d not a chunk multiple
             (2, 33, 65, 31, 100)]
    errs = {"xmodal_score_mean": [], "xmodal_score_max": []}

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
            case = f"{dtype} B{B} L{L} Nv{Nv} Nt{Nt} d{d}"
            errs["xmodal_score_mean"].append(compare(
                torch, "xmodal_score_mean", case,
                ops.xmodal_mean_sum(tok, mask, vis),
                ref.xmodal_mean_sum_ref(tok, mask, vis), "float32"))
            errs["xmodal_score_max"].append(compare(
                torch, "xmodal_score_max", case, ops.xmodal_max_sum(txt, vis),
                ref.xmodal_max_sum_ref(txt, vis), "float32"))
            out = ops.xmodal_score(tok, mask, vis, txt)
            compare(torch, "xmodal_score", case, out,
                    ref.xmodal_score_ref(tok, mask, vis, txt), "float32")
            check(torch.equal(out, ops.xmodal_score(tok, mask, vis, txt)),
                  f"xmodal_score {case}: two runs differ")
    # timing at the serving shape: one finished candidate's 32 tokens
    # (all live) against 576 image rows and a 256-token prompt, fp32
    B, L, Nv, Nt, d = serving
    tok, mask, vis, txt = inputs(B, L, Nv, Nt, d, torch.float32)
    mask.fill_(1.0)
    shape = f"fp32 B{B} L{L} Nv{Nv} Nt{Nt} d{d}"
    t_mean = times(timer, lambda: ops.xmodal_mean_sum(tok, mask, vis),
                   "xmodal_mean_kernel",
                   lambda: ref.xmodal_mean_sum_ref(tok, mask, vis))
    t_mean["shape"] = shape
    t_mean["bound_ms"], t_mean["bound_by"] = bound_ms(
        4 * (B * L * d + B * L + B * Nv * d + B), 2 * B * L * Nv * d,
        "float32")
    t_max = times(timer, lambda: ops.xmodal_max_sum(txt, vis),
                  "xmodal_max_kernel",
                  lambda: ref.xmodal_max_sum_ref(txt, vis))
    t_max["shape"] = shape
    t_max["bound_ms"], t_max["bound_by"] = bound_ms(
        4 * (B * Nt * d + B * Nv * d + B), 2 * B * Nt * Nv * d, "float32")
    t_mean["max_abs_err"] = max(errs["xmodal_score_mean"])
    t_max["max_abs_err"] = max(errs["xmodal_score_max"])
    return {"xmodal_score_mean": t_mean, "xmodal_score_max": t_max}


# ---------------------------------------------------------------------------
# serve phases and dense checks
# ---------------------------------------------------------------------------

QWEN_ARGV = ["--arch", "qwen3-0.6b", "--no-reduced", "--impl", "paged_cuda",
             "--mode", "camd", "--slots", str(SERVE["slots"]),
             "--page-size", str(SERVE["page"]),
             "--requests", str(SERVE["requests"]),
             "--prompt-len", str(SERVE["prompt"]),
             "--max-new", str(SERVE["max_new"]),
             "--cache-len", str(CACHE_LEN), "--eos-id", "151936",
             "--device", "cuda", "--seed", "0"]
LLAVA_ARGV = ["--arch", "llava-1.5-7b", "--no-reduced", "--impl",
              "paged_cuda", "--mode", "camd", "--xmodal-rescore",
              "--slots", str(SERVE["slots"]),
              "--page-size", str(SERVE["page"]),
              "--requests", str(SERVE["requests"]),
              "--prompt-len", str(SERVE["prompt"]),
              "--max-new", str(SERVE["max_new"]),
              "--cache-len", str(MM_CACHE_LEN), "--image-pool", "2",
              "--eos-id", "32000", "--device", "cuda", "--seed", "0"]


def serve_phase(torch, ops, serve, argv, kernels):
    """One serve run through the entry point, with the launch counts set
    to 0 just before and read just after; every kernel in ``kernels`` must
    have carried it. Returns (launches, output of serve.main)."""
    s = SERVE
    print("serve phase: python -m repro_torch.launch.serve " + " ".join(argv))
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    out = serve.main(argv)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    eng, results = out["engine"], out["results"]
    check(len(results) == s["requests"], "serve: missing results")
    for r in results:
        check(r.n_candidates > 0 and 0 < len(r.tokens) <= s["max_new"],
              f"serve: request {r.uid} has no usable candidate")
        check(all(0 <= int(t) < eng.V for t in r.tokens),
              f"serve: request {r.uid} emitted an out-of-vocab token")
        check(bool(torch.isfinite(torch.tensor(r.best_score))),
              f"serve: request {r.uid} has a non-finite score")
    eng.pool.check()
    check(eng.pool.in_use == 0, "serve: pages leaked")
    for name in kernels:
        check(launches[name] > 0, f"serve: {name} was never launched")
    print(f"serve phase: {out['tokens_per_s']:.1f} tok/s "
          f"({eng.total_tokens} tokens in {out['seconds']:.2f}s, "
          f"{eng.total_steps} decode steps, {eng.macro_launches} launches, "
          f"peak device memory {peak_gb:.1f} GB); launches {launches}")
    return launches, out


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


def profile_phase(torch, serve, argv):
    """Where the serve phase's time goes, on a shorter run of the same
    shapes (2 requests fill the 8 slots): device busy time by kernel under
    torch.profiler, and the device's idle share against the same run's
    unprofiled wall time. (Processing the trace of the full 8-request run
    took minutes.)"""
    from torch.profiler import ProfilerActivity, profile
    argv = list(argv)
    argv[argv.index("--requests") + 1] = "2"
    wall_s = serve.main(argv)["seconds"]
    free_memory(torch)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = serve.main(argv)
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in rows)
    check(busy_us > 0, "profile: the profiler saw no device time")
    print(f"profile: device busy {busy_us / 1e3:.1f} ms; profiled wall "
          f"{out['seconds'] * 1e3:.1f} ms, unprofiled wall "
          f"{wall_s * 1e3:.1f} ms -> device idle share "
          f"{1 - busy_us / 1e6 / wall_s:.3f} of the unprofiled run")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"  {e.self_device_time_total / 1e3:9.2f} ms "
              f"{100 * e.self_device_time_total / busy_us:5.1f}% "
              f"x{e.count:<6d} {e.key[:90]}")


QWEN_DENSE_ARGV = ["--arch", "qwen3-0.6b", "--no-reduced", "--num-layers",
                   "4", "--mode", "greedy", "--requests", "4",
                   "--prompt-len", "64", "--max-new", "16", "--cache-len",
                   "96", "--eos-id", "151936", "--device", "cuda",
                   "--seed", "1"]
LLAVA_DENSE_ARGV = ["--arch", "llava-1.5-7b", "--no-reduced", "--num-layers",
                    "4", "--mode", "greedy", "--xmodal-rescore",
                    "--requests", "4", "--prompt-len", "64", "--max-new",
                    "16", "--cache-len", str(IMAGE_TOKENS + 80),
                    "--image-pool", "2", "--eos-id", "32000",
                    "--device", "cuda", "--seed", "1"]


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
    return launches["cuda"]


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
    info = build.build_all()
    print(f"kernel build: {time.perf_counter() - t0:.1f}s wall, parallel")
    for name, rec in info.items():
        regs = [ln.strip() for ln in str(rec["log"]).splitlines()
                if "registers" in ln]
        print(f"  {name}: nvcc {rec['seconds']:.1f}s; " + " | ".join(regs))
        build.load(name)

    timer = Timer(torch)
    print("kernel phase:")
    timings = {"flash_attention": flash_phase(torch, ops, ref, timer),
               "decode_attention": decode_phase(torch, ops, ref, timer),
               "paged_decode_attention": paged_phase(torch, ops, ref, timer,
                                                     kv_quantize),
               **xmodal_phase(torch, ops, ref, timer)}
    for name, t in timings.items():
        lib = "null" if t["library_ms"] is None else f"{t['library_ms']:.4f}"
        print(f"  {name}: {t['shape']}: kernel {t['ms']:.4f} ms (call "
              f"{t['call_ms']:.4f} ms), plain "
              f"{t['plain_ms']:.4f} ms, library {lib} ms, bound "
              f"{t['bound_ms']:.4f} ms ({t['bound_by']})")

    # qwen3-0.6b, text requests
    runs = {}
    runs["qwen3-0.6b serve"], _ = serve_phase(
        torch, ops, serve, QWEN_ARGV,
        ("flash_attention", "paged_decode_attention"))
    free_memory(torch)
    profile_phase(torch, serve, QWEN_ARGV)
    free_memory(torch)
    runs["qwen3-0.6b dense check"] = dense_check(
        torch, ops, serve, QWEN_DENSE_ARGV,
        ("flash_attention", "decode_attention"))
    free_memory(torch)
    # llava-1.5-7b, image requests
    runs["llava-1.5-7b serve"], out = serve_phase(
        torch, ops, serve, LLAVA_ARGV,
        ("flash_attention", "paged_decode_attention", "xmodal_score_mean",
         "xmodal_score_max"))
    image_checks(torch, serve, LLAVA_ARGV, out)
    image_prefill_timing(torch, out, timer)
    del out
    free_memory(torch)
    profile_phase(torch, serve, LLAVA_ARGV)
    free_memory(torch)
    runs["llava-1.5-7b dense check"] = dense_check(
        torch, ops, serve, LLAVA_DENSE_ARGV,
        ("flash_attention", "decode_attention", "xmodal_score_mean",
         "xmodal_score_max"))

    # launches: the serve phases for the kernels the serving path runs,
    # the dense checks for the dense decode kernel (K3), which only the
    # dense impls run
    paths = {"decode_attention": ("qwen3-0.6b dense check",
                                  "llava-1.5-7b dense check")}
    serves = ("qwen3-0.6b serve", "llava-1.5-7b serve")
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
            **({"sdpa_on_gathered_ms": t["sdpa_on_gathered_ms"]}
               if "sdpa_on_gathered_ms" in t else {})})
    print("kernels: " + ", ".join(k["name"] for k in kernels))
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

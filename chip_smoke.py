#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. It
  1. prints the card's name and power limit (nvidia-smi);
  2. builds every CUDA kernel of the port from ``src/repro_torch/kernels/
     csrc`` with nvcc, one process per source, all at once;
  3. kernel phase: holds each kernel against its plain PyTorch version on
     the card (fp32 and bf16, head_dim 64 and 128, the serving shapes and
     ragged edges, int8/fp8 pools for the paged kernel) and times kernel,
     plain version and — where one PyTorch call computes the same function
     — ``scaled_dot_product_attention``, beside a bound from bytes and
     operations;
  4. serve phase: serves CAMD requests on full-width qwen3-0.6b through
     the port's serve entry point with ``--impl paged_cuda`` and checks
     that the flash and paged decode kernels carried it;
  5. profile: a shorter serve run of the same shapes under torch.profiler
     — device time by kernel and the device's idle share;
  6. dense check: at reduced depth, greedy streams of the plain (torch),
     dense-kernel (cuda) and paged-kernel (paged_cuda) engines must agree;
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


def fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


class Timer:
    """Per-launch CUDA-event timing with the L2 cache flushed before each
    launch (the serving path meets every layer's K/V cold)."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")

    def ms(self, fn, reps: int = 20, warmup: int = 3) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        total = 0.0
        for _ in range(reps):
            self.flush.zero_()
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
    t = dict(ms=timer.ms(lambda: ops.flash_attention(q, k, v)),
             plain_ms=timer.ms(lambda: ref.flash_attention_ref(q, k, v)))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    t["library_ms"] = timer.ms(lambda: F.scaled_dot_product_attention(
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
    t = dict(ms=timer.ms(lambda: ops.decode_attention(q, k, v, mask)),
             plain_ms=timer.ms(lambda: ref.decode_attention_ref(q, k, v,
                                                                mask)))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    am = mask[:, None, None, :]
    t["library_ms"] = timer.ms(lambda: F.scaled_dot_product_attention(
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
    t = dict(ms=timer.ms(lambda: ops.paged_decode_attention(q, kp, vp, bt,
                                                            ln)),
             plain_ms=timer.ms(lambda: ref.paged_decode_attention_ref(
                 q, kp, vp, bt, ln)))
    # no single PyTorch call reads a block table: library_ms stays null;
    # SDPA over the dense view gathered from the same pages is a yardstick
    k = kp[bt.long()].reshape(B, -1, Hkv, hd).transpose(1, 2)
    v = vp[bt.long()].reshape(B, -1, Hkv, hd).transpose(1, 2)
    am = (torch.arange(k.shape[2], device="cuda")[None, :] <
          ln[:, None])[:, None, None, :]
    qt = q.transpose(1, 2)
    t["library_ms"] = None
    t["sdpa_on_gathered_ms"] = timer.ms(
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


# ---------------------------------------------------------------------------
# serve phase and dense check
# ---------------------------------------------------------------------------

def serve_phase(torch, ops, serve):
    s = SERVE
    argv = ["--arch", "qwen3-0.6b", "--no-reduced", "--impl", "paged_cuda",
            "--mode", "camd", "--slots", str(s["slots"]),
            "--page-size", str(s["page"]), "--requests", str(s["requests"]),
            "--prompt-len", str(s["prompt"]), "--max-new", str(s["max_new"]),
            "--cache-len", str(CACHE_LEN), "--eos-id", "151936",
            "--device", "cuda", "--seed", "0"]
    print("serve phase: python -m repro_torch.launch.serve " + " ".join(argv))
    ops.reset_launches()
    out = serve.main(argv)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
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
    for name in ("flash_attention", "paged_decode_attention"):
        check(launches[name] > 0, f"serve: {name} was never launched")
    print(f"serve phase: {out['tokens_per_s']:.1f} tok/s "
          f"({eng.total_tokens} tokens in {out['seconds']:.2f}s, "
          f"{eng.total_steps} decode steps, {eng.macro_launches} launches); "
          f"launches {launches}")
    return launches, argv


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


def dense_check(torch, ops, serve):
    argv = ["--arch", "qwen3-0.6b", "--no-reduced", "--num-layers", "4",
            "--mode", "greedy", "--requests", "4",
            "--prompt-len", "64", "--max-new", "16", "--cache-len", "96",
            "--eos-id", "151936", "--device", "cuda", "--seed", "1"]
    streams, launches = {}, {}
    for impl in ("torch", "cuda", "paged_cuda"):
        print(f"dense check: --impl {impl}")
        ops.reset_launches()
        out = serve.main(argv + ["--impl", impl])
        torch.cuda.synchronize()
        launches[impl] = dict(ops.LAUNCHES)
        streams[impl] = [r.tokens.tolist() for r in
                         sorted(out["results"], key=lambda r: r.uid)]
    check(sum(launches["torch"].values()) == 0,
          "dense check: the plain engine launched a kernel")
    for name in ("flash_attention", "decode_attention"):
        check(launches["cuda"][name] > 0,
              f"dense check: {name} was never launched")
    for impl in ("cuda", "paged_cuda"):
        check(streams[impl] == streams["torch"],
              f"dense check: {impl} greedy streams differ from torch: "
              f"{streams[impl]} vs {streams['torch']}")
    print("dense check: greedy streams of torch, cuda and paged_cuda agree "
          f"({sum(len(s) for s in streams['torch'])} tokens)")
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
                                                     kv_quantize)}
    for name, t in timings.items():
        lib = "null" if t["library_ms"] is None else f"{t['library_ms']:.4f}"
        print(f"  {name}: {t['shape']}: kernel {t['ms']:.4f} ms, plain "
              f"{t['plain_ms']:.4f} ms, sdpa {lib} ms, bound "
              f"{t['bound_ms']:.4f} ms ({t['bound_by']})")

    serve_launches, argv = serve_phase(torch, ops, serve)
    profile_phase(torch, serve, argv)
    dense_launches = dense_check(torch, ops, serve)

    meta = {
        "flash_attention": ("kernels/flash_attention.py:89",
                            serve_launches["flash_attention"]),
        "decode_attention": ("kernels/decode_attention.py:81",
                             dense_launches["decode_attention"]),
        "paged_decode_attention": (
            "kernels/paged_decode_attention.py:171",
            serve_launches["paged_decode_attention"]),
    }
    kernels = []
    for name, (replaces, launches) in meta.items():
        t = timings[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": f"src/repro/{replaces}", "launches": launches,
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
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

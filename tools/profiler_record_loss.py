#!/usr/bin/env python3
"""Reproduce the profiler's record loss that ``chip_smoke.Timer`` works
around, on one NVIDIA GPU.

    python3 tools/profiler_record_loss.py

Run from the root of a checkout. In a fresh process, windows of 20 calls
of K4a's wrapper (``ops.xmodal_mean_sum`` at llava's shape, each after an
L2 flush) keep every device record. After one profile of many kernel
launches (300k, 600k, then 1M more), later windows lose records: the
first ones of the window, whatever time passes before the calls. For
each stage it prints, for windows opened four ways (nothing ahead of the
calls; one spinning kernel of ~1 ms; 20 ms of host sleep; the timer's
``HEAD_RECORDS`` spinning kernels of a few cycles), how many lost a
record of the calls, the fewest flush and K4a records a window kept, and
the head records kept. Takes about two minutes, most of it the large
profiles.
"""
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke as cs  # noqa: E402

WINDOWS = 20
REPS = 20


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("profiler_record_loss: no CUDA device available")
    from repro_torch.kernels import build, ops
    build.build_all(["xmodal_score"])
    build.load("xmodal_score")
    timer = cs.Timer(torch)
    g = torch.Generator(device="cuda").manual_seed(12)
    tok, vis = (torch.randn(1, n, 4096, generator=g, device="cuda")
                for n in (32, cs.IMAGE_TOKENS))
    mask = torch.ones(1, 32, device="cuda")

    def fn():
        ops.xmodal_mean_sum(tok, mask, vis)

    for _ in range(3):
        fn()

    def window(head):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            if head == "one 1 ms pad":
                torch.cuda._sleep(1 << 21)
            elif head == "host sleep 20 ms":
                time.sleep(0.02)
            elif head == "timer's head":
                timer._pad()
            for _ in range(REPS):
                timer._flush()
                fn()
            torch.cuda.synchronize()
        return cs._window_records(torch, prof, "xmodal_mean_kernel")

    def stage(label):
        print(f"{label}:")
        for head in ("none", "one 1 ms pad", "host sleep 20 ms",
                     "timer's head"):
            rows = [window(head) for _ in range(WINDOWS)]
            lost = sum(r["flush"] < REPS or r["call"] < REPS or
                       r["kinds"] < 2 for r in rows)
            print(f"  {head:17s} {lost:2d} of {WINDOWS} windows lost "
                  f"records; fewest kept: flush "
                  f"{min(r['flush'] for r in rows)}, K4a "
                  f"{min(r['call'] for r in rows)} of {REPS}; head "
                  f"{min(r['head'] for r in rows)}-"
                  f"{max(r['head'] for r in rows)}", flush=True)

    stage("fresh process")
    x = torch.zeros(16, device="cuda")
    for n in (300_000, 600_000, 1_000_000):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                x.add_(1)
            torch.cuda.synchronize()
        kept = sum(1 for e in prof.profiler.kineto_results.events()
                   if e.device_type() == torch.autograd.DeviceType.CUDA)
        stage(f"after a profile of {n} launches ({kept} records kept)")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Time the port's training on the host's CPU at full width under glibc's
default allocator and with large blocks kept in its heap, the setting
``chip_smoke.host_heap_kept`` makes for the host side of ``train_check``.

    python3 tools/host_heap_training.py

Run from the root of a checkout. Each run is a fresh process (the
allocator's settings and its heap belong to the process), in turns:
default, heap, heap, default. A run times four AdamW updates of one fp32
parameter of 160 M elements, then builds 3-layer full-width
recurrentgemma-2b (0.85 B parameters, its tied 256000-row table among
them) on the CPU and takes three ``training.train`` steps of 2 x 32
tokens, as ``chip_smoke.train_check`` does. Prints each run's update
times, build time, the steps' cumulative seconds and the last loss.
Needs about 20 GB of host memory and about five minutes; no GPU.
"""
import ctypes
import itertools
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

MODES = ("default", "heap", "heap", "default")
UPDATE_ELEMENTS = 160_000_000


def run(mode: str) -> None:
    if mode == "heap":
        from chip_smoke import M_MMAP_MAX, M_TRIM_THRESHOLD
        libc = ctypes.CDLL("libc.so.6")
        if not (libc.mallopt(M_MMAP_MAX, 0) == 1 and
                libc.mallopt(M_TRIM_THRESHOLD, 2 ** 31 - 1) == 1):
            raise SystemExit("mallopt refused the heap setting")
    import torch
    from repro_torch.config import TrainConfig
    from repro_torch.configs import get_config
    from repro_torch.data import lm_batches
    from repro_torch.models.model import build_model
    from repro_torch.training import train
    from repro_torch.training.optimizer import adamw_update, init_opt_state

    gen = torch.Generator().manual_seed(0)
    params = {"w": torch.randn(UPDATE_ELEMENTS, generator=gen)}
    grads = {"w": torch.randn(UPDATE_ELEMENTS, generator=gen)}
    state = init_opt_state(params)
    updates = []
    for _ in range(4):
        t0 = time.perf_counter()
        adamw_update(TrainConfig(), params, grads, state)
        updates.append(time.perf_counter() - t0)
    del params, grads, state

    cfg = get_config("recurrentgemma-2b").with_overrides(dtype="float32",
                                                         num_layers=3)
    data = list(itertools.islice(lm_batches(cfg.vocab_size, 2, 32, seed=0),
                                 3))
    t0 = time.perf_counter()
    model = build_model(cfg, torch.float32, device="cpu", seed=0)
    built = time.perf_counter() - t0
    tc = TrainConfig(total_steps=3, warmup_steps=1, learning_rate=1e-3)
    hist = train(model, tc, iter(data), steps=3, log_every=1)[2]
    print(f"{mode}: {torch.get_num_threads()} threads; AdamW on "
          f"{UPDATE_ELEMENTS} elements " +
          ", ".join(f"{u:.2f}" for u in updates) +
          f" s; recurrentgemma-2b 3 layers built in {built:.1f} s, three "
          "steps done at " + ", ".join(f"{h['elapsed_s']:.1f}" for h in hist)
          + f" s; last loss {hist[-1]['loss']:.7f}", flush=True)


def main() -> None:
    if len(sys.argv) > 1:
        run(sys.argv[1])
        return
    for mode in MODES:
        subprocess.run([sys.executable, __file__, mode], check=True,
                       timeout=600)


if __name__ == "__main__":
    main()

"""Training launcher of the port (``repro/launch/train.py``):

    python -m repro_torch.launch.train --arch qwen3-0.6b --steps 50 \\
        --batch 8 --seq 128

fp32 weights made from seed 0, AdamW with ``warmup_steps = steps // 10``
and the cosine schedule, the synthetic ``lm_batches`` stream (seed 0),
and a ``step N loss= acc=`` line every ``steps // 10`` steps and at the
last, as the reference prints them. Runs on the CUDA device unless
``--device cpu``. ``--reduced`` trains the CPU-smoke-size variant of the
config. Decoder-only configs train here, recurrent and hybrid ones
(mamba2-780m, recurrentgemma-2b) included; the batches carry no evidence,
as the reference's, so an encoder-decoder (seamless-m4t-large-v2) raises
in its forward: train it through ``training.train`` on ``lm_batches(...,
evidence=...)``. Sharded training (``--mesh`` other than 1x1) is not
ported, and a config whose weights, gradients and two moments (16 bytes
a parameter in fp32) exceed the device's memory is refused before
anything is allocated.
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Optional

import torch

from repro_torch import device_memory_bytes, resolve_device
from repro_torch.config import TrainConfig
from repro_torch.configs import get_config
from repro_torch.data import lm_batches
from repro_torch.models.model import build_model
from repro_torch.training import save_checkpoint, train

# fp32 weights, gradients, and AdamW's m and v
TRAIN_BYTES_PER_PARAM = 16


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--mesh", default="1x1", help="DATAxMODEL; only 1x1")
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-test-sized variant")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt", default="",
                    help="save the trained weights to CKPT.npz/.json")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> List[Dict[str, float]]:
    """Train and return the history: every step's metrics as floats
    (loss, nll, accuracy, perplexity, grad_norm, lr and, for an MoE model,
    moe_lb_loss and moe_drop_frac), its index under "step", the wall
    seconds since training began under "elapsed_s" and the step's own
    (to its metrics on the host) under "seconds"."""
    args = parse_args(argv)
    if tuple(int(x) for x in args.mesh.split("x")) != (1, 1):
        raise SystemExit(f"--mesh {args.mesh}: sharded training is not "
                         "ported yet (ROADMAP Queue 1, item 5)")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    cfg = cfg.with_overrides(dtype="float32")
    device = resolve_device(args.device)
    total = device_memory_bytes(device)
    need = cfg.num_params() * TRAIN_BYTES_PER_PARAM
    if total is not None and need > total:
        raise SystemExit(
            f"{cfg.name}: fp32 weights, gradients and AdamW moments take "
            f"{need / 1e9:.1f} GB, more than the {total / 1e9:.1f} GB of "
            f"{device}; training it needs sharding (ROADMAP Queue 1, "
            "item 5)")
    tc = TrainConfig(total_steps=args.steps, warmup_steps=args.steps // 10,
                     learning_rate=args.lr, microbatches=args.microbatches)
    model = build_model(cfg, torch.float32, device=device, seed=tc.seed)
    every = max(args.steps // 10, 1)

    def log(m):
        if m["step"] % every == 0 or m["step"] == args.steps - 1:
            print(f"step {m['step']:>5} loss={m['loss']:.4f} "
                  f"acc={m['accuracy']:.3f} ({m['elapsed_s']:.1f}s)",
                  flush=True)

    data = lm_batches(cfg.vocab_size, args.batch, args.seq, seed=0)
    _, _, history = train(model, tc, data, steps=args.steps, log_every=1,
                          callback=log)
    prev = 0.0
    for h in history:
        h["seconds"], prev = h["elapsed_s"] - prev, h["elapsed_s"]
    if args.ckpt:
        save_checkpoint(args.ckpt, model.state_dict(), step=args.steps)
        print(f"saved {args.ckpt}.npz")
    return history


if __name__ == "__main__":
    main()

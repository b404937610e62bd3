"""PyTorch/CUDA port of the CAMD serving stack.

Mirrors the module layout of the JAX package ``repro`` (models, sampling,
CAMD core, serving engine, launchers) and runs its attention kernels as
hand-written CUDA C++ for Hopper (``kernels/csrc``). It imports neither
JAX nor ``repro``. Entry points run on the CUDA device unless the caller
passes ``device="cpu"``; on CPU tensors every kernel wrapper runs its
plain PyTorch version instead.
"""
import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card by default. With no
    GPU and no explicit device this raises instead of falling back to the
    CPU quietly."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def device_memory_bytes(device: torch.device):
    """Total memory of a CUDA device; None for the CPU (not checked)."""
    if device.type != "cuda":
        return None
    return torch.cuda.get_device_properties(device).total_memory

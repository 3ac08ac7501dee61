"""PyTorch/CUDA port of the SiPipe reproduction.

A second package beside the JAX reference (``repro``): the same serving
engine, scheduler and paged KV substrate, with every TPU kernel on its
path replaced by a hand-written CUDA kernel for Hopper (``csrc/``).  The
port imports nothing of ``repro`` or ``jax``; host modules it needs are
copied (ROADMAP.md, north star).
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another.  Raises when CUDA is asked for (explicitly or by default)
    and absent — the port never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU")
    return dev

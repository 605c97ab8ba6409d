"""The PyTorch/CUDA port of ``repro``, grown slice by slice beside it.

It imports torch and numpy, never jax, and nothing of ``repro``: what it
needs from there it keeps as its own copy. Module names mirror
``repro``'s. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; with no card the default fails instead of falling back.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless one is named.

    A CUDA device with no card raises. On CUDA, float32 matrix products
    and convolutions are pinned to full float32 (no TF32), as the JAX
    package's float32 reference computes them."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} asked for, but torch sees no "
                               "CUDA card; pass device='cpu' (--device cpu) "
                               "to run the plain versions on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev

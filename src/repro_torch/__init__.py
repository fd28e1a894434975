"""PyTorch/CUDA port of the grid-clustering RSO detection pipeline.

Laid out like ``repro`` (the JAX package, which stays the reference):
``core`` holds the detection chain, ``data`` the synthetic recordings and
``kernels`` the hand-written CUDA kernels with their plain PyTorch
versions. Entry points take ``device=`` and run on the card unless the
caller asks for the CPU; there is no silent fallback.
"""
from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: str | torch.device | None = DEFAULT_DEVICE) -> torch.device:
    """The device an entry point runs on: ``"cuda"`` unless told otherwise.

    Raises ``RuntimeError`` when a CUDA device is asked for (the default)
    and none is present, so a run on a host without a card never
    silently becomes a CPU run.
    """
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch route"
        )
    return dev

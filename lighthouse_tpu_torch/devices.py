"""Helpers that ``torch_backend`` and ``blsrt`` share: where a call runs,
and the power-of-two sizes that batches are padded to."""

from __future__ import annotations

import torch


def next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def resolve_device(device, who: str) -> torch.device:
    """``device``, or the card when it is None; with no card that raises
    instead of running on the host. A CUDA device gets its index."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{who}: no CUDA device; pass device='cpu' to run the plain "
                "versions on the host"
            )
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device

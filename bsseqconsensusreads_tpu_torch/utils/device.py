"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU
(device='cpu', as the tests do). With no card and no device='cpu' they
raise: a run never falls back to the CPU quietly.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """torch.device for `device` (None = 'cuda'); raises when the card is
    asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"the port runs on 'cuda' or 'cpu', not {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the host"
        )
    return dev

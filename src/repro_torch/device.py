"""Device selection for the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card.  Without a CUDA device that raises — the
    port never moves to the CPU on its own; ask for it with
    ``device="cpu"``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device=\"cpu\" to run "
                "the plain PyTorch path on the CPU")
        return torch.device("cuda")
    return torch.device(device)

"""Public entry points of the live admission kernel, one launch an op: the
kernel for CUDA state, its plain version for CPU state.  Each updates
``state`` in place and returns ``out`` (``[count, q_len, dropped,
invalid]`` then the op's lanes)."""
from __future__ import annotations

import torch

from .live_admission import live_admission_cuda


def admit(state, ev: torch.Tensor) -> torch.Tensor:
    """BF-J over the (rid, size, live) lanes of ``ev``; ``out[4:]`` holds
    each lane's replica, -1 when queued, dropped or masked."""
    return live_admission_cuda("admit", state, ev)


def refill(state, replica: int) -> torch.Tensor:
    """BF-S on ``replica``; ``out[4:4+Qcap]`` the placed ids,
    ``out[4+Qcap:]`` their replicas, ``out[0]`` how many."""
    return live_admission_cuda("refill", state, a0=replica)


def release(state, ev: torch.Tensor) -> torch.Tensor:
    """Release the (replica, size, live) lanes of ``ev``; invalid ones are
    counted in ``state.invalid``."""
    return live_admission_cuda("release", state, ev)


def tick(state, ev: torch.Tensor) -> torch.Tensor:
    """All releases of ``ev``, then BF-S on each replica they name in
    ascending order; placements as :func:`refill`'s."""
    return live_admission_cuda("tick", state, ev)


def push_front(state, rid: int, size: int) -> torch.Tensor:
    """Insert (rid, size) at the queue head; a full queue drops its
    tail."""
    return live_admission_cuda("push_front", state, a0=rid, a1=size)

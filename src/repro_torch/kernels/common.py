"""Shared plumbing for the port's scheduler kernels.

Every kernel family (``kernels/bfjs``, ``kernels/vqs``, ...) follows the
same layout: ``csrc/<name>.cu`` holds the hand-written CUDA kernel,
``<name>.py`` its ctypes wrapper and launch counter, ``ref.py`` the plain
PyTorch version, ``ops.py`` the public entry point.  A wrapper launches the
kernel for CUDA tensors and runs the plain version for CPU tensors only.
"""
from __future__ import annotations

import warnings

#: f32 infeasibility sentinel used by the float kernels (~f32 max).
BIG = 3.4e38

#: Dynamic shared memory one thread block may use on an H100 (227 KB).  The
#: kernels keep a whole ensemble member's simulation state there, so this is
#: the gate that :func:`cuda_precheck` applies.
SMEM_LIMIT_BYTES = 232_448


class GracefulDegradationWarning(UserWarning):
    """An ``engine="cuda"`` request was served by the scan engine instead.

    Raised as a *warning* (never silently) when the kernel does not
    implement the request — a fault plane, or simulation state over the
    shared-memory limit.  The scan engine is bit-identical; pass
    ``strict=True`` to get a hard error instead."""


class LaunchCounter:
    """Number of kernel launches a wrapper made; ``reset()`` before a run,
    read ``count`` after it."""

    def __init__(self) -> None:
        self.count = 0

    def reset(self) -> None:
        self.count = 0


def cuda_precheck(kernel: str, *, nbytes: int, fault_plane: bool = False,
                  strict: bool = False) -> bool:
    """Gate an ``engine="cuda"`` dispatch.

    Returns True when the kernel may run.  A request it does not implement
    — a fault plane, or ``nbytes`` of per-block shared memory over
    :data:`SMEM_LIMIT_BYTES` — either raises ``ValueError``
    (``strict=True``) or emits a loud :class:`GracefulDegradationWarning`
    and returns False, so the caller runs the scan engine on the same
    device.  A kernel that fails to build or launch, or a shape it cannot
    hold, is not gated here: that always raises."""
    reason = None
    if fault_plane:
        reason = (f"kernel {kernel!r} does not implement fault-plane "
                  "preemption")
    elif nbytes > SMEM_LIMIT_BYTES:
        reason = (f"kernel {kernel!r} needs {nbytes} bytes of shared "
                  f"memory per block, over the {SMEM_LIMIT_BYTES}-byte "
                  "limit")
    if reason is None:
        return True
    if strict:
        raise ValueError(
            f"{reason}; engine=\"cuda\" cannot honour this request "
            "(strict=True — rerun with engine=\"scan\" or strict=False)")
    warnings.warn(f"{reason}; falling back to the bit-identical scan "
                  "engine", GracefulDegradationWarning, stacklevel=3)
    return False


def ensemble_plane_bytes(G: int, T: int, *, stream_lanes: int,
                         out_lanes: int) -> int:
    """Device footprint of one Monte-Carlo kernel launch: the (G, T, lanes)
    pre-generated stream planes in plus the (G, T, lanes) per-slot
    trajectory planes out (all 4-byte dtypes), plus the per-member scalar
    counters."""
    return 4 * G * (T * (stream_lanes + out_lanes) + 2)


def resolve_windows(T: int, window: int | None) -> tuple[int, int]:
    """Split a horizon into equal time windows: ``(TW, NW)``.

    ``window=None`` means the whole horizon in one window; a window that
    does not divide the horizon is an error.  The CUDA kernels loop over
    every slot inside one block, so the window only has to be valid."""
    TW = T if window is None else window
    if TW <= 0 or T % TW:
        raise ValueError(f"window {TW} must divide horizon {T}")
    return TW, T // TW

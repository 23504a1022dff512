"""Public entry point of the fused multi-resource BF-J/S kernel: the kernel
for CUDA tensors, its plain version for CPU tensors."""
from __future__ import annotations

from ...core.engine.bfjs_mr import _lift_sizes, _norm_capacity
from ...core.engine.streams import PolicyResult, SchedStreams, \
    resolve_work_steps
from .bfjs_mr import bfjs_mr_cuda, check_shape, load


def bfjs_mr_shared_bytes(L: int, K: int, Qcap: int, A_max: int,
                         R: int) -> int:
    """Shared memory of one block of ``csrc/bfjs_mr.cu``, read from the
    built kernel, which keeps per-server occupancy and departure caches
    there and moves the queue to its global workspace when it does not
    fit.  ``cuda_precheck`` checks it against the per-block limit before
    launching; an R the kernel has no instance of raises
    ``NotImplementedError``.  Builds the kernel on first use."""
    check_shape(R)
    return load().bfjs_mr_shared_bytes(L, K, Qcap, A_max, R)


def bfjs_mr_simulate(streams: SchedStreams, L: int, K: int, Qcap: int,
                     A_max: int, work_steps: int | None = None,
                     capacity: tuple[float, ...] | float = 1.0,
                     window: int | None = None) -> PolicyResult:
    """Fused-kernel Monte-Carlo multi-resource BF-J/S: one thread block per
    member of the (G, ...)-shaped streams (squeezed R=1 sizes are lifted).
    Fault planes are not implemented by the kernel; the engine gate
    (``cuda_precheck``) routes them to the scan engine."""
    if streams.up is not None:
        raise ValueError("the bfjs_mr kernel does not implement fault "
                         "planes")
    streams = _lift_sizes(streams)
    capacity = _norm_capacity(capacity, int(streams.sizes.shape[-1]))
    return bfjs_mr_cuda(streams.n, streams.sizes, streams.durs, L=L, K=K,
                        Qcap=Qcap, A_max=A_max,
                        work_steps=resolve_work_steps(work_steps, A_max),
                        capacity=capacity, window=window)

"""Public entry point of the fused BF-J/S kernel: the kernel for CUDA
tensors, its plain version for CPU tensors."""
from __future__ import annotations

from ...core.engine.streams import PolicyResult, SchedStreams, \
    resolve_work_steps
from .bfjs import bfjs_cuda


def bfjs_scratch_bytes(L: int, K: int, Qcap: int, A_max: int) -> int:
    """Dynamic shared memory of one kernel block: srv and dep (L, K) with
    rows padded to an odd stride ``K | 1``, queue (Qcap) f32, row sums (L)
    f32, landed positions (A_max) i32 and freed flags (L) bytes rounded up
    to 4 — the layout of ``csrc/bfjs.cu``.  Checked against the per-block
    limit by ``kernels.common.cuda_precheck`` before launching."""
    words = 2 * L * (K | 1) + Qcap + L + A_max
    return 4 * words + 4 * ((L + 3) // 4)


def bfjs_simulate(streams: SchedStreams, L: int, K: int, Qcap: int,
                  A_max: int, work_steps: int | None = None,
                  window: int | None = None) -> PolicyResult:
    """Fused-kernel Monte-Carlo BF-J/S: one thread block per member of the
    (G, ...)-shaped streams.  Fault planes are not implemented by the
    kernel; the engine gate (``cuda_precheck``) routes them to the scan
    engine."""
    if streams.up is not None:
        raise ValueError("the bfjs kernel does not implement fault planes")
    return bfjs_cuda(streams.n, streams.sizes, streams.durs, L=L, K=K,
                     Qcap=Qcap, A_max=A_max,
                     work_steps=resolve_work_steps(work_steps, A_max),
                     window=window)

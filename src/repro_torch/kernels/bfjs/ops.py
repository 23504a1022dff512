"""Public entry point of the fused BF-J/S kernel: the kernel for CUDA
tensors, its plain version for CPU tensors."""
from __future__ import annotations

from ...core.engine.streams import PolicyResult, SchedStreams, \
    resolve_work_steps
from .bfjs import bfjs_cuda


def bfjs_scratch_bytes(L: int, K: int, Qcap: int, A_max: int) -> int:
    """Dynamic shared memory of one kernel block, the layout of
    ``csrc/bfjs.cu`` (``bfjs_shared_bytes``): two occupancy snapshots of
    the row sums (L rounded up to 32, f32 each), srv and dep (L, K) with
    rows padded to an odd stride ``K | 1``, queue (Qcap) f32, row sums,
    their residuals' order keys and next departures (L each), landed
    positions (A_max) i32, the freed and live masks (32 lanes x
    ceil(ceil(L / 32) / 32) words each) and two slot buffers of streams
    (count, A_max sizes, A_max + 4 BF-S and A_max BF-J duration lanes).
    Checked against the per-block limit by ``kernels.common.cuda_precheck``
    before launching."""
    lp = (L + 31) // 32 * 32
    mask_words = ((L + 31) // 32 + 31) // 32
    slot_words = 1 + 2 * A_max + min(A_max + 4, L * K + A_max)
    words = (2 * lp + 2 * L * (K | 1) + Qcap + 3 * L + A_max
             + 2 * 32 * mask_words + 2 * slot_words)
    return 4 * words


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

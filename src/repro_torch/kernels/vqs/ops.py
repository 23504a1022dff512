"""Public entry point of the fused VQS kernel: the kernel for CUDA tensors,
its plain version for CPU tensors."""
from __future__ import annotations

from ...core.engine.streams import PolicyResult, SchedStreams, \
    resolve_work_steps
from ...core.engine.vqs import _default_drain
from .vqs import shared_bytes, vqs_cuda


def vqs_scratch_bytes(J: int, L: int, K: int, Qcap: int, A_max: int) -> int:
    """Shared memory of one block of ``csrc/vqs.cu``, read from the built
    kernel, which keeps the per-server aggregates there and moves the rings
    to its global workspace when they do not fit.  ``cuda_precheck``
    checks it against the per-block limit before launching; a J the kernel
    cannot hold raises ``NotImplementedError``."""
    return shared_bytes("vqs", J, L, K, Qcap, A_max)


def vqs_simulate(streams: SchedStreams, J: int, L: int, K: int, Qcap: int,
                 A_max: int, work_steps: int | None = None,
                 drain: int | None = None,
                 window: int | None = None) -> PolicyResult:
    """Fused-kernel Monte-Carlo VQS: one thread block per member of the
    (G, ...)-shaped streams.  Fault planes are not implemented by the
    kernel; the engine gate (``cuda_precheck``) routes them to the scan
    engine."""
    if streams.up is not None:
        raise ValueError("the vqs kernel does not implement fault planes")
    return vqs_cuda(streams.n, streams.sizes, streams.durs, J=J, L=L, K=K,
                    Qcap=Qcap, A_max=A_max,
                    work_steps=resolve_work_steps(work_steps, A_max),
                    drain=drain if drain is not None
                    else _default_drain(K, J),
                    window=window)

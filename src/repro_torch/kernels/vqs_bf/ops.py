"""Public entry point of the fused VQS-BF kernel: the kernel for CUDA
tensors, its plain version for CPU tensors."""
from __future__ import annotations

from ...core.engine.streams import PolicyResult, SchedStreams, \
    resolve_work_steps
from ..vqs.vqs import shared_bytes
from .vqs_bf import vqs_bf_cuda


def vqs_bf_scratch_bytes(J: int, L: int, K: int, Qcap: int,
                         A_max: int) -> int:
    """Shared memory of one block of ``csrc/vqs_bf.cu``, read from the
    built kernel (see ``vqs_scratch_bytes``); a J or K the kernel cannot
    hold raises ``NotImplementedError``."""
    return shared_bytes("vqs_bf", J, L, K, Qcap, A_max)


def vqs_bf_simulate(streams: SchedStreams, J: int, L: int, K: int,
                    Qcap: int, A_max: int, work_steps: int | None = None,
                    window: int | None = None) -> PolicyResult:
    """Fused-kernel Monte-Carlo VQS-BF: one thread block per member of the
    (G, ...)-shaped streams.  Fault planes are not implemented by the
    kernel; the engine gate routes them to the scan engine."""
    if streams.up is not None:
        raise ValueError("the vqs_bf kernel does not implement fault planes")
    return vqs_bf_cuda(streams.n, streams.sizes, streams.durs, J=J, L=L, K=K,
                       Qcap=Qcap, A_max=A_max,
                       work_steps=resolve_work_steps(work_steps, A_max),
                       window=window)

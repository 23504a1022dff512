"""Plain PyTorch version of the fused VQS-BF slot-step kernel: the port's
scan engine (``core.engine.vqs_bf.run_vqs_bf_streams``) run batched over
the ensemble axis.  The kernel must reproduce its trajectories exactly."""
from __future__ import annotations

from ...core.engine.streams import PolicyResult, SchedStreams
from ...core.engine.vqs_bf import run_vqs_bf_streams


def vqs_bf_ref(n, sizes, durs, J: int, L: int, K: int, Qcap: int,
               A_max: int, work_steps: int | None = None) -> PolicyResult:
    """n (G, T) int32, sizes (G, T, A_max) f32, durs (G, T, D) int32 with
    the per-arrival durations in the last A_max lanes -> PolicyResult with
    (G, ...)-shaped fields."""
    return run_vqs_bf_streams(SchedStreams(n, sizes, durs), J=J, L=L, K=K,
                              Qcap=Qcap, A_max=A_max, work_steps=work_steps)

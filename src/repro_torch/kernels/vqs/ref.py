"""Plain PyTorch version of the fused VQS slot-step kernel.

It IS the port's scan engine (``core.engine.vqs.run_vqs_streams``) run
batched over the ensemble axis, as the JAX package's ``kernels/vqs/ref.py``
is its scan engine under ``vmap``: the kernel must reproduce its
trajectories exactly, occupancy included."""
from __future__ import annotations

from ...core.engine.streams import PolicyResult, SchedStreams
from ...core.engine.vqs import run_vqs_streams


def vqs_ref(n, sizes, durs, J: int, L: int, K: int, Qcap: int, A_max: int,
            work_steps: int | None = None,
            drain: int | None = None) -> PolicyResult:
    """n (G, T) int32, sizes (G, T, A_max) f32, durs (G, T, D) int32 with
    the per-arrival durations in the last A_max lanes -> PolicyResult with
    (G, ...)-shaped fields."""
    return run_vqs_streams(SchedStreams(n, sizes, durs), J=J, L=L, K=K,
                           Qcap=Qcap, A_max=A_max, work_steps=work_steps,
                           drain=drain)

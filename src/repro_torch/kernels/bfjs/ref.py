"""Plain PyTorch version of the fused BF-J/S slot-step kernel.

It IS the port's scan engine (``core.engine.bfjs.run_bfjs_streams``) run
batched over the ensemble axis, as the JAX package's ``kernels/bfjs/ref.py``
is its scan engine under ``vmap``: the kernel must reproduce its
trajectories exactly."""
from __future__ import annotations

from ...core.engine.bfjs import run_bfjs_streams
from ...core.engine.streams import PolicyResult, SchedStreams


def bfjs_ref(n, sizes, durs, L: int, K: int, Qcap: int, A_max: int,
             work_steps: int | None = None) -> PolicyResult:
    """n (G, T) int32, sizes (G, T, A_max) f32, durs (G, T, L*K+A_max)
    int32 -> PolicyResult with (G, ...)-shaped fields."""
    return run_bfjs_streams(SchedStreams(n, sizes, durs), L=L, K=K,
                            Qcap=Qcap, A_max=A_max, work_steps=work_steps)

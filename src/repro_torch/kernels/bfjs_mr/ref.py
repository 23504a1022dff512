"""Plain PyTorch version of the fused multi-resource BF-J/S kernel.

It IS the port's scan engine (``core.engine.bfjs_mr.run_bfjs_mr_streams``)
run batched over the ensemble axis, as the JAX package's
``kernels/bfjs_mr/ref.py`` is its scan engine under ``vmap``: the kernel
must reproduce its trajectories exactly, occupancy included."""
from __future__ import annotations

from ...core.engine.bfjs_mr import run_bfjs_mr_streams
from ...core.engine.streams import PolicyResult, SchedStreams


def bfjs_mr_ref(n, sizes, durs, L: int, K: int, Qcap: int, A_max: int,
                work_steps: int | None = None,
                capacity: tuple[float, ...] = (1.0,)) -> PolicyResult:
    """n (G, T) int32, sizes (G, T, A_max, R) f32, durs (G, T, D) int32 with
    the per-arrival durations in the last A_max lanes -> PolicyResult with
    (G, ...)-shaped fields."""
    return run_bfjs_mr_streams(SchedStreams(n, sizes, durs), L=L, K=K,
                               Qcap=Qcap, A_max=A_max, work_steps=work_steps,
                               capacity=capacity)

"""ctypes wrapper of the fused VQS-BF slot-step kernel
(``csrc/vqs_bf.cu``).

For CUDA tensors :func:`vqs_bf_cuda` launches the kernel (or raises); for
CPU tensors it runs the plain version, ``ref.vqs_bf_ref``.  ``launches``
counts kernel launches only."""
from __future__ import annotations

import torch

from ...core.engine.streams import PolicyResult
from ..common import LaunchCounter, resolve_windows
from ..vqs.vqs import check_inputs, check_shape, launch
from .ref import vqs_bf_ref

launches = LaunchCounter()


def vqs_bf_cuda(n: torch.Tensor, sizes: torch.Tensor, durs: torch.Tensor,
                *, J: int, L: int, K: int, Qcap: int, A_max: int,
                work_steps: int, window: int | None = None) -> PolicyResult:
    """Run the fused VQS-BF slot engine on an ensemble of clusters.

    Same streams as the VQS kernel: n (G, T) int32, sizes (G, T, A_max)
    f32, durs (G, T, D) int32 with the per-arrival durations in the last
    A_max lanes.  Returns a PolicyResult of (G, T) trajectories and (G,)
    counters.  ``window`` must divide T.  A J or K the kernel cannot hold
    raises ``NotImplementedError`` on either device."""
    check_shape("vqs_bf", J, K)
    check_inputs(n, sizes, durs, A_max)
    resolve_windows(n.shape[1], window)
    if n.device.type == "cpu":
        return vqs_bf_ref(n, sizes, durs, J=J, L=L, K=K, Qcap=Qcap,
                          A_max=A_max, work_steps=work_steps)
    res = launch("vqs_bf", n, sizes, durs, J=J, L=L, K=K, Qcap=Qcap,
                 A_max=A_max, work_steps=work_steps, drain=0)
    if n.shape[0] > 0:
        launches.count += 1
    return res

"""ctypes wrapper of the fused BF-J/S slot-step kernel (``csrc/bfjs.cu``).

For CUDA tensors :func:`bfjs_cuda` launches the kernel (or raises); for
CPU tensors it runs the plain version, ``ref.bfjs_ref``.  ``launches``
counts kernel launches only."""
from __future__ import annotations

import ctypes

import torch

from ...core.engine.streams import PolicyResult
from .. import build
from ..common import LaunchCounter, resolve_windows
from .ref import bfjs_ref

launches = LaunchCounter()

_P, _I = ctypes.c_void_p, ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = build.load("bfjs")
    lib.bfjs_launch.restype = ctypes.c_int
    lib.bfjs_launch.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                _P, _P, _P, _P, _P, _P]
    return lib


def _check_inputs(n, sizes, durs, L, K, A_max):
    if n.ndim != 2:
        raise ValueError(f"n must be (G, T), got {tuple(n.shape)}")
    G, T = n.shape
    expect = {"n": (n, (G, T), torch.int32),
              "sizes": (sizes, (G, T, A_max), torch.float32),
              "durs": (durs, (G, T, L * K + A_max), torch.int32)}
    for name, (x, shape, dtype) in expect.items():
        if tuple(x.shape) != shape or x.dtype != dtype:
            raise ValueError(f"{name} must be {shape} {dtype}, got "
                             f"{tuple(x.shape)} {x.dtype}")
        if x.device != n.device:
            raise ValueError(f"{name} is on {x.device}, n on {n.device}")


def bfjs_cuda(n: torch.Tensor, sizes: torch.Tensor, durs: torch.Tensor, *,
              L: int, K: int, Qcap: int, A_max: int, work_steps: int,
              window: int | None = None) -> PolicyResult:
    """Run the fused BF-J/S slot engine on an ensemble of clusters.

    n (G, T) int32, sizes (G, T, A_max) f32, durs (G, T, L*K+A_max) int32 —
    one pre-generated stream set per member.  Returns a PolicyResult of
    (G, T) trajectories and (G,) counters (fault counters zero: the kernel
    simulates fault-free clusters).  ``window`` must divide T; the kernel
    loops over every slot inside one thread block."""
    _check_inputs(n, sizes, durs, L, K, A_max)
    G, T = n.shape
    resolve_windows(T, window)
    if n.device.type == "cpu":
        return bfjs_ref(n, sizes, durs, L=L, K=K, Qcap=Qcap, A_max=A_max,
                        work_steps=work_steps)
    if n.device.type != "cuda":
        raise ValueError(f"bfjs kernel runs on CUDA tensors, got {n.device}")
    n, sizes, durs = n.contiguous(), sizes.contiguous(), durs.contiguous()
    dev = n.device
    qlen = torch.empty((G, T), dtype=torch.int32, device=dev)
    occ = torch.empty((G, T), dtype=torch.float32, device=dev)
    ndep = torch.empty((G, T), dtype=torch.int32, device=dev)
    dropped = torch.zeros(G, dtype=torch.int32, device=dev)
    trunc = torch.zeros(G, dtype=torch.int32, device=dev)
    if G > 0:
        lib = _lib()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.bfjs_launch(
                n.data_ptr(), sizes.data_ptr(), durs.data_ptr(), G, T, L, K,
                Qcap, A_max, work_steps, qlen.data_ptr(), occ.data_ptr(),
                ndep.data_ptr(), dropped.data_ptr(), trunc.data_ptr(), stream)
        build.check(lib, err, "bfjs kernel launch")
        launches.add()
    z = torch.zeros_like(dropped)
    return PolicyResult(qlen, occ, torch.cumsum(ndep, 1, dtype=torch.int32),
                        dropped, trunc, z, z, z)

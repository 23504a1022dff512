"""ctypes wrapper of the fused multi-resource BF-J/S slot-step kernel
(``csrc/bfjs_mr.cu``).

For CUDA tensors :func:`bfjs_mr_cuda` launches the kernel (or raises); for
CPU tensors it runs the plain version, ``ref.bfjs_mr_ref``.  ``launches``
counts kernel launches only."""
from __future__ import annotations

import ctypes

import torch

from ...core.engine.streams import PolicyResult
from ...core.quantize import RES
from .. import build
from ..common import LaunchCounter, resolve_windows
from .ref import bfjs_mr_ref

launches = LaunchCounter()

_P, _I, _S = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
#: (L, K, Qcap, A_max, R) of the layout functions the kernel exports
_LAYOUT_ARGS = [_I, _I, _I, _I, _I]
#: R is a template parameter of the kernel, instantiated for 1..MAX_R.
MAX_R = 4


def load() -> ctypes.CDLL:
    """The built library of ``csrc/bfjs_mr.cu`` with the signatures of its
    ``bfjs_mr_launch``, ``bfjs_mr_shared_bytes`` and
    ``bfjs_mr_workspace_bytes`` entry points set."""
    lib = build.load("bfjs_mr")
    lib.bfjs_mr_launch.restype = ctypes.c_int
    lib.bfjs_mr_launch.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                   _I, _I, _P, _P, _P, _P, _P, _P, _P, _P]
    for fn in (lib.bfjs_mr_shared_bytes, lib.bfjs_mr_workspace_bytes):
        fn.restype = _S
        fn.argtypes = _LAYOUT_ARGS
    return lib


def check_shape(R: int) -> None:
    """Raise ``NotImplementedError`` for a resource count the kernel has
    no instance of, before anything is built or launched."""
    if not 1 <= R <= MAX_R:
        raise NotImplementedError(
            f"the bfjs_mr kernel takes 1 <= R <= {MAX_R} resources (R={R})")


def check_inputs(n, sizes, durs, A_max: int) -> int:
    """n (G, T) int32, sizes (G, T, A_max, R) f32 and durs (G, T, D) int32
    with D >= A_max, all on one device; returns R."""
    if n.ndim != 2:
        raise ValueError(f"n must be (G, T), got {tuple(n.shape)}")
    G, T = n.shape
    if sizes.ndim != 4:
        raise ValueError(f"sizes must be (G, T, A_max, R), got "
                         f"{tuple(sizes.shape)}")
    R = int(sizes.shape[3])
    if durs.ndim != 3 or durs.shape[:2] != (G, T) \
            or durs.shape[2] < A_max:
        raise ValueError(f"durs must be (G={G}, T={T}, D >= {A_max}), got "
                         f"{tuple(durs.shape)}")
    expect = {"n": (n, (G, T), torch.int32),
              "sizes": (sizes, (G, T, A_max, R), torch.float32),
              "durs": (durs, tuple(durs.shape), torch.int32)}
    for name, (x, shape, dtype) in expect.items():
        if tuple(x.shape) != shape or x.dtype != dtype:
            raise ValueError(f"{name} must be {shape} {dtype}, got "
                             f"{tuple(x.shape)} {x.dtype}")
        if x.device != n.device:
            raise ValueError(f"{name} is on {x.device}, n on {n.device}")
    return R


def bfjs_mr_cuda(n: torch.Tensor, sizes: torch.Tensor, durs: torch.Tensor,
                 *, L: int, K: int, Qcap: int, A_max: int, work_steps: int,
                 capacity: tuple[float, ...],
                 window: int | None = None) -> PolicyResult:
    """Run the fused multi-resource BF-J/S slot engine on an ensemble.

    n (G, T) int32, sizes (G, T, A_max, R) f32, durs (G, T, D) int32 with
    the per-arrival durations in the last A_max lanes (D = L*K + A_max from
    ``make_streams``, D = A_max from ``streams_from_trace``); ``capacity``
    the R per-resource server capacities.  Returns a PolicyResult of (G, T)
    trajectories, (G, T, R) occupancy and (G,) counters (fault counters
    zero: the kernel simulates fault-free clusters).  ``window`` must
    divide T; the kernel loops over every slot inside one block.  An R the
    kernel has no instance of raises ``NotImplementedError`` on either
    device."""
    R = check_inputs(n, sizes, durs, A_max)
    check_shape(R)
    if len(capacity) != R:
        raise ValueError(
            f"capacity has {len(capacity)} entries for R={R} resources")
    resolve_windows(n.shape[1], window)
    if n.device.type == "cpu":
        return bfjs_mr_ref(n, sizes, durs, L=L, K=K, Qcap=Qcap, A_max=A_max,
                           work_steps=work_steps, capacity=capacity)
    G, T = n.shape
    n, sizes, durs = n.contiguous(), sizes.contiguous(), durs.contiguous()
    dev = n.device
    qlen = torch.empty((G, T), dtype=torch.int32, device=dev)
    occ = torch.empty((G, T, R), dtype=torch.float32, device=dev)
    ndep = torch.empty((G, T), dtype=torch.int32, device=dev)
    dropped = torch.zeros(G, dtype=torch.int32, device=dev)
    trunc = torch.zeros(G, dtype=torch.int32, device=dev)
    if G > 0:
        lib = load()
        caps = (ctypes.c_int * R)(*(round(c * RES) for c in capacity))
        ws = torch.empty(G * lib.bfjs_mr_workspace_bytes(L, K, Qcap, A_max,
                                                         R),
                         dtype=torch.uint8, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.bfjs_mr_launch(
                n.data_ptr(), sizes.data_ptr(), durs.data_ptr(), G, T, L, K,
                R, Qcap, A_max, durs.shape[2], work_steps,
                ctypes.cast(caps, ctypes.c_void_p), ws.data_ptr(),
                qlen.data_ptr(), occ.data_ptr(), ndep.data_ptr(),
                dropped.data_ptr(), trunc.data_ptr(), stream)
        build.check(lib, err, "bfjs_mr kernel launch")
        launches.count += 1
    z = torch.zeros_like(dropped)
    return PolicyResult(qlen, occ, torch.cumsum(ndep, 1, dtype=torch.int32),
                        dropped, trunc, z, z, z)

"""ctypes wrapper of the fused VQS slot-step kernel (``csrc/vqs.cu``).

For CUDA tensors :func:`vqs_cuda` launches the kernel (or raises); for CPU
tensors it runs the plain version, ``ref.vqs_ref``.  ``launches`` counts
kernel launches only.  :func:`check_inputs`, :func:`shared_bytes` and
:func:`launch` are shared with the VQS-BF wrapper, whose kernel takes the
same arguments."""
from __future__ import annotations

import ctypes

import torch

from ...core.engine.ops import k_red_t
from ...core.engine.streams import PolicyResult
from .. import build
from ..common import LaunchCounter, resolve_windows
from .ref import vqs_ref

launches = LaunchCounter()

_P, _I, _S = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
#: (J, L, K, Qcap, A_max) of the layout functions every kernel exports
_LAYOUT_ARGS = [_I, _I, _I, _I, _I]
#: The kernels keep the 2J virtual queues in one 32-bit mask, which covers
#: every J of the RES = 2^16 grid (2^J <= RES).
MAX_J = 16
#: VQS-BF counts the resident jobs of each type per server in 16 bits.
MAX_K = {"vqs": None, "vqs_bf": 0xFFFF}


def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu`` with the signatures of its
    ``<name>_launch``, ``<name>_shared_bytes`` and
    ``<name>_workspace_bytes`` entry points set."""
    lib = build.load(name)
    launch = getattr(lib, f"{name}_launch")
    launch.restype = ctypes.c_int
    launch.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                       _I, _P, _P, _P, _P, _P, _P, _P]
    for fn in ("shared_bytes", "workspace_bytes"):
        f = getattr(lib, f"{name}_{fn}")
        f.restype = _S
        f.argtypes = _LAYOUT_ARGS
    return lib


def check_shape(name: str, J: int, K: int) -> None:
    """Raise ``NotImplementedError`` for a shape the kernel's layout cannot
    hold, before anything is built or launched."""
    if not 2 <= J <= MAX_J:
        raise NotImplementedError(
            f"the {name} kernel takes 2 <= J <= {MAX_J} (J={J})")
    if MAX_K[name] is not None and K > MAX_K[name]:
        raise NotImplementedError(
            f"the {name} kernel counts at most {MAX_K[name]} jobs a server "
            f"(K={K})")


def shared_bytes(name: str, J: int, L: int, K: int, Qcap: int,
                 A_max: int) -> int:
    """Shared memory of one ``<name>`` block, dynamic layout and static
    scratch, as the built kernel lays it out (``<name>_shared_bytes``);
    builds the kernel on first use."""
    check_shape(name, J, K)
    return getattr(load(name), f"{name}_shared_bytes")(J, L, K, Qcap, A_max)


def check_inputs(n, sizes, durs, A_max: int) -> None:
    """n (G, T) int32, sizes (G, T, A_max) f32 and durs (G, T, D) int32
    with D >= A_max, all on one device."""
    if n.ndim != 2:
        raise ValueError(f"n must be (G, T), got {tuple(n.shape)}")
    G, T = n.shape
    if durs.ndim != 3 or durs.shape[:2] != (G, T) \
            or durs.shape[2] < A_max:
        raise ValueError(f"durs must be (G={G}, T={T}, D >= {A_max}), got "
                         f"{tuple(durs.shape)}")
    expect = {"n": (n, (G, T), torch.int32),
              "sizes": (sizes, (G, T, A_max), torch.float32),
              "durs": (durs, tuple(durs.shape), torch.int32)}
    for name, (x, shape, dtype) in expect.items():
        if tuple(x.shape) != shape or x.dtype != dtype:
            raise ValueError(f"{name} must be {shape} {dtype}, got "
                             f"{tuple(x.shape)} {x.dtype}")
        if x.device != n.device:
            raise ValueError(f"{name} is on {x.device}, n on {n.device}")


def launch(name: str, n, sizes, durs, *, J: int, L: int, K: int, Qcap: int,
           A_max: int, work_steps: int, drain: int) -> PolicyResult:
    """Launch ``<name>_launch`` on CUDA tensors: one block per member, a
    per-member global workspace from ``torch.empty``, and the K_RED table
    of ``J``.  Returns the (G, T) trajectories and (G,) counters (fault
    counters zero: the kernels simulate fault-free clusters)."""
    if n.device.type != "cuda":
        raise ValueError(f"{name} kernel runs on CUDA tensors, got "
                         f"{n.device}")
    G, T = n.shape
    n, sizes, durs = n.contiguous(), sizes.contiguous(), durs.contiguous()
    dev = n.device
    qlen = torch.empty((G, T), dtype=torch.int32, device=dev)
    occ = torch.empty((G, T), dtype=torch.float32, device=dev)
    ndep = torch.empty((G, T), dtype=torch.int32, device=dev)
    dropped = torch.zeros(G, dtype=torch.int32, device=dev)
    trunc = torch.zeros(G, dtype=torch.int32, device=dev)
    if G > 0:
        lib = load(name)
        confs = k_red_t(J, dev)
        per_member = getattr(lib, f"{name}_workspace_bytes")(
            J, L, K, Qcap, A_max)
        ws = torch.empty(G * per_member, dtype=torch.uint8, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = getattr(lib, f"{name}_launch")(
                n.data_ptr(), sizes.data_ptr(), durs.data_ptr(),
                confs.data_ptr(), G, T, J, L, K, Qcap, A_max,
                durs.shape[2], work_steps, drain, ws.data_ptr(),
                qlen.data_ptr(), occ.data_ptr(), ndep.data_ptr(),
                dropped.data_ptr(), trunc.data_ptr(), stream)
        build.check(lib, err, f"{name} kernel launch")
    z = torch.zeros_like(dropped)
    return PolicyResult(qlen, occ, torch.cumsum(ndep, 1, dtype=torch.int32),
                        dropped, trunc, z, z, z)


def vqs_cuda(n: torch.Tensor, sizes: torch.Tensor, durs: torch.Tensor, *,
             J: int, L: int, K: int, Qcap: int, A_max: int, work_steps: int,
             drain: int, window: int | None = None) -> PolicyResult:
    """Run the fused VQS slot engine on an ensemble of clusters.

    n (G, T) int32, sizes (G, T, A_max) f32, durs (G, T, D) int32 with the
    per-arrival durations in the last A_max lanes (D = L*K + A_max from
    ``make_streams``, D = A_max from ``streams_from_trace``).  Returns a
    PolicyResult of (G, T) trajectories and (G,) counters.  ``window``
    must divide T; the kernel loops over every slot inside one block.  A J
    the kernel cannot hold raises ``NotImplementedError`` on either
    device."""
    check_shape("vqs", J, K)
    check_inputs(n, sizes, durs, A_max)
    resolve_windows(n.shape[1], window)
    if n.device.type == "cpu":
        return vqs_ref(n, sizes, durs, J=J, L=L, K=K, Qcap=Qcap,
                       A_max=A_max, work_steps=work_steps, drain=drain)
    res = launch("vqs", n, sizes, durs, J=J, L=L, K=K, Qcap=Qcap,
                 A_max=A_max, work_steps=work_steps, drain=drain)
    if n.shape[0] > 0:
        launches.count += 1
    return res

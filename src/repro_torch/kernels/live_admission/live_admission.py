"""ctypes wrapper of the live admission kernel (``csrc/live_admission.cu``).

For CUDA state :func:`live_admission_cuda` launches the kernel, one launch
an op (or raises); for CPU state it runs the plain version in ``ref.py``.
``launches`` counts kernel launches only."""
from __future__ import annotations

import ctypes

import torch

from .. import build
from ..common import SMEM_LIMIT_BYTES, LaunchCounter
from . import ref

launches = LaunchCounter()

#: The ops, numbered as the kernel numbers them.
OPS = {"admit": 0, "refill": 1, "release": 2, "tick": 3, "push_front": 4}
HEADER = ref.HEADER

_P, _I = ctypes.c_void_p, ctypes.c_int
#: the plain versions of the ops that take event lanes
_PLAIN = {"admit": ref.admit_ref, "release": ref.release_ref,
          "tick": ref.tick_ref}


def _lib() -> ctypes.CDLL:
    lib = build.load("live_admission")
    lib.live_admission_launch.restype = ctypes.c_int
    lib.live_admission_launch.argtypes = [_I, _P, _P, _P, _P, _P, _P, _I,
                                          _I, _P, _I, _I, _I, _P, _P]
    return lib


def shared_bytes(L: int, Qcap: int) -> int:
    """Dynamic shared memory of the kernel's one block: the residuals, a
    freed flag a replica and the two queue planes, 4 bytes each."""
    return 4 * (2 * L + 2 * Qcap)


def out_lanes(op: str, Qcap: int, A: int) -> int:
    """Length of ``out``: the header, then A placements (admit) or the
    placed ids and replicas (refill, tick)."""
    return HEADER + (A if op == "admit" else
                     2 * Qcap if op in ("refill", "tick") else 0)


def _check_state(state) -> tuple[int, int, torch.device]:
    dev = state.residual.device
    for name in ("residual", "q_rid", "q_size", "q_len", "dropped",
                 "invalid"):
        x = getattr(state, name)
        if x.dtype != torch.int32 or x.device != dev:
            raise ValueError(f"state.{name} must be int32 on {dev}, got "
                             f"{x.dtype} on {x.device}")
        if name in ("residual", "q_rid", "q_size"):
            if x.ndim != 1 or not x.is_contiguous():
                raise ValueError(f"state.{name} must be a contiguous vector")
        elif x.numel() != 1:
            raise ValueError(f"state.{name} must hold one value")
    L, Qcap = state.residual.shape[0], state.q_rid.shape[0]
    if L < 1 or Qcap < 1 or state.q_size.shape[0] != Qcap:
        raise ValueError(f"bad state shape: L={L}, q_rid {Qcap}, q_size "
                         f"{state.q_size.shape[0]}")
    return L, Qcap, dev


def live_admission_cuda(op: str, state, ev: torch.Tensor | None = None,
                        a0: int = 0, a1: int = 0) -> torch.Tensor:
    """Run one controller op on ``state`` in place and return ``out``.

    ``ev`` is the ``(3, A)`` int32 event lanes of admit (rid, size, live),
    release and tick (replica, size, live), on the state's device; ``a0``
    is refill's replica, ``(a0, a1)`` push_front's (rid, size).  ``out``
    holds ``[count, q_len, dropped, invalid]`` after the op, then the op's
    lanes (:func:`out_lanes`)."""
    if op not in OPS:
        raise ValueError(f"unknown op {op!r}; expected one of "
                         f"{', '.join(OPS)}")
    L, Qcap, dev = _check_state(state)
    if ev is None:
        ev = torch.zeros((3, 0), dtype=torch.int32, device=dev)
    if ev.dtype != torch.int32 or ev.ndim != 2 or ev.shape[0] != 3 \
            or ev.device != dev:
        raise ValueError(f"ev must be (3, A) int32 on {dev}, got "
                         f"{tuple(ev.shape)} {ev.dtype} on {ev.device}")
    A = ev.shape[1]
    out = torch.empty(out_lanes(op, Qcap, A), dtype=torch.int32, device=dev)
    if dev.type == "cpu":
        if op == "refill":
            ref.refill_ref(state, int(a0), out)
        elif op == "push_front":
            ref.push_front_ref(state, int(a0), int(a1), out)
        else:
            _PLAIN[op](state, ev, out)
        return out
    if dev.type != "cuda":
        raise ValueError(f"live admission kernel runs on CUDA tensors, got "
                         f"{dev}")
    nbytes = shared_bytes(L, Qcap)
    if nbytes > SMEM_LIMIT_BYTES:
        raise NotImplementedError(
            f"live admission state of L={L} replicas and Qcap={Qcap} needs "
            f"{nbytes} bytes of shared memory, over the {SMEM_LIMIT_BYTES}"
            "-byte limit of one block")
    ev = ev.contiguous()
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.live_admission_launch(
            OPS[op], state.residual.data_ptr(), state.q_rid.data_ptr(),
            state.q_size.data_ptr(), state.q_len.data_ptr(),
            state.dropped.data_ptr(), state.invalid.data_ptr(), L, Qcap,
            ev.data_ptr(), A, int(a0), int(a1), out.data_ptr(), stream)
    build.check(lib, err, "live admission kernel launch")
    launches.add()
    return out

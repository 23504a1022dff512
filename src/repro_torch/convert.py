"""Carry streams, scan state and results between the JAX package and the
port as numpy arrays.

The two packages draw different random numbers from the same seed, so a
parity check generates streams once (with either package), hands them over
as numpy, and runs both engines on the same bits."""
from __future__ import annotations

import numpy as np
import torch

from .core.engine.bfjs import BFJSState
from .core.engine.bfjs_mr import BFJSMRState
from .core.engine.streams import PolicyResult, SchedStreams
from .core.engine.vqs import VQSState
from .core.engine.vqs_bf import VQSBFState
from .device import resolve_device

_STATE_DTYPES = (torch.float32, torch.int32, torch.float32, torch.int32,
                 torch.int32, torch.int32, torch.int32, torch.int32,
                 torch.int32, torch.int32, torch.int32, torch.int32,
                 torch.bool)


def _tensor(x, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x)).to(device=device, dtype=dtype)


def streams_from_numpy(n, sizes, durs, up=None, device=None) -> SchedStreams:
    """``SchedStreams`` on ``device`` from numpy-convertible arrays (e.g.
    ``np.asarray`` of the JAX package's streams), with the port's dtypes:
    int32 counts, float32 sizes, int32 durations, bool fault plane.  A
    leading ensemble axis is kept."""
    device = resolve_device(device)
    return SchedStreams(
        _tensor(n, torch.int32, device), _tensor(sizes, torch.float32, device),
        _tensor(durs, torch.int32, device),
        None if up is None else _tensor(up, torch.bool, device))


def bfjs_state_from_numpy(carry, device=None) -> BFJSState:
    """:class:`BFJSState` from the 13-tuple scan carry of the JAX package's
    ``run_bfjs_streams(..., return_state=True)`` (same field order)."""
    device = resolve_device(device)
    carry = tuple(carry)
    if len(carry) != len(BFJSState._fields):
        raise ValueError(f"expected a {len(BFJSState._fields)}-field carry, "
                         f"got {len(carry)} fields")
    return BFJSState(*(_tensor(x, d, device)
                       for x, d in zip(carry, _STATE_DTYPES)))


#: The boolean fields of the integer carries (VQS family, bfjs-mr); every
#: other field is int32.
_BOOL_FIELDS = ("cfg_k1", "has_cfg", "in_empty", "want", "up_last")


def _state_from_numpy(cls, carry, device):
    """``cls`` (a state NamedTuple whose fields are int32 or bool) from a
    JAX scan carry in the same field order."""
    device = resolve_device(device)
    carry = tuple(carry)
    if len(carry) != len(cls._fields):
        raise ValueError(f"expected a {len(cls._fields)}-field carry, "
                         f"got {len(carry)} fields")
    return cls(*(_tensor(x, torch.bool if f in _BOOL_FIELDS
                         else torch.int32, device)
                 for f, x in zip(cls._fields, carry)))


def vqs_state_from_numpy(carry, device=None) -> VQSState:
    """:class:`VQSState` from the 21-tuple scan carry of the JAX package's
    ``run_vqs_streams(..., return_state=True)`` (same field order)."""
    return _state_from_numpy(VQSState, carry, device)


def vqs_bf_state_from_numpy(carry, device=None) -> VQSBFState:
    """:class:`VQSBFState` from the 23-tuple scan carry of the JAX
    package's ``run_vqs_bf_streams(..., return_state=True)``."""
    return _state_from_numpy(VQSBFState, carry, device)


def bfjs_mr_state_from_numpy(carry, device=None) -> BFJSMRState:
    """:class:`BFJSMRState` from the 18-tuple scan carry of the JAX
    package's ``run_bfjs_mr_streams(..., return_state=True)``."""
    return _state_from_numpy(BFJSMRState, carry, device)


def result_to_numpy(res: PolicyResult) -> PolicyResult:
    """Every tensor field of a result as a numpy array (others unchanged)."""
    return PolicyResult(*(x.detach().cpu().numpy()
                          if isinstance(x, torch.Tensor) else x
                          for x in res))

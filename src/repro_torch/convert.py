"""Carry streams, scan state and results between the JAX package and the
port as numpy arrays.

The two packages draw different random numbers from the same seed, so a
parity check generates streams once (with either package), hands them over
as numpy, and runs both engines on the same bits."""
from __future__ import annotations

import numpy as np
import torch

from .core.engine.bfjs import BFJSState
from .core.engine.streams import PolicyResult, SchedStreams
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


def result_to_numpy(res: PolicyResult) -> PolicyResult:
    """Every tensor field of a result as a numpy array (others unchanged)."""
    return PolicyResult(*(x.detach().cpu().numpy()
                          if isinstance(x, torch.Tensor) else x
                          for x in res))

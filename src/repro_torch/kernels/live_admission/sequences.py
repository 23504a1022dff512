"""Random op sequences for holding the live admission kernel against its
plain version: one generator and one replay loop, shared by the card
tests and ``chip_smoke.py`` so that both check the same op mix."""
from __future__ import annotations

import numpy as np
import torch

from ...core.quantize import RES
from . import ops as la


def random_ops(rng: np.random.Generator, L: int, n_ops: int,
               width: int) -> list:
    """``n_ops`` random ops ``(op, ev, a, b)`` on ``L`` replicas: int32
    ``(3, width)`` event lanes for admit (rid, size, live), release and
    tick (replica, size, live), ``a`` the replica of a refill, ``(a, b)``
    the (rid, size) of a push_front.  Sizes are drawn so that the queue
    overflows, push_front drops tails, and some releases are invalid
    (unknown replica, negative size, over capacity)."""
    ops = []
    for _ in range(n_ops):
        op = ("admit", "admit", "tick", "release", "refill",
              "push_front")[rng.integers(0, 6)]
        if op == "admit":
            ev = np.stack([rng.integers(0, 10_000, width),
                           rng.integers(1, RES // 2, width),
                           rng.uniform(size=width) < 0.8])
        elif op in ("tick", "release"):
            ev = np.stack([rng.integers(-1, L + 1, width),
                           rng.integers(-1, RES // 3, width),
                           rng.uniform(size=width) < 0.6])
        else:
            ev = None
        a = int(rng.integers(0, L)) if op == "refill" else \
            int(rng.integers(0, 10_000))
        ops.append((op, None if ev is None else ev.astype(np.int32), a,
                    int(rng.integers(1, RES))))
    return ops


def stage(ops: list, device) -> list:
    """``ops`` with their event lanes copied to ``device``."""
    return [(op, None if ev is None else torch.from_numpy(ev).to(device),
             a, b) for op, ev, a, b in ops]


def replay(state, staged: list, read: bool = True) -> list:
    """Run ``staged`` ops on ``state`` through the kernel's entry points
    (its plain version for CPU state); with ``read``, return each op's
    ``out`` on the host."""
    outs = []
    for op, ev, a, b in staged:
        if op == "refill":
            out = la.refill(state, a)
        elif op == "push_front":
            out = la.push_front(state, a, b)
        else:
            out = getattr(la, op)(state, ev)
        if read:
            outs.append(out.cpu())
    return outs

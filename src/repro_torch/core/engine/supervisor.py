"""Supervision of the port's runtime (torch counterpart of
``repro.core.engine.supervisor``).

Only the typed invariant failure is ported so far; the retry, watchdog,
rollback and quarantine layer waits for the streaming runtime (ROADMAP
queue 1 item 8).  The
event-driven cluster (``core.cluster_state.Cluster.check_invariants``) and
the serving engine (``serving.engine.ServingEngine.check_invariants``)
raise this one class.
"""
from __future__ import annotations

__all__ = ["InvariantViolation"]


class InvariantViolation(ValueError):
    """A runtime conservation law failed.  Subclasses ``ValueError`` so
    call sites that expect ``ValueError`` on bookkeeping corruption keep
    working.  ``invariant`` names the failed law; ``chunk_index`` the
    chunk of a streamed run it failed in, where there is one."""

    def __init__(self, message: str, *, invariant: str | None = None,
                 chunk_index: int | None = None):
        self.invariant = invariant
        self.chunk_index = chunk_index
        super().__init__(message)

"""Accelerator engines of the port: streams, workload, BF-J/S engines and
the policy registry (torch counterpart of ``repro.core.engine``)."""
from .api import (PolicySpec, available_policies, get_policy,
                  monte_carlo_policy, register_policy, run_policy,
                  run_policy_streams)
from .bfjs import (BFJSResult, BFJSState, DEFAULT_MAX_REQUEUE, ENGINES,
                   ensemble_streams, initial_state, monte_carlo_bfjs,
                   run_bfjs, run_bfjs_streams, run_bfjs_trace)
from .ops import (best_fit_place, best_fit_server, first_empty_positions,
                  largest_fitting_job, row_sum_lr)
from .streams import (INF_SLOT, PolicyResult, SchedStreams,
                      fault_plane_from_events, make_fault_plane,
                      make_streams, resolve_work_steps, with_fault_plane)
from .workload import Workload

__all__ = [
    "PolicySpec", "available_policies", "get_policy", "monte_carlo_policy",
    "register_policy", "run_policy", "run_policy_streams", "BFJSResult",
    "BFJSState", "DEFAULT_MAX_REQUEUE", "ENGINES", "ensemble_streams",
    "initial_state",
    "monte_carlo_bfjs", "run_bfjs", "run_bfjs_streams", "run_bfjs_trace",
    "best_fit_place", "best_fit_server", "first_empty_positions",
    "largest_fitting_job", "row_sum_lr", "INF_SLOT", "PolicyResult",
    "SchedStreams", "fault_plane_from_events", "make_fault_plane",
    "make_streams", "resolve_work_steps", "with_fault_plane", "Workload",
]

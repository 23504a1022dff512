"""Accelerator engines of the port: streams, workload, the BF-J/S,
multi-resource BF-J/S, VQS and VQS-BF engines, the policy registry, and
the runtime around them — crash-safe chunked sweeps, streaming,
supervision, the ensemble split over devices (``sharding``) and the
shape-keyed ``work_steps`` tuner with its persistent cache (``tuning``)
(torch counterpart of ``repro.core.engine``)."""
from .api import (PolicySpec, available_policies, get_policy,
                  monte_carlo_policy, register_policy, run_policy,
                  run_policy_streams)
from .bfjs import (BFJSResult, BFJSState, DEFAULT_MAX_REQUEUE, ENGINES,
                   ensemble_streams, initial_state, monte_carlo_bfjs,
                   run_bfjs, run_bfjs_streams, run_bfjs_trace)
from .bfjs_mr import (BFJSMRState, monte_carlo_bfjs_mr_workload,
                      run_bfjs_mr_streams, run_bfjs_mr_trace,
                      run_bfjs_mr_workload)
from .chunked import run_chunked, streams_fingerprint
from .ops import (alignment_score_pair, best_fit_place, best_fit_server,
                  first_empty_positions, k_red_t, largest_fitting_job,
                  max_weight_config, row_sum_lr, vq_type_of,
                  vq_type_of_grid)
from .sharding import (ENSEMBLE_AXIS, monte_carlo_chunked, resolve_mesh,
                       sharded_monte_carlo)
from .streaming import (iter_stream_chunks, stream_chunks_from_trace,
                        stream_policy)
from .streams import (INF_SLOT, PolicyResult, SchedStreams,
                      fault_plane_from_events, make_fault_plane,
                      make_streams, resolve_work_steps, streams_from_trace,
                      with_fault_plane)
from .supervisor import (INVARIANTS, CheckpointRollbackWarning,
                         InvariantViolation, RetryPolicy, Supervisor,
                         SupervisorError, SupervisorTimeout,
                         SupervisorWarning, audit_result, make_auditor)
from .tuning import (TuningCache, apply_tuned, autotune, shape_key,
                     tuning_enabled)
from .vqs import (VQSState, monte_carlo_vqs, run_vqs, run_vqs_streams,
                  run_vqs_trace)
from .vqs_bf import (VQSBFState, monte_carlo_vqs_bf, run_vqs_bf,
                     run_vqs_bf_streams, run_vqs_bf_trace)
from .workload import Workload

__all__ = [
    "PolicySpec", "available_policies", "get_policy", "monte_carlo_policy",
    "register_policy", "run_policy", "run_policy_streams", "BFJSResult",
    "BFJSState", "DEFAULT_MAX_REQUEUE", "ENGINES", "ensemble_streams",
    "initial_state",
    "monte_carlo_bfjs", "run_bfjs", "run_bfjs_streams", "run_bfjs_trace",
    "BFJSMRState", "monte_carlo_bfjs_mr_workload", "run_bfjs_mr_streams",
    "run_bfjs_mr_trace", "run_bfjs_mr_workload", "run_chunked",
    "streams_fingerprint", "ENSEMBLE_AXIS", "monte_carlo_chunked",
    "resolve_mesh", "sharded_monte_carlo", "TuningCache", "apply_tuned",
    "autotune", "shape_key", "tuning_enabled", "iter_stream_chunks",
    "stream_chunks_from_trace", "stream_policy", "INVARIANTS",
    "CheckpointRollbackWarning", "InvariantViolation", "RetryPolicy",
    "Supervisor", "SupervisorError", "SupervisorTimeout",
    "SupervisorWarning", "audit_result", "make_auditor",
    "alignment_score_pair",
    "best_fit_place", "best_fit_server", "first_empty_positions",
    "k_red_t", "largest_fitting_job", "max_weight_config", "row_sum_lr",
    "vq_type_of", "vq_type_of_grid", "INF_SLOT", "PolicyResult",
    "SchedStreams", "fault_plane_from_events", "make_fault_plane",
    "make_streams", "resolve_work_steps", "streams_from_trace",
    "with_fault_plane", "VQSState", "monte_carlo_vqs", "run_vqs",
    "run_vqs_streams", "run_vqs_trace", "VQSBFState", "monte_carlo_vqs_bf",
    "run_vqs_bf", "run_vqs_bf_streams", "run_vqs_bf_trace", "Workload",
]

"""Core library of the port: the paper's scheduling algorithms and
stability theory, as the event-driven host engine (numpy, equal to
``repro.core`` bit for bit), beside the accelerator engines of
``core.engine``.

Psychas & Ghaderi, "Scheduling Jobs with Random Resource Requirements in
Computing Clusters" (2019).
"""
from .base import Scheduler
from .best_fit import BFJ, BFJS, BFS
from .cluster_state import Cluster, ServiceModel, poisson_arrivals
from .distributions import (Discrete, Empirical, JobSizeDistribution, Mixture,
                            TruncatedPareto, Uniform)
from .fifo import FIFOFF
from .maxweight import MaxWeight
from .partition import PartitionI, k_red, k_red_is_feasible, max_weight_config
from .quantize import RES, TWO_THIRDS, from_grid, to_grid
from .queues import Job, SortedJobQueue, VirtualQueues
from .simulator import SimResult, simulate, simulate_trace
from .stability import (enumerate_configs, maximal_configs, rho_bounds,
                        rho_star_discrete, rho_star_upper_bound)
from .trace import (MachineEvents, Trace, collapse_resources,
                    empirical_size_stats, iter_trace_csv,
                    load_machine_events_csv, load_trace_csv,
                    scale_arrivals, scan_trace_maxima,
                    synthesize_google_like_trace)
from .vqs import VQS
from .vqs_bf import VQSBF

__all__ = [
    "Scheduler", "BFJ", "BFJS", "BFS", "Cluster", "ServiceModel",
    "poisson_arrivals", "Discrete", "Empirical", "JobSizeDistribution",
    "Mixture", "TruncatedPareto", "Uniform", "FIFOFF", "MaxWeight",
    "PartitionI", "k_red", "k_red_is_feasible", "max_weight_config",
    "RES", "TWO_THIRDS", "from_grid", "to_grid", "Job", "SortedJobQueue",
    "VirtualQueues", "SimResult", "simulate", "simulate_trace",
    "enumerate_configs", "maximal_configs", "rho_bounds",
    "rho_star_discrete", "rho_star_upper_bound", "MachineEvents", "Trace",
    "collapse_resources", "empirical_size_stats", "iter_trace_csv",
    "load_machine_events_csv", "load_trace_csv", "scale_arrivals",
    "scan_trace_maxima", "synthesize_google_like_trace", "VQS", "VQSBF",
]

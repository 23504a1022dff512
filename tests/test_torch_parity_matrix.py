"""The port's cross-engine parity matrix (tests/test_engine_parity_matrix.py
for ``repro_torch``): every (policy, engine) cell must reproduce the
policy's reference trajectory on a shared seed.

One parametrised sweep over policy x engine, so a new engine or policy is
held to its oracle because the matrix collects it, not because someone
remembered: registering a policy (or growing ``ENGINES``) grows the
matrix, and a cell that cannot run is a FAILURE, not a skip.  The
uncollapsed google_like_50 CSV fixture closes the loop for the trace path
(real-trace columns -> the port's ``load_trace_csv`` -> streams -> scan ==
cuda == oracle).  On CPU tensors the "cuda" engine runs its kernel's plain
version; the card holds each kernel to the same oracle in
``chip_smoke.py``."""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import load_trace_csv  # noqa: E402
from repro_torch.core.engine import (ENGINES, Workload,  # noqa: E402
                                     available_policies, run_policy,
                                     run_policy_streams, streams_from_trace)

FIXTURE = os.path.join(os.path.dirname(__file__), "data",
                       "google_like_50.csv")
SEED = 42
FIELDS = ("queue_len", "occupancy", "departed", "dropped", "preempted",
          "requeued", "lost")


def _scalar_sampler(gen, n, device):
    return torch.rand(n, generator=gen, device=device) * 0.45 + 0.05


def _vec_sampler(gen, n, device):
    return torch.rand((n, 2), generator=gen, device=device) * 0.45 + 0.05


#: policy -> (Workload, engine-agnostic config): the JAX matrix's rows.  K
#: >= 2^J for VQS (the packing bound), generous work_steps everywhere so
#: truncated == 0 and the bit-match contract applies end to end.
MATRIX = {
    "bfjs": (Workload(lam=1.2, mu=0.05, sampler=_scalar_sampler),
             dict(L=4, K=6, Qcap=64, A_max=5, horizon=150)),
    "vqs": (Workload(lam=1.0, mu=0.05, sampler=_scalar_sampler),
            dict(L=4, K=8, Qcap=64, A_max=5, horizon=150, J=3)),
    "bfjs-mr": (Workload(lam=0.5, mu=0.05, sampler=_vec_sampler,
                         num_resources=2, capacity=(1.0, 0.75)),
                dict(L=4, K=8, Qcap=64, A_max=5, horizon=150,
                     work_steps=24)),
    # vqs-bf places ONE job per work step (largest-fit pops can't batch),
    # so its bound is sized to the burst, not to A_max
    "vqs-bf": (Workload(lam=1.0, mu=0.05, sampler=_scalar_sampler),
               dict(L=4, K=8, Qcap=64, A_max=5, horizon=150, J=3,
                    work_steps=48)),
}


def test_matrix_covers_every_registered_policy():
    assert set(MATRIX) == set(available_policies()), (
        "every registered policy must appear in the parity matrix — add "
        "its Workload/config row here when registering a new policy")
    assert ENGINES == ("scan", "cuda", "reference")


@pytest.fixture(scope="module")
def reference_runs():
    """One reference trajectory per policy, computed once and shared."""
    return {policy: run_policy(wl, SEED, policy=policy, engine="reference",
                               device="cpu",
                               **{k: v for k, v in cfg.items()
                                  if k != "work_steps"})
            for policy, (wl, cfg) in MATRIX.items()}


def _equal(res, ref):
    assert int(res.truncated) == 0
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(res, f).numpy(),
                                      getattr(ref, f).numpy(), err_msg=f)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("policy", sorted(MATRIX))
def test_policy_engine_parity(policy, engine, reference_runs):
    wl, cfg = MATRIX[policy]
    res = run_policy(wl, SEED, policy=policy, engine=engine, device="cpu",
                     strict=engine == "cuda", **cfg)
    ref = reference_runs[policy]
    _equal(res, ref)
    assert int(ref.departed[-1]) > 0 and int(ref.queue_len.max()) > 0


# ---------------------------------------------------------------------------
# trace-driven parity: the uncollapsed google_like_50 CSV fixture
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def google50_streams():
    trace = load_trace_csv(FIXTURE, slot_seconds=10.0)
    return streams_from_trace(trace, collapse=False, num_resources=2,
                              device="cpu")


@pytest.mark.parametrize("engine", ["scan", "cuda"])
def test_google50_uncollapsed_trace_parity(engine, google50_streams):
    """The real-columns google_like_50 trace replays UNCOLLAPSED through
    every engine of the port and equals the event-driven oracle with
    truncated == 0."""
    kw = dict(L=8, K=16, Qcap=128, work_steps=32)
    res = run_policy_streams(google50_streams, policy="bfjs-mr",
                             engine=engine, strict=engine == "cuda", **kw)
    ref = run_policy_streams(google50_streams, policy="bfjs-mr",
                             engine="reference", L=8)
    assert int(res.dropped) == 0
    _equal(res, ref)
    assert int(res.departed[-1]) > 0

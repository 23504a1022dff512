"""Best-Fit placement: the port's plain version (what the kernel wrapper
runs for CPU tensors) vs the JAX Pallas kernel in interpret mode and the
JAX plain reference."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.best_fit.best_fit import (best_fit_pallas,  # noqa: E402
                                             best_fit_pallas_batched)
from repro.kernels.best_fit.ref import best_fit_ref  # noqa: E402
from repro_torch.kernels.best_fit import best_fit as bf_kernel  # noqa: E402
from repro_torch.kernels.best_fit.ops import (best_fit,  # noqa: E402
                                              best_fit_batched)
from repro_torch.kernels.best_fit.ref import \
    best_fit_ref_batched  # noqa: E402


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("L,N,seed", [(8, 4, 0), (64, 32, 1), (256, 128, 2),
                                      (128, 200, 3)])
def test_best_fit_matches_pallas_and_ref(L, N, seed):
    """Same inputs as tests/test_kernels.py::test_best_fit_sweep: the
    assignments are equal and the residuals bit-equal."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    resid = jax.random.uniform(k1, (L,))
    sizes = jax.random.uniform(k2, (N,), minval=0.01, maxval=0.8)
    a1, r1 = best_fit_pallas(resid, sizes, interpret=True)
    a2, r2 = best_fit_ref(resid, sizes)
    a, r = best_fit(_t(resid), _t(sizes))
    assert a.dtype == torch.int32 and r.dtype == torch.float32
    for aa, rr in ((a1, r1), (a2, r2)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(aa))
        np.testing.assert_array_equal(r.numpy(), np.asarray(rr))


def test_best_fit_exact_fit_and_rejects():
    a, r = best_fit(torch.tensor([0.5, 0.3]),
                    torch.tensor([0.3, 0.5, 0.2, 0.9]))
    assert a.tolist() == [1, 0, -1, -1]
    np.testing.assert_array_equal(r.numpy(), np.zeros(2, np.float32))


def test_best_fit_nonpositive_sizes_rejected():
    resid = jnp.asarray([0.5, 0.25, 0.75])
    sizes = jnp.asarray([0.0, -0.1, 0.25, 0.0])
    a1, r1 = best_fit_pallas(resid, sizes, interpret=True)
    a, r = best_fit(_t(resid), _t(sizes))
    assert a.tolist() == [-1, -1, 1, -1] == np.asarray(a1).tolist()
    np.testing.assert_array_equal(r.numpy(), np.asarray(r1))


def test_best_fit_batched_matches_pallas():
    resid = jax.random.uniform(jax.random.PRNGKey(0), (5, 32))
    sizes = jax.random.uniform(jax.random.PRNGKey(1), (5, 16), minval=0.05,
                               maxval=0.6)
    a1, r1 = best_fit_pallas_batched(resid, sizes, interpret=True)
    a, r = best_fit_batched(_t(resid), _t(sizes))
    np.testing.assert_array_equal(a.numpy(), np.asarray(a1))
    np.testing.assert_array_equal(r.numpy(), np.asarray(r1))
    a3, r3 = best_fit_ref_batched(_t(resid), _t(sizes))
    assert torch.equal(a, a3) and torch.equal(r, r3)


def test_best_fit_wrapper_cpu_runs_plain_version_and_validates():
    before = bf_kernel.launches.count
    best_fit_batched(torch.rand(2, 4), torch.rand(2, 3))
    assert bf_kernel.launches.count == before  # CPU: no kernel launch
    with pytest.raises(ValueError, match="float32"):
        best_fit_batched(torch.rand(2, 4, dtype=torch.float64),
                         torch.rand(2, 3, dtype=torch.float64))
    with pytest.raises(ValueError, match="must be"):
        best_fit_batched(torch.rand(2, 4), torch.rand(3, 3))
    with pytest.raises(ValueError, match="CUDA tensors"):
        best_fit_batched(torch.rand(2, 4, device="meta"),
                         torch.rand(2, 3, device="meta"))


_BIG = np.float32(3.4e38)
_BIG_UP = np.nextafter(_BIG, np.float32(np.inf))

#: (residuals, sizes, assignment, the JAX plain oracle agrees): the edges of
#: the TPU kernel's rule, where an infeasible server is masked to 3.4e38 and
#: a feasible one wins only where its masked value equals the least.  The
#: JAX plain oracle masks with inf instead, so it places a job on a residual
#: above 3.4e38 beside an infeasible server; Pallas and the port do not.
BF_EDGE_CASES = {
    "inf_beside_infeasible": ([np.inf, 0.5], [0.7], [-1], False),
    "all_inf": ([np.inf, np.inf], [0.7], [0], True),
    "exactly_big": ([_BIG, 0.5], [0.7], [0], True),
    "big_before_above_big": ([_BIG_UP, 0.5, _BIG], [0.7], [2], True),
    "above_big_beside_infeasible": ([_BIG_UP, 0.5], [0.7], [-1], False),
    "nan_residuals": ([np.nan, 0.9, -np.nan], [0.7, 0.1, 0.5], [1, 1, -1],
                      True),
    "bad_sizes": ([0.5, 0.25], [np.nan, -0.0, 0.0, -0.1, 0.25],
                  [-1, -1, -1, -1, 1], True),
    "subnormal_on_empty": ([0.0, -0.0], [1e-45, 1e-40], [-1, -1], True),
    "negative_zero_kept": ([-0.0, 0.5, 0.0], [0.5, 0.1], [1, -1], True),
    "inf_size": ([np.inf, 1.0], [np.inf, 0.5], [-1, 1], False),
    "inf_minus_inf": ([np.inf], [np.inf, 1.0], [0, -1], True),
}


@pytest.mark.parametrize("case", sorted(BF_EDGE_CASES))
def test_best_fit_edge_values_match_pallas(case):
    """The port's plain version equals the Pallas kernel in interpret mode at
    the rule's edges: assignments exactly, residuals bit for bit (-0.0 and
    NaN included), and the JAX plain oracle wherever it keeps the rule."""
    resid, sizes, want, ref_agrees = BF_EDGE_CASES[case]
    resid = np.array(resid, np.float32)
    sizes = np.array(sizes, np.float32)
    a, r = best_fit(torch.from_numpy(resid), torch.from_numpy(sizes))
    assert a.tolist() == want
    bits = r.numpy().view(np.int32)
    a1, r1 = best_fit_pallas(jnp.asarray(resid), jnp.asarray(sizes),
                             interpret=True)
    np.testing.assert_array_equal(a.numpy(), np.asarray(a1))
    np.testing.assert_array_equal(bits, np.asarray(r1).view(np.int32))
    a2, r2 = best_fit_ref(jnp.asarray(resid), jnp.asarray(sizes))
    same = (np.array_equal(a.numpy(), np.asarray(a2))
            and np.array_equal(bits, np.asarray(r2).view(np.int32)))
    assert same == ref_agrees

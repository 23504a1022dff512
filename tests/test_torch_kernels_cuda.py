"""The port's CUDA kernels on the card against their plain versions.

Marked ``cuda``: each test asks the ``cuda`` fixture for the device and
skips with a reason where there is none (the kernels have no CPU mode).
Run on a GPU machine with

    PYTHONPATH=src python -m pytest tests/test_torch_kernels_cuda.py -q
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.engine import (Workload,  # noqa: E402
                                     ensemble_streams, monte_carlo_policy)
from repro_torch.kernels.best_fit import best_fit as bf_kernel  # noqa: E402
from repro_torch.kernels.best_fit.ref import \
    best_fit_ref_batched  # noqa: E402
from repro_torch.kernels.bfjs import bfjs as bfjs_kernel  # noqa: E402
from repro_torch.kernels.bfjs.ref import bfjs_ref  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels run on the "
                    "card only")
    return torch.device("cuda")


def _sampler(lo, hi):
    def sampler(gen, n, device):
        return torch.rand(n, generator=gen, device=device) * (hi - lo) + lo
    return sampler


@pytest.mark.parametrize("G,L,N,seed", [(1, 8, 4, 0), (4, 256, 128, 1),
                                        (3, 1000, 700, 2), (2, 37, 300, 3)])
def test_best_fit_kernel_equals_plain(cuda, G, L, N, seed):
    rng = np.random.default_rng(seed)
    resid = torch.from_numpy(rng.uniform(0, 1, (G, L)).astype(np.float32))
    sizes = rng.uniform(0.01, 0.8, (G, N)).astype(np.float32)
    sizes[:, ::17] = 0.0  # size <= 0 is rejected
    sizes = torch.from_numpy(sizes)
    before = bf_kernel.launches.count
    a, r = bf_kernel.best_fit_cuda(resid.to(cuda), sizes.to(cuda))
    torch.cuda.synchronize()
    assert bf_kernel.launches.count == before + 1
    a0, r0 = best_fit_ref_batched(resid.to(cuda), sizes.to(cuda))
    assert torch.equal(a, a0)
    assert torch.equal(r, r0)


@pytest.mark.parametrize("G,L,K,Qcap,A_max,T,lam,mu,W", [
    (2, 4, 6, 64, 6, 120, 1.2, 0.02, 10),
    (3, 16, 24, 512, 8, 300, 1.5, 0.01, 12),
    (2, 3, 4, 16, 6, 200, 4.0, 0.01, 2),    # overload: drops, truncation
    (2, 600, 4, 2048, 16, 60, 40.0, 0.05, 20),  # more rows than threads
])
def test_bfjs_kernel_equals_plain(cuda, G, L, K, Qcap, A_max, T, lam, mu, W):
    st = ensemble_streams(range(G), lam, mu, _sampler(0.05, 0.5), L=L, K=K,
                          A_max=A_max, horizon=T, device=cuda)
    before = bfjs_kernel.launches.count
    got = bfjs_kernel.bfjs_cuda(st.n, st.sizes, st.durs, L=L, K=K,
                                Qcap=Qcap, A_max=A_max, work_steps=W)
    torch.cuda.synchronize()
    assert bfjs_kernel.launches.count == before + 1
    ref = bfjs_ref(st.n, st.sizes, st.durs, L=L, K=K, Qcap=Qcap,
                   A_max=A_max, work_steps=W)
    for f in ("queue_len", "occupancy", "departed", "dropped", "truncated"):
        assert torch.equal(getattr(got, f), getattr(ref, f)), f
    if W == 2:  # a 2-step work list must cut some slots short
        assert int(got.dropped.sum()) > 0 and int(got.truncated.sum()) > 0


def test_monte_carlo_cuda_engine_equals_scan_on_card(cuda):
    wl = Workload(lam=2.0, mu=0.02, sampler=_sampler(0.1, 0.9))
    cfg = dict(L=12, K=8, Qcap=256, A_max=8, horizon=150, device=cuda)
    before = bfjs_kernel.launches.count
    got = monte_carlo_policy(wl, seeds=[1, 2, 3], engine="cuda",
                             strict=True, **cfg)
    assert bfjs_kernel.launches.count == before + 1
    ref = monte_carlo_policy(wl, seeds=[1, 2, 3], engine="scan", **cfg)
    for f in ("queue_len", "occupancy", "departed", "dropped", "truncated"):
        assert torch.equal(getattr(got, f), getattr(ref, f)), f

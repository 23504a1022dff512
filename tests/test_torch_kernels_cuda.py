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
                                     ensemble_streams, monte_carlo_policy,
                                     run_policy_streams, streams_from_trace)
from repro_torch.kernels.best_fit import best_fit as bf_kernel  # noqa: E402
from repro_torch.kernels.bfjs_mr import bfjs_mr as bfjs_mr_kernel  # noqa: E402
from repro_torch.kernels.bfjs_mr.ref import bfjs_mr_ref  # noqa: E402
from repro_torch.kernels.best_fit.ref import \
    best_fit_ref_batched  # noqa: E402
from repro_torch.kernels.bfjs import bfjs as bfjs_kernel  # noqa: E402
from repro_torch.kernels.bfjs.ref import bfjs_ref  # noqa: E402
from repro_torch.kernels.vqs import vqs as vqs_kernel  # noqa: E402
from repro_torch.kernels.vqs.ref import vqs_ref  # noqa: E402
from repro_torch.kernels.vqs_bf import vqs_bf as vqs_bf_kernel  # noqa: E402
from repro_torch.kernels.vqs_bf.ref import vqs_bf_ref  # noqa: E402

FIELDS = ("queue_len", "occupancy", "departed", "dropped", "truncated")

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


#: csrc/best_fit.cu holds up to BF_CAP servers in a warpgroup's registers and
#: up to BF_MAX in shared memory (L * 4 bytes + 128 under 232,448); the
#: parent kernel took up to 58,048.  Each test below runs on both sides of
#: BF_CAP, so it reaches both routes.
BF_CAP, BF_MAX = 8192, 58080
BF_EDGE = 3.4e38


def _bf_equal(cuda, resid, sizes):
    """The kernel against the plain version on the card: assignments
    exactly, residuals bit for bit (as int32)."""
    r = torch.from_numpy(np.ascontiguousarray(resid, np.float32)).to(cuda)
    s = torch.from_numpy(np.ascontiguousarray(sizes, np.float32)).to(cuda)
    before = bf_kernel.launches.count
    a, out = bf_kernel.best_fit_cuda(r, s)
    torch.cuda.synchronize()
    assert bf_kernel.launches.count == before + 1
    a0, r0 = best_fit_ref_batched(r, s)
    assert torch.equal(a, a0)
    assert torch.equal(out.view(torch.int32), r0.view(torch.int32))
    return a


@pytest.mark.parametrize("L", [1, 31, 33, 1000, 1024, 1025, 2048, 2049,
                               4096, 4097, 5000, BF_CAP, BF_CAP + 1, 58048,
                               BF_MAX])
def test_best_fit_kernel_at_its_edges(cuda, L):
    """1 server, one lane-round either side of 32, the path's 1000, each
    register instance's cap and one past it, the shared-memory route from
    BF_CAP + 1, the largest L the parent kernel took and the largest this
    one takes; N shrinks with L to keep the plain version quick."""
    rng = np.random.default_rng(L)
    G, N = (3, 300) if L <= BF_CAP + 1 else (2, 48)
    resid = rng.uniform(0, 1, (G, L))
    sizes = rng.uniform(0.01, 0.8, (G, N))
    sizes[:, ::13] = 0.0
    _bf_equal(cuda, resid, sizes)


def test_best_fit_kernel_past_its_shared_memory_raises(cuda):
    r = torch.rand(1, BF_MAX + 1, device=cuda)
    with pytest.raises(RuntimeError, match="best_fit kernel launch"):
        bf_kernel.best_fit_cuda(r, torch.rand(1, 4, device=cuda))
    # the refused launch leaves no error behind for the next one
    _bf_equal(cuda, np.full((1, 4), 0.5), np.full((1, 3), 0.25))


@pytest.mark.parametrize("L", [100, BF_CAP + 1])
@pytest.mark.parametrize("N", [0, 1])
def test_best_fit_kernel_no_or_one_job(cuda, L, N):
    rng = np.random.default_rng(N)
    resid = rng.uniform(0, 1, (2, L))
    resid[1, 7] = -0.0  # untouched residuals keep their bits
    _bf_equal(cuda, resid, rng.uniform(0.01, 0.8, (2, N)))


@pytest.mark.parametrize("L", [1000, BF_CAP + 1])
def test_best_fit_kernel_more_problems_than_sms(cuda, L):
    rng = np.random.default_rng(300)
    _bf_equal(cuda, rng.uniform(0, 1, (300, L)),
              rng.uniform(0.01, 0.3, (300, 512)))


@pytest.mark.parametrize("L", [40, 1000, BF_CAP + 8])
def test_best_fit_kernel_ties_on_a_grid(cuda, L):
    """Residuals and sizes on a grid of eighths: equal residuals within a
    lane's slots and across lanes and warps, exact fits down to 0."""
    rng = np.random.default_rng(L)
    resid = rng.integers(0, 8, (4, L)) / 8.0
    sizes = rng.integers(1, 4, (4, 3 * min(L, 1000))) / 8.0
    _bf_equal(cuda, resid, sizes)


def _bf_edge_problems():
    """(residuals, sizes) pairs at the TPU kernel's rule's edges."""
    big_up = np.nextafter(np.float32(BF_EDGE), np.float32(np.inf))
    cases = [
        ([np.inf, 0.5], [0.7]),          # inf loses to an infeasible server
        ([np.inf, np.inf], [0.7]),       # all feasible: server 0
        ([BF_EDGE, 0.5], [0.7]),         # exactly kBig: placed
        ([big_up, 0.5, BF_EDGE], [0.7]),
        ([big_up, 0.5], [0.7]),
        ([np.nan, 0.9, -np.nan], [0.7, 0.1, 0.5]),
        ([0.5, 0.25], [np.nan, -0.0, 0.0, -0.1, 0.25]),
        ([0.0, -0.0], [1e-45, 1e-40]),   # subnormal sizes on empty servers
        ([-0.0, 0.5, 0.0], [0.5, 0.1]),
        ([np.inf, 1.0], [np.inf, 0.5]),
        ([np.inf], [np.inf, 1.0]),       # inf - inf: a NaN server
    ]
    return [(np.array(r, np.float32), np.array(s, np.float32))
            for r, s in cases]


@pytest.mark.parametrize("where", ["alone", "first", "last"])
@pytest.mark.parametrize("case", range(len(_bf_edge_problems())))
def test_best_fit_kernel_edge_values(cuda, where, case):
    """Each case alone, and at the start and at the end of a problem of
    BF_CAP + 1 servers (the shared-memory route), padded with copies of its
    own last or first residual so that the case keeps its set of values."""
    resid, sizes = _bf_edge_problems()[case]
    pad = BF_CAP + 1 - resid.size
    if where == "first":
        resid = np.pad(resid, (0, pad), mode="edge")
    elif where == "last":
        resid = np.pad(resid, (pad, 0), mode="edge")
    _bf_equal(cuda, resid[None], sizes[None])


@pytest.mark.parametrize("L", [70, BF_CAP + 58])
def test_best_fit_kernel_edge_values_mixed(cuda, L):
    """The edge values scattered over L servers and 400 jobs, 6 problems."""
    rng = np.random.default_rng(7)
    r_pool = np.array([np.inf, BF_EDGE, np.nan, -np.nan, -0.0, 0.0, -1.0,
                       0.25, 0.5, 1.0, 2.0], np.float32)
    s_pool = np.array([np.nan, -0.0, 0.0, -0.5, 1e-45, 0.25, 0.5, 0.125,
                       1.0, np.inf], np.float32)
    resid = np.where(rng.uniform(size=(6, L)) < 0.3,
                     rng.choice(r_pool, (6, L)), rng.uniform(0, 2, (6, L)))
    sizes = np.where(rng.uniform(size=(6, 400)) < 0.3,
                     rng.choice(s_pool, (6, 400)),
                     rng.uniform(0.01, 0.6, (6, 400)))
    _bf_equal(cuda, resid, sizes)


@pytest.mark.parametrize("L", [64, BF_CAP + 8])
def test_best_fit_kernel_rejects_above_the_largest_residual(cuda, L):
    """64 servers with room, the rest empty: capacity runs out early, so
    most jobs are larger than the largest residual left and take the
    kernel's rejection without a scan."""
    rng = np.random.default_rng(11)
    resid = np.zeros((4, L))
    resid[:, rng.choice(L, 64, replace=False)] = rng.uniform(0, 1, (4, 64))
    sizes = rng.uniform(0.3, 0.9, (4, 2000))
    a = _bf_equal(cuda, resid, sizes)
    assert float((a < 0).float().mean()) > 0.9


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


def _constant(v):
    def sampler(gen, n, device):
        return torch.full((n,), v, dtype=torch.float32, device=device)
    return sampler


# (G, L, K, Qcap, A_max, T, lam, mu, W, sizes): the edges of the kernel's
# design — two mask words a lane (L > 1024, not a multiple of 32), residual
# ties everywhere (one size), full rows that still fit (the slot-0
# overwrite), a small queue that fills, drains and drops, more arrival
# lanes than a warp with a shorter work list, departures every slot, and
# the full-width shape
BFJS_EDGE_CASES = [
    pytest.param(2, 1100, 4, 512, 16, 60, 60.0, 0.05, 20, (0.05, 0.5),
                 id="two-mask-words"),
    pytest.param(2, 37, 8, 256, 8, 200, 3.0, 0.02, 12, 0.25,
                 id="constant-sizes"),
    pytest.param(2, 20, 3, 256, 8, 200, 3.0, 0.02, 12, 0.25,
                 id="full-rows-overwrite"),
    pytest.param(2, 8, 6, 16, 12, 300, 3.0, 0.1, 16, (0.3, 0.9),
                 id="small-queue-drops"),
    pytest.param(2, 40, 8, 512, 40, 150, 30.0, 0.05, 20, (0.05, 0.5),
                 id="wide-arrivals-truncate"),
    pytest.param(2, 50, 6, 256, 8, 200, 10.0, 0.95, 12, (0.05, 0.9),
                 id="departures-every-slot"),
    pytest.param(2, 1000, 16, 4096, 48, 200, 17.0, 0.01, 52, (0.1, 0.9),
                 id="full-width"),
]


@pytest.mark.parametrize("G,L,K,Qcap,A_max,T,lam,mu,W,sizes",
                         BFJS_EDGE_CASES)
def test_bfjs_kernel_equals_plain_at_its_edges(cuda, G, L, K, Qcap, A_max,
                                               T, lam, mu, W, sizes):
    import ctypes
    from repro_torch.kernels.bfjs.ops import bfjs_scratch_bytes
    sampler = _constant(sizes) if isinstance(sizes, float) \
        else _sampler(*sizes)
    st = ensemble_streams(range(G), lam, mu, sampler, L=L, K=K,
                          A_max=A_max, horizon=T, device=cuda)
    kw = dict(L=L, K=K, Qcap=Qcap, A_max=A_max, work_steps=W)
    got = bfjs_kernel.bfjs_cuda(st.n, st.sizes, st.durs, **kw)
    torch.cuda.synchronize()
    ref = bfjs_ref(st.n, st.sizes, st.durs, **kw)
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(ref, f)), f
    fn = bfjs_kernel._lib().bfjs_shared_bytes
    fn.restype = ctypes.c_size_t
    fn.argtypes = [ctypes.c_int] * 4
    assert fn(L, K, Qcap, A_max) == bfjs_scratch_bytes(L, K, Qcap, A_max)
    if Qcap == 16:
        assert int(got.dropped.sum()) > 0
    if W < A_max:
        assert int(got.truncated.sum()) > 0
    if mu > 0.9:
        ndep = torch.diff(got.departed, dim=1)
        assert bool((ndep[:, 10:] > 0).all())


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


# (G, J, L, K, Qcap, A_max, T, lam, mu, W): small shapes, J = 2, overload
# (drops and truncation), K < 2^J (K-overflow), more servers than threads,
# rings in the global workspace (J = 7, Qcap = 4096), J = 10 (36 K_RED rows,
# 20 queues: more than a warp and a block's warps), and the full-width
# L = 1000 shape
VQS_CASES = [
    (2, 3, 4, 8, 48, 5, 120, 1.0, 0.03, None),
    (2, 2, 3, 6, 32, 4, 180, 1.0, 0.03, None),
    (2, 3, 3, 8, 8, 6, 150, 4.0, 0.01, 2),
    (2, 3, 4, 3, 48, 6, 150, 1.5, 0.03, None),
    (2, 4, 600, 16, 512, 24, 80, 8.0, 0.02, None),
    (2, 7, 16, 128, 4096, 8, 150, 3.0, 0.02, None),
    (2, 10, 8, 64, 256, 8, 150, 3.0, 0.02, None),
    (2, 4, 1000, 16, 1024, 48, 200, 12.0, 0.01, None),
]


def _vqs_case(kernel, ref, cuda, G, J, L, K, Qcap, A_max, T, lam, mu, W,
              sizes=(0.05, 0.9), **extra):
    st = ensemble_streams(range(G), lam, mu, _sampler(*sizes), L=L, K=K,
                          A_max=A_max, horizon=T, device=cuda)
    kw = dict(J=J, L=L, K=K, Qcap=Qcap, A_max=A_max,
              work_steps=A_max + 4 if W is None else W, **extra)
    mod = vqs_kernel if kernel == "vqs" else vqs_bf_kernel
    fn = mod.vqs_cuda if kernel == "vqs" else mod.vqs_bf_cuda
    before = mod.launches.count
    got = fn(st.n, st.sizes, st.durs, **kw)
    torch.cuda.synchronize()
    assert mod.launches.count == before + 1
    want = ref(st.n, st.sizes, st.durs, **kw)
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    if W == 2:
        assert int(got.dropped.sum()) > 0 and int(got.truncated.sum()) > 0
    if K < 1 << J and lam == 1.5:
        assert int(got.truncated.sum()) > 0
    return got


@pytest.mark.parametrize("G,J,L,K,Qcap,A_max,T,lam,mu,W", VQS_CASES)
def test_vqs_kernel_equals_plain(cuda, G, J, L, K, Qcap, A_max, T, lam, mu,
                                 W):
    _vqs_case("vqs", vqs_ref, cuda, G, J, L, K, Qcap, A_max, T, lam, mu, W,
              drain=min(K, 1 << J, 16))


def test_vqs_kernel_packs_more_than_a_warp(cuda):
    """drain = 40 > 32 with small jobs: the prefix fit spans two warp-wide
    chunks (the plain trajectory differs from drain = 32, so batches of
    more than 32 jobs were placed)."""
    case = (cuda, 2, 7, 4, 128, 1024, 48, 150, 20.0, 0.02, 1)
    got = _vqs_case("vqs", vqs_ref, *case, sizes=(0.004, 0.02), drain=40)
    narrow = _vqs_case("vqs", vqs_ref, *case, sizes=(0.004, 0.02), drain=32)
    assert not torch.equal(got.queue_len, narrow.queue_len)


def test_vqs_bf_kernel_counts_past_a_byte(cuda):
    """K = 2^J = 256 at J = 8 with jobs of the smallest type: a server
    holds 256 of them, past what a byte counts."""
    from repro_torch.core.engine import run_vqs_bf_streams
    case = (cuda, 2, 8, 2, 256, 2048, 64, 120, 40.0, 0.01, 68)
    _vqs_case("vqs_bf", vqs_bf_ref, *case, sizes=(0.0005, 0.0039))
    st = ensemble_streams(range(2), 40.0, 0.01, _sampler(0.0005, 0.0039),
                          L=2, K=256, A_max=64, horizon=120, device=cuda)
    _, state = run_vqs_bf_streams(st, J=8, L=2, K=256, Qcap=2048, A_max=64,
                                  work_steps=68, return_state=True)
    assert int((state.srv > 0).sum(-1).max()) == 256


# (G, J, L, K, Qcap, A_max, T, lam, mu, W, sizes): the edges of the VQS
# kernel's walk — two mask words a lane (L > 1024, not a multiple of 32),
# two bitmask words a row (K > 32, a drain of 40 placing past a word), the
# packed job plane in the workspace (K = 64 at L = 1000), J = 16 (32 rings,
# 60 K_RED rows), more arrival lanes than a warp with a short work list,
# departures every slot, the full-width shape at load 1.0, where the rings
# grow deep within 200 slots, and a cluster whose row bookkeeping lives in
# the workspace (L = 9000)
VQS_EDGE_CASES = [
    pytest.param(2, 4, 1100, 8, 256, 16, 60, 40.0, 0.05, None, (0.05, 0.9),
                 {}, id="two-mask-words"),
    pytest.param(2, 6, 8, 48, 256, 16, 150, 12.0, 0.02, None, (0.01, 0.05),
                 {"drain": 40}, id="two-row-words"),
    pytest.param(2, 4, 1000, 64, 1024, 48, 100, 20.0, 0.02, None,
                 (0.05, 0.9), {}, id="job-plane-in-workspace"),
    pytest.param(2, 16, 8, 16, 64, 8, 120, 3.0, 0.02, None, (0.001, 0.9),
                 {}, id="j16"),
    pytest.param(2, 4, 40, 8, 512, 40, 150, 30.0, 0.05, 20, (0.05, 0.9),
                 {}, id="wide-arrivals-truncate"),
    pytest.param(2, 4, 50, 6, 256, 8, 200, 10.0, 0.95, None, (0.05, 0.9),
                 {}, id="departures-every-slot"),
    pytest.param(2, 4, 1000, 16, 1024, 48, 200, 20.0, 0.01, None, (0.1, 0.9),
                 {}, id="full-width-load-1.0"),
    pytest.param(2, 4, 9000, 16, 256, 32, 40, 30.0, 0.05, None, (0.1, 0.9),
                 {}, id="bookkeeping-in-workspace"),
]


@pytest.mark.parametrize("G,J,L,K,Qcap,A_max,T,lam,mu,W,sizes,extra",
                         VQS_EDGE_CASES)
def test_vqs_kernel_equals_plain_at_its_edges(cuda, G, J, L, K, Qcap, A_max,
                                              T, lam, mu, W, sizes, extra):
    kw = dict(drain=min(K, 1 << J, 16))
    kw.update(extra)
    got = _vqs_case("vqs", vqs_ref, cuda, G, J, L, K, Qcap, A_max, T, lam,
                    mu, W, sizes=sizes, **kw)
    if (W is not None and W < A_max) or K == 48:  # K = 48: K-overflow
        assert int(got.truncated.sum()) > 0
    if mu > 0.9:
        ndep = torch.diff(got.departed, dim=1)
        assert bool((ndep[:, 10:] > 0).all())
    if L == 1000 and K == 16:
        assert float(got.queue_len.double().mean()) > 1


@pytest.mark.parametrize("G,J,L,K,Qcap,A_max,T,lam,mu,W", VQS_CASES)
def test_vqs_bf_kernel_equals_plain(cuda, G, J, L, K, Qcap, A_max, T, lam,
                                    mu, W):
    _vqs_case("vqs_bf", vqs_bf_ref, cuda, G, J, L, K, Qcap, A_max, T, lam,
              mu, W)


# (G, J, L, K, Qcap, A_max, T, lam, mu, W, sizes): the edges of the VQS-BF
# kernel's design — two mask words a lane (L > 1024, not a multiple of 32),
# two bitmask words a row (K > 32) with K-overflow, the job plane in the
# workspace (K = 64 at L = 1000), one size everywhere (ties broken by the
# sequence stamp), more arrival lanes than a warp with a shorter work list,
# departures every slot, and the full-width shape under a load that queues
VQS_BF_EDGE_CASES = [
    pytest.param(2, 4, 1100, 8, 256, 16, 60, 40.0, 0.05, None, (0.05, 0.9),
                 id="two-mask-words"),
    pytest.param(2, 6, 8, 48, 128, 16, 150, 12.0, 0.02, None, (0.01, 0.05),
                 id="two-row-words"),
    pytest.param(2, 4, 1000, 64, 1024, 48, 100, 20.0, 0.02, None,
                 (0.05, 0.9), id="job-plane-in-workspace"),
    pytest.param(2, 3, 37, 8, 256, 8, 200, 3.0, 0.02, None, 0.25,
                 id="constant-sizes"),
    pytest.param(2, 4, 40, 8, 512, 40, 150, 30.0, 0.05, 20, (0.05, 0.9),
                 id="wide-arrivals-truncate"),
    pytest.param(2, 4, 50, 6, 256, 8, 200, 10.0, 0.95, None, (0.05, 0.9),
                 id="departures-every-slot"),
    pytest.param(2, 4, 1000, 16, 1024, 48, 200, 44.0, 0.025, None,
                 (0.3, 0.9), id="full-width-queueing"),
]


@pytest.mark.parametrize("G,J,L,K,Qcap,A_max,T,lam,mu,W,sizes",
                         VQS_BF_EDGE_CASES)
def test_vqs_bf_kernel_equals_plain_at_its_edges(cuda, G, J, L, K, Qcap,
                                                 A_max, T, lam, mu, W, sizes):
    sampler = _constant(sizes) if isinstance(sizes, float) \
        else _sampler(*sizes)
    st = ensemble_streams(range(G), lam, mu, sampler, L=L, K=K,
                          A_max=A_max, horizon=T, device=cuda)
    kw = dict(J=J, L=L, K=K, Qcap=Qcap, A_max=A_max,
              work_steps=A_max + 4 if W is None else W)
    before = vqs_bf_kernel.launches.count
    got = vqs_bf_kernel.vqs_bf_cuda(st.n, st.sizes, st.durs, **kw)
    torch.cuda.synchronize()
    assert vqs_bf_kernel.launches.count == before + 1
    want = vqs_bf_ref(st.n, st.sizes, st.durs, **kw)
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    if K == 48:  # more jobs fit a server than it has slots
        assert int(got.truncated.sum()) > 0
    if W is not None and W < A_max:
        assert int(got.truncated.sum()) > 0
    if mu > 0.9:
        ndep = torch.diff(got.departed, dim=1)
        assert bool((ndep[:, 10:] > 0).all())
    if lam == 44.0:
        assert float(got.queue_len.double().mean()) > 0


@pytest.mark.parametrize("policy", ["vqs", "vqs-bf"])
def test_vqs_kernels_take_trace_width_durations(cuda, policy):
    """Trace-built streams carry only the A_max per-arrival duration lanes;
    the kernels read the last A_max lanes of either width."""
    rng = np.random.default_rng(7)
    slots = np.sort(rng.integers(0, 300, 900))
    st = streams_from_trace(slots, rng.uniform(0.02, 0.95, 900),
                            rng.integers(1, 80, 900), device=cuda)
    A = int(st.sizes.shape[1])
    assert st.durs.shape == (300, A)
    kw = dict(J=3, L=8, K=16, Qcap=512, A_max=A)
    mod = vqs_kernel if policy == "vqs" else vqs_bf_kernel
    before = mod.launches.count
    from repro_torch.core.engine import run_policy_streams
    got = run_policy_streams(st, policy=policy, engine="cuda", strict=True,
                             **kw)
    assert mod.launches.count == before + 1
    want = run_policy_streams(st, policy=policy, engine="scan", **kw)
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


@pytest.mark.parametrize("policy", ["vqs", "vqs-bf"])
def test_monte_carlo_vqs_cuda_engine_equals_scan_on_card(cuda, policy):
    wl = Workload(lam=2.0, mu=0.02, sampler=_sampler(0.1, 0.9))
    cfg = dict(J=4, L=12, K=16, Qcap=256, A_max=8, horizon=150, device=cuda)
    mod = vqs_kernel if policy == "vqs" else vqs_bf_kernel
    before = mod.launches.count
    got = monte_carlo_policy(wl, seeds=[1, 2, 3], policy=policy,
                             engine="cuda", strict=True, **cfg)
    assert mod.launches.count == before + 1
    ref = monte_carlo_policy(wl, seeds=[1, 2, 3], policy=policy,
                             engine="scan", **cfg)
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(ref, f)), f


@pytest.mark.parametrize("policy", ["bfjs", "vqs"])
def test_checkpointed_chunks_resume_to_the_kernel_on_card(cuda, policy,
                                                          tmp_path):
    """A chunked sweep of card streams, stopped at a boundary and resumed
    from its checkpoint (the scan engine on the card), equals the policy's
    kernel straight through — one launch, none from the chunked runs."""
    st = ensemble_streams(range(3), 0.5, 0.02, _sampler(0.1, 0.9), L=16,
                          K=8, A_max=8, horizon=200, device=cuda)
    cfg = dict(L=16, K=8, Qcap=256, A_max=8)
    if policy == "vqs":
        cfg["J"] = 4
    mod = bfjs_kernel if policy == "bfjs" else vqs_kernel
    before = mod.launches.count
    want = run_policy_streams(st, policy=policy, engine="cuda", strict=True,
                              **cfg)
    torch.cuda.synchronize()
    assert mod.launches.count == before + 1
    d = str(tmp_path)
    part = run_policy_streams(st, policy=policy, chunk=50, checkpoint_dir=d,
                              stop_after_chunks=2, **cfg)
    assert part.queue_len.shape == (3, 100)
    got = run_policy_streams(st, policy=policy, chunk=50, checkpoint_dir=d,
                             resume=True, **cfg)
    assert mod.launches.count == before + 1
    assert got.queue_len.device.type == "cuda"
    assert int(want.queue_len.max()) > 0
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def _vec_sampler(lo, hi, R):
    def sampler(gen, n, device):
        u = torch.rand(n, R, generator=gen, device=device) * (hi - lo) + lo
        return u[:, 0] if R == 1 else u
    return sampler


# (G, R, L, K, Qcap, A_max, T, lam, mu, sizes, W, capacity): R = 2 and 3, a
# starved work list, an undersized K (K-full), queue overflow, R = 1 and
# R = 4, more servers than threads, a queue too large for shared memory
# (it moves to the global workspace), non-unit capacity, and the
# full-width L = 1000 shape of the bfjs-mr path
BFJS_MR_CASES = [
    (2, 2, 4, 8, 256, 5, 300, 0.35, 0.05, (0.05, 0.5), 24, None),
    (2, 3, 4, 8, 256, 5, 300, 0.8, 0.05, (0.05, 0.5), 24, None),
    (2, 2, 3, 16, 256, 6, 300, 1.2, 0.1, (0.05, 0.25), 1, None),
    (2, 2, 3, 2, 256, 6, 300, 1.2, 0.1, (0.05, 0.25), 32, None),
    (2, 3, 3, 4, 8, 6, 200, 4.0, 0.02, (0.05, 0.5), 3, None),
    (2, 1, 5, 6, 64, 6, 300, 2.5, 0.05, (0.05, 0.6), 24, None),
    (2, 4, 6, 8, 128, 6, 300, 1.5, 0.05, (0.05, 0.4), 24, None),
    (2, 2, 600, 4, 2048, 16, 60, 40.0, 0.05, (0.1, 0.9), 20, None),
    (2, 2, 16, 16, 40000, 8, 200, 3.0, 0.02, (0.1, 0.9), 24, None),
    (2, 2, 8, 8, 256, 6, 300, 1.5, 0.05, (0.05, 0.5), 24, (1.0, 0.75)),
    (2, 2, 1000, 16, 1024, 48, 200, 16.0, 0.01, (0.1, 0.9), None, None),
]


@pytest.mark.parametrize("G,R,L,K,Qcap,A_max,T,lam,mu,sizes,W,capacity",
                         BFJS_MR_CASES)
def test_bfjs_mr_kernel_equals_plain(cuda, G, R, L, K, Qcap, A_max, T, lam,
                                     mu, sizes, W, capacity):
    st = ensemble_streams(range(G), lam, mu, _vec_sampler(*sizes, R), L=L,
                          K=K, A_max=A_max, horizon=T, device=cuda,
                          num_resources=R)
    kw = dict(L=L, K=K, Qcap=Qcap, A_max=A_max,
              work_steps=A_max + 4 if W is None else W,
              capacity=capacity or (1.0,) * R)
    sizes = st.sizes[..., None] if R == 1 else st.sizes  # (G, T, A, R)
    before = bfjs_mr_kernel.launches.count
    got = bfjs_mr_kernel.bfjs_mr_cuda(st.n, sizes, st.durs, **kw)
    torch.cuda.synchronize()
    assert bfjs_mr_kernel.launches.count == before + 1
    want = bfjs_mr_ref(st.n, sizes, st.durs, **kw)
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    if W == 1 or K == 2:  # starved list, K-full
        assert int(got.truncated.sum()) > 0
    if Qcap == 8:
        assert int(got.dropped.sum()) > 0


# (G, R, L, K, Qcap, A_max, T, lam, mu, sizes, W): the edges of the
# bfjs_mr kernel's design — two mask words a lane (L > 1024, not a multiple
# of 32), two bitmask words a row (K > 32), the demand plane in the
# workspace (R = 3 and 4 at L = 1000), a K-full BF-S target that blocks the
# pass with a short work list (the saturation check then tests the
# unblocked arrivals), a starved list whose BF-S walk is cut (the
# saturation check tests the freed servers left), and the full-width shape
# with a queue in every slot, and a cluster whose row bookkeeping lives in
# the workspace (L = 9000)
BFJS_MR_EDGE_CASES = [
    pytest.param(2, 2, 1100, 8, 256, 16, 60, 40.0, 0.05, (0.05, 0.9), None,
                 id="two-mask-words"),
    pytest.param(2, 2, 8, 48, 128, 16, 150, 12.0, 0.02, (0.005, 0.02), None,
                 id="two-row-words"),
    pytest.param(2, 3, 1000, 16, 1024, 48, 100, 16.0, 0.01, (0.1, 0.9),
                 None, id="r3-full-width"),
    pytest.param(2, 4, 1000, 16, 1024, 48, 100, 12.0, 0.01, (0.1, 0.7),
                 None, id="r4-full-width"),
    pytest.param(2, 2, 3, 2, 256, 6, 300, 1.2, 0.1, (0.05, 0.25), 4,
                 id="k-full-blocks-short-list"),
    pytest.param(2, 2, 40, 8, 512, 40, 150, 30.0, 0.05, (0.05, 0.5), 6,
                 id="starved-walk"),
    pytest.param(2, 2, 1000, 16, 1024, 48, 200, 24.0, 0.01, (0.2, 0.9),
                 None, id="full-width-queueing"),
    pytest.param(2, 2, 9000, 16, 256, 32, 40, 30.0, 0.05, (0.1, 0.9), None,
                 id="bookkeeping-in-workspace"),
]


@pytest.mark.parametrize("G,R,L,K,Qcap,A_max,T,lam,mu,sizes,W",
                         BFJS_MR_EDGE_CASES)
def test_bfjs_mr_kernel_equals_plain_at_its_edges(cuda, G, R, L, K, Qcap,
                                                  A_max, T, lam, mu, sizes,
                                                  W):
    st = ensemble_streams(range(G), lam, mu, _vec_sampler(*sizes, R), L=L,
                          K=K, A_max=A_max, horizon=T, device=cuda,
                          num_resources=R)
    kw = dict(L=L, K=K, Qcap=Qcap, A_max=A_max,
              work_steps=A_max + 4 if W is None else W, capacity=(1.0,) * R)
    before = bfjs_mr_kernel.launches.count
    got = bfjs_mr_kernel.bfjs_mr_cuda(st.n, st.sizes, st.durs, **kw)
    torch.cuda.synchronize()
    assert bfjs_mr_kernel.launches.count == before + 1
    want = bfjs_mr_ref(st.n, st.sizes, st.durs, **kw)
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    if W is not None or K == 48:  # K = 48: jobs outnumber a row's slots
        assert int(got.truncated.sum()) > 0
    if lam == 24.0:
        assert float(got.queue_len.double().mean()) > 1


@pytest.mark.parametrize("policy", ["vqs", "bfjs-mr"])
def test_kernels_wrap_departure_slots(cuda, policy):
    """Durations near 2^31 (trace-width streams, D = A_max): t + d wraps in
    int32 (the job never leaves) or lands on INF_SLOT itself (bfjs-mr keeps
    that slot empty, as the engines do); the kernels follow the plain
    version."""
    from repro_torch.core.engine import run_policy_streams
    rng = np.random.default_rng(11)
    n_jobs, T = 500, 200
    slots = np.sort(rng.integers(0, T, n_jobs))
    durs = rng.integers(1, 60, n_jobs)
    far = rng.random(n_jobs) < 0.15
    durs[far] = 2 ** 31 - 1 - slots[far]          # departure slot INF_SLOT
    wrap = (rng.random(n_jobs) < 0.1) & ~far & (slots > 3)
    durs[wrap] = 2 ** 31 - 2                       # t + d wraps below 0
    R = 2 if policy == "bfjs-mr" else 1
    sizes = rng.uniform(0.05, 0.4, (n_jobs, R) if R > 1 else n_jobs)
    st = streams_from_trace(slots, sizes, durs, horizon=T, device=cuda)
    A = int(st.sizes.shape[1])
    kw = dict(L=6, K=8, Qcap=256, A_max=A)
    if policy == "vqs":
        kw["J"] = 3
    mod = bfjs_mr_kernel if policy == "bfjs-mr" else vqs_kernel
    before = mod.launches.count
    got = run_policy_streams(st, policy=policy, engine="cuda", strict=True,
                             **kw)
    assert mod.launches.count == before + 1
    want = run_policy_streams(st, policy=policy, engine="scan", **kw)
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert int(got.departed[-1]) > 0


def test_bfjs_mr_kernel_layout(cuda):
    """The slice's shape keeps the queue and the (L, K, R) demand plane in
    shared memory and only the (L, K) departure slots in the workspace; R =
    4 moves the demand plane (4 words a job) to the workspace; a large Qcap
    moves the queue there; all pass the gate."""
    from repro_torch.kernels.bfjs_mr.ops import bfjs_mr_shared_bytes
    from repro_torch.kernels.common import SMEM_LIMIT_BYTES
    ws = bfjs_mr_kernel.load().bfjs_mr_workspace_bytes
    dep = 4 * 1000 * 16  # the (L, K) departure slots
    assert ws(1000, 16, 1024, 48, 2) == dep
    assert ws(1000, 16, 1024, 48, 4) == 4 * 1000 * 16 * 4 + dep
    # queue: (Qcap, 2) demand vectors, durations and seq ids
    assert ws(16, 16, 40000, 8, 2) == 4 * 16 * 16 + 4 * 4 * 40000
    for Qcap, R in ((1024, 2), (40000, 2), (1024, 3), (1024, 4)):
        assert bfjs_mr_shared_bytes(1000, 16, Qcap, 48, R) \
            <= SMEM_LIMIT_BYTES
    # the largest clusters the 512-thread kernel took before its redesign
    # (R + 3 words a server in shared memory) still pass: the per-row
    # bookkeeping moves to the workspace
    for L, R in ((14000, 1), (11500, 2), (9600, 3), (8200, 4)):
        assert bfjs_mr_shared_bytes(L, 16, 1024, 48, R) <= SMEM_LIMIT_BYTES
    # the (L, K, 2) and (L, K) planes, then 4 bookkeeping words a server
    assert ws(11500, 16, 1024, 48, 2) == 4 * 11500 * 16 * 3 + 4 * 11500 * 4


def test_bfjs_mr_kernel_takes_trace_width_durations(cuda):
    """Trace-built (cpu, mem) streams carry only the A_max per-arrival
    duration lanes; the kernel reads the last A_max lanes of either
    width."""
    from repro_torch.core.engine import run_policy_streams
    rng = np.random.default_rng(7)
    slots = np.sort(rng.integers(0, 300, 700))
    st = streams_from_trace(slots, rng.uniform(0.02, 0.6, (700, 2)),
                            rng.integers(1, 80, 700), device=cuda)
    A = int(st.sizes.shape[1])
    assert st.durs.shape == (300, A) and st.sizes.shape == (300, A, 2)
    kw = dict(L=8, K=16, Qcap=512, A_max=A)
    before = bfjs_mr_kernel.launches.count
    got = run_policy_streams(st, policy="bfjs-mr", engine="cuda",
                             strict=True, **kw)
    assert bfjs_mr_kernel.launches.count == before + 1
    want = run_policy_streams(st, policy="bfjs-mr", engine="scan", **kw)
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def test_monte_carlo_bfjs_mr_cuda_engine_on_card(cuda):
    """engine="cuda" equals "scan" on the card; a fault plane falls back
    loudly to the scan engine, or raises under strict=True."""
    import warnings
    from repro_torch.kernels.common import GracefulDegradationWarning
    wl = Workload(lam=2.0, mu=0.02, sampler=_vec_sampler(0.1, 0.6, 2),
                  num_resources=2)
    cfg = dict(L=12, K=16, Qcap=256, A_max=8, horizon=150, device=cuda)
    before = bfjs_mr_kernel.launches.count
    got = monte_carlo_policy(wl, seeds=[1, 2, 3], policy="bfjs-mr",
                             engine="cuda", strict=True, **cfg)
    assert bfjs_mr_kernel.launches.count == before + 1
    ref = monte_carlo_policy(wl, seeds=[1, 2, 3], policy="bfjs-mr",
                             engine="scan", **cfg)
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(ref, f)), f
    with pytest.raises(ValueError, match="fault-plane"):
        monte_carlo_policy(wl, seeds=[1], policy="bfjs-mr", engine="cuda",
                           strict=True, fault_rate=0.05, **cfg)
    before = bfjs_mr_kernel.launches.count
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        res = monte_carlo_policy(wl, seeds=[1], policy="bfjs-mr",
                                 engine="cuda", fault_rate=0.05, **cfg)
    assert any(issubclass(x.category, GracefulDegradationWarning)
               for x in w)
    assert bfjs_mr_kernel.launches.count == before
    assert int(res.preempted.sum()) > 0


# ---------------------------------------------------------------------------
# LM attention kernels (decode_attention, flash_attention)
# ---------------------------------------------------------------------------
def _normal(rng, shape, dtype, device):
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    return x.to(device=device, dtype=dtype)


def _close(got, ref, dtype):
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               ref.float().cpu().numpy(), atol=tol, rtol=tol)


DECODE_CASES = [
    # (B, H, KV, C, hd, pos, window, dtype): the sweep of
    # tests/test_kernels.py, then per-row positions at llama3-8b's shape,
    # ragged C, G = 1 and 12, hd = 120, and rows with nothing valid
    (2, 8, 2, 256, 64, 0, 0, torch.float32),
    (2, 8, 2, 256, 64, 255, 0, torch.float32),
    (2, 8, 2, 512, 64, 300, 0, torch.bfloat16),
    (2, 8, 2, 512, 64, 300, 128, torch.float32),
    (4, 32, 8, 2048, 128, (0, 511, 1337, 2047), 0, torch.bfloat16),
    (4, 32, 8, 2048, 128, (0, 511, 1337, 2047), 512, torch.bfloat16),
    (4, 32, 8, 2048, 128, (0, 511, 1337, 2047), 0, torch.float32),
    (3, 4, 4, 100, 16, (99, 5, 63), 0, torch.float32),
    (2, 24, 2, 300, 120, (150, 299), 40, torch.bfloat16),
    (2, 4, 2, 64, 32, (-1, 200), 16, torch.float32),
    # the split over the cache: B = 1 (eight blocks a kv head) and B = 16
    # (two), ragged positions, C not a multiple of the split, shares with
    # no valid row, a row with none at all
    (1, 32, 8, 1500, 128, (1499,), 0, torch.bfloat16),
    (1, 32, 8, 1500, 128, (3,), 0, torch.bfloat16),
    (16, 32, 8, 1001, 128, (0, 1, 7, 63, 64, 65, 127, 128, 200, 333, 500,
                            640, 777, 999, 1000, -1), 0, torch.bfloat16),
    (16, 32, 8, 1001, 128, (0, 1, 7, 63, 64, 65, 127, 128, 200, 333, 500,
                            640, 777, 999, 1000, 1000), 100, torch.float32),
    (16, 8, 2, 777, 64, tuple(range(5, 777, 49)), 30, torch.bfloat16),
]


@pytest.mark.parametrize("B,H,KV,C,hd,pos,window,dtype", DECODE_CASES)
def test_decode_attention_kernel_equals_plain(cuda, B, H, KV, C, hd, pos,
                                              window, dtype):
    from repro_torch.kernels.decode_attention import decode_attention as da
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    rng = np.random.default_rng(C + hd)
    q = _normal(rng, (B, H, hd), dtype, cuda)
    k = _normal(rng, (B, KV, C, hd), dtype, cuda)
    v = _normal(rng, (B, KV, C, hd), dtype, cuda)
    p = torch.tensor(pos, dtype=torch.int32, device=cuda)
    before = da.launches.count
    got = da.decode_attention_cuda(q, k, v, p, window=window)
    torch.cuda.synchronize()
    assert da.launches.count == before + 1
    assert got.dtype == dtype and got.shape == (B, H, hd)
    _close(got, decode_attention_ref(q, k, v, p, window=window), dtype)


def test_decode_attention_kernel_alignment(cuda):
    """A cache view off the 16-byte grid is copied, not misread; a head dim
    whose rows are not whole 16-byte vectors is refused."""
    from repro_torch.kernels.decode_attention import decode_attention as da
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    rng = np.random.default_rng(9)
    B, H, KV, C, hd = 2, 8, 2, 96, 64
    q = _normal(rng, (B, H, hd), torch.bfloat16, cuda)
    flat = _normal(rng, (2 * B * KV * C * hd + 1,), torch.bfloat16, cuda)
    k = flat[1:1 + B * KV * C * hd].view(B, KV, C, hd)
    v = flat[1 + B * KV * C * hd:].view(B, KV, C, hd)
    assert k.data_ptr() % 16 != 0
    p = torch.tensor([40, 95], dtype=torch.int32, device=cuda)
    _close(da.decode_attention_cuda(q, k, v, p),
           decode_attention_ref(q, k, v, p), torch.bfloat16)
    q36 = _normal(rng, (B, H, 36), torch.bfloat16, cuda)
    k36 = _normal(rng, (B, KV, C, 36), torch.bfloat16, cuda)
    with pytest.raises(NotImplementedError, match="16-byte"):
        da.decode_attention_cuda(q36, k36, k36, p)


def test_decode_attention_kernel_replays_in_a_cuda_graph(cuda):
    """The launch's grid depends on shapes only and the kernel reads pos on
    the device: a captured call replays right after pos changes in
    place."""
    from repro_torch.kernels.decode_attention import decode_attention as da
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    rng = np.random.default_rng(5)
    B, H, KV, C, hd = 4, 32, 8, 2048, 128
    q = _normal(rng, (B, H, hd), torch.bfloat16, cuda)
    k = _normal(rng, (B, KV, C, hd), torch.bfloat16, cuda)
    v = _normal(rng, (B, KV, C, hd), torch.bfloat16, cuda)
    p = torch.tensor([0, 511, 1337, 2047], dtype=torch.int32, device=cuda)
    da.decode_attention_cuda(q, k, v, p)       # builds the kernel
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = da.decode_attention_cuda(q, k, v, p)
    for new in ((5, 100, 2000, 7), (2047, 0, -1, 1024)):
        p.copy_(torch.tensor(new, dtype=torch.int32))
        before = da.launches.count
        graph.replay()
        torch.cuda.synchronize()
        assert da.launches.count == before      # a replay is not a call
        _close(out, decode_attention_ref(q, k, v, p), torch.bfloat16)


FLASH_CASES = [
    # (B, H, KV, Sq, Sk, hd, window, dtype): the sweep of
    # tests/test_kernels.py, llama3-8b's prefill shape, then ragged S,
    # hd = 16 and 120, MHA, and Sq != Sk
    (2, 4, 2, 128, 128, 64, 0, torch.float32),
    (2, 4, 2, 256, 256, 64, 0, torch.float32),
    (2, 4, 2, 256, 256, 128, 64, torch.float32),
    (2, 4, 2, 256, 256, 32, 0, torch.bfloat16),
    (2, 4, 2, 512, 512, 64, 128, torch.bfloat16),
    (1, 32, 8, 2048, 2048, 128, 0, torch.bfloat16),
    (1, 32, 8, 2048, 2048, 128, 512, torch.bfloat16),
    (2, 4, 2, 100, 100, 16, 0, torch.float32),
    (1, 8, 2, 200, 200, 120, 50, torch.bfloat16),
    (1, 3, 3, 70, 70, 256, 0, torch.float32),
    (1, 4, 1, 64, 160, 64, 0, torch.float32),
    # the bf16 tensor-core instance: hd 64, 120 and 128, Sq off the 128-row
    # tile, Sq != Sk both ways, G = 1, 4 and 8, windows under a tile and
    # off its multiples, hd padded to a multiple of 8, hd > 128 (CUDA cores)
    (1, 8, 8, 200, 200, 64, 0, torch.bfloat16),
    (2, 16, 4, 1000, 1000, 128, 0, torch.bfloat16),
    (1, 8, 1, 1000, 1000, 120, 300, torch.bfloat16),
    (1, 4, 4, 333, 333, 128, 50, torch.bfloat16),
    (1, 8, 2, 1000, 1000, 64, 200, torch.bfloat16),
    (1, 8, 2, 200, 520, 64, 0, torch.bfloat16),
    (1, 8, 1, 520, 200, 128, 0, torch.bfloat16),
    (2, 4, 2, 24, 24, 16, 0, torch.bfloat16),
    (1, 4, 2, 96, 96, 36, 0, torch.bfloat16),
    (1, 4, 2, 130, 130, 192, 0, torch.bfloat16),
]


@pytest.mark.parametrize("B,H,KV,Sq,Sk,hd,window,dtype", FLASH_CASES)
def test_flash_attention_kernel_equals_plain(cuda, B, H, KV, Sq, Sk, hd,
                                             window, dtype):
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention.ref import attention_ref
    rng = np.random.default_rng(Sq + hd)
    q = _normal(rng, (B, H, Sq, hd), dtype, cuda)
    k = _normal(rng, (B, KV, Sk, hd), dtype, cuda)
    v = _normal(rng, (B, KV, Sk, hd), dtype, cuda)
    before = fa.launches.count
    got = fa.flash_attention_cuda(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert fa.launches.count == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    _close(got, attention_ref(q, k, v, causal=True, window=window), dtype)
    if window == 0 and Sq == Sk:
        _close(fa.flash_attention_cuda(q, k, v, causal=False),
               attention_ref(q, k, v, causal=False), dtype)


def test_flash_attention_tensor_core_instance_writes_through_strides(cuda):
    """The model's call: q, k, v as (B, S, H, hd) views transposed to
    (B, H, S, hd).  The tensor-core instance reads them in place (no copy:
    the call's device memory grows by less than the output and a copy of
    q) and writes an output with q's strides."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention.ref import attention_ref
    rng = np.random.default_rng(11)
    B, H, KV, S, hd = 2, 8, 2, 300, 128
    q = _normal(rng, (B, S, H, hd), torch.bfloat16, cuda).transpose(1, 2)
    k = _normal(rng, (B, S, KV, hd), torch.bfloat16, cuda).transpose(1, 2)
    v = _normal(rng, (B, S, KV, hd), torch.bfloat16, cuda).transpose(1, 2)
    assert fa.instance(q.dtype, hd) == "tensor-core"
    assert all(fa._tma_ready(x) is x for x in (q, k, v))
    fa.flash_attention_cuda(q, k, v)           # builds the kernel
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    got = fa.flash_attention_cuda(q, k, v, window=100)
    torch.cuda.synchronize()
    out_bytes = got.numel() * got.element_size()
    assert torch.cuda.max_memory_allocated() - base < 2 * out_bytes
    assert got.stride() == q.stride()
    assert got.transpose(1, 2).is_contiguous()
    _close(got, attention_ref(q, k, v, window=100), torch.bfloat16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_on_card_kernels_equal_plain(cuda, dtype):
    """decode_step and prefill on the card launch one kernel per layer
    and agree with the plain versions (use_kernels=False)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.decode_attention import decode_attention as da
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.models import model as M
    cfg = get_smoke_config("llama3-8b").with_(dtype=dtype)
    params = M.init_params(cfg, 0, device=cuda)
    toks = torch.randint(0, cfg.vocab_size, (3, 24), device=cuda,
                         generator=torch.Generator(cuda).manual_seed(1))
    caches = {u: M.init_cache(cfg, 3, 32, device=cuda) for u in (True, False)}
    da.launches.reset()
    for i in range(24):
        pos = torch.tensor([i, max(i - 3, 0), i // 2], dtype=torch.int32,
                           device=cuda)
        out = {}
        for u in (True, False):
            out[u], caches[u] = M.decode_step(params, cfg, toks[:, i:i + 1],
                                              pos, caches[u], use_kernels=u)
        scale = float(out[False].abs().max())
        assert float((out[True] - out[False]).abs().max()) <= 2e-2 * scale
    assert da.launches.count == 24 * cfg.num_layers
    fa.launches.reset()
    last = M.prefill(params, cfg, tokens=toks)
    ref = M.prefill(params, cfg, tokens=toks, use_kernels=False)
    assert fa.launches.count == cfg.num_layers
    assert float((last - ref).abs().max()) <= 2e-2 * float(ref.abs().max())


# ---------------------------------------------------------------------------
# Mamba2 SSD chunk-scan kernel (ssd_scan)
# ---------------------------------------------------------------------------
SSD_CASES = [
    # (B, H, G, nc, Lc, hd, N, dtype): the sweep of tests/test_kernels.py
    # and its state-continuity shape (per-head B and C, G = H),
    # mamba2-130m's smoke and full widths with one group (as mamba_apply
    # passes them), two groups of three heads, then ragged Lc, hd and N,
    # one chunk shorter than a tile, and the longest chunk the kernel takes
    (2, 3, 3, 2, 32, 16, 8, torch.float32),
    (2, 3, 3, 4, 64, 32, 16, torch.float32),
    (2, 3, 3, 4, 64, 64, 32, torch.bfloat16),
    (1, 1, 1, 8, 16, 8, 4, torch.float32),
    (2, 4, 1, 3, 16, 16, 16, torch.float32),
    (2, 4, 1, 3, 256, 64, 128, torch.float32),
    (1, 6, 2, 2, 256, 64, 128, torch.bfloat16),
    (2, 2, 2, 3, 100, 40, 50, torch.float32),
    (1, 2, 1, 4, 7, 64, 128, torch.float32),
    (1, 2, 2, 1, 1024, 16, 16, torch.float32),
    # the Mamba2 path's prefill shape (B = 4, S = 8192), as chip_smoke runs it
    (4, 24, 1, 32, 256, 64, 128, torch.float32),
    (4, 24, 1, 32, 256, 64, 128, torch.bfloat16),   # mamba2-130m's prefill
]


def _ssd_inputs(rng, B, H, nc, Lc, hd, N, dtype, device, G=None):
    G = H if G is None else G
    x = _normal(rng, (B, H, nc, Lc, hd), torch.float32, device) * 0.5
    b = _normal(rng, (B, G, nc, Lc, N), torch.float32, device) * 0.5
    c = _normal(rng, (B, G, nc, Lc, N), torch.float32, device) * 0.5
    a = -torch.nn.functional.softplus(
        _normal(rng, (B, H, nc, Lc), torch.float32, device))
    return tuple(t.to(dtype) for t in (x, b, c, a))


@pytest.mark.parametrize("B,H,G,nc,Lc,hd,N,dtype", SSD_CASES)
def test_ssd_scan_kernel_equals_plain(cuda, B, H, G, nc, Lc, hd, N, dtype):
    """The kernel against the sequential recurrence, within the tolerances
    of tests/test_kernels.py (f32 atol 1e-4, bf16 5e-2; rtol 1e-2)."""
    from repro_torch.kernels.ssd_scan import ssd_scan as sk
    from repro_torch.kernels.ssd_scan.ref import ssd_ref
    args = _ssd_inputs(np.random.default_rng(Lc + hd + N), B, H, nc, Lc,
                       hd, N, dtype, cuda, G)
    before = sk.launches.count
    got = sk.ssd_scan_cuda(*args)
    torch.cuda.synchronize()
    assert sk.launches.count == before + sk.LAUNCHES_PER_CALL
    assert got.dtype == dtype and got.shape == args[0].shape
    atol = 5e-2 if dtype == torch.bfloat16 else 1e-4
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               ssd_ref(*args).float().cpu().numpy(),
                               atol=atol, rtol=1e-2)


def test_ssd_scan_kernel_takes_strided_inputs_and_refuses_past_its_widths(
        cuda):
    """Views in the model's layout are made contiguous, not misread; a
    width past the kernel's instances raises NotImplementedError."""
    from repro_torch.kernels.ssd_scan import ssd_scan as sk
    from repro_torch.kernels.ssd_scan.ref import ssd_ref
    args = _ssd_inputs(np.random.default_rng(1), 2, 3, 2, 32, 16, 8,
                       torch.float32, cuda)
    views = [t.transpose(1, 2).contiguous().transpose(1, 2) for t in args]
    assert not views[0].is_contiguous()
    np.testing.assert_allclose(sk.ssd_scan_cuda(*views).cpu().numpy(),
                               ssd_ref(*args).cpu().numpy(), atol=1e-4,
                               rtol=1e-2)
    x, b, c, a = _ssd_inputs(np.random.default_rng(2), 1, 1, 1, 16, 128, 8,
                             torch.float32, cuda)
    with pytest.raises(NotImplementedError, match="hd <= 64"):
        sk.ssd_scan_cuda(x, b, c, a)


SSD_STAGE_CASES = [
    # (B, H, G, nc, Lc, hd, N, B and C dtype): the stage kernels take
    # float32 x and rows of whole 16-byte units (ssd_scan_cuda pads them)
    (2, 3, 3, 2, 32, 16, 8, torch.float32),
    (2, 4, 2, 3, 100, 40, 48, torch.float32),
    (1, 6, 2, 2, 256, 64, 128, torch.bfloat16),
    (1, 2, 1, 4, 7, 64, 128, torch.float32),
    (1, 2, 2, 1, 1024, 16, 16, torch.float32),
    (4, 24, 1, 32, 256, 64, 128, torch.float32),
    (4, 24, 1, 32, 256, 64, 128, torch.bfloat16),   # mamba2-130m's prefill
]


@pytest.mark.parametrize("B,H,G,nc,Lc,hd,N,bdtype", SSD_STAGE_CASES)
def test_ssd_stage_kernels_equal_plain(cuda, B, H, G, nc, Lc, hd, N, bdtype):
    """Each stage kernel against its plain version on the same inputs:
    chunk states and totals, the state pass (in place) on the kernel's
    states, the chunk scan from the plain starts; one launch each.  The
    tolerances of tests/test_kernels.py's float32 case (atol 1e-4, rtol
    1e-2); the state pass, elementwise, within 1e-5 of max |S|."""
    from repro_torch.kernels.ssd_scan import ssd_scan as sk
    from repro_torch.kernels.ssd_scan import ref
    x, b, c, a = _ssd_inputs(np.random.default_rng(Lc + N), B, H, nc, Lc,
                             hd, N, torch.float32, cuda, G)
    b, c = b.to(bdtype), c.to(bdtype)

    def close(got, want, atol=1e-4, rtol=1e-2):
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   atol=atol, rtol=rtol)
    before = sk.launches.count
    states, totals = sk.chunk_states_cuda(x, b, a)
    torch.cuda.synchronize()
    ref_states, ref_totals = ref.chunk_states_ref(x, b, a)
    close(states, ref_states)
    close(totals, ref_totals, 1e-5, 1e-5)
    want = ref.state_pass_ref(states, totals)
    starts = sk.state_pass_cuda(states, totals)
    torch.cuda.synchronize()
    assert starts.data_ptr() == states.data_ptr()
    close(starts, want, 1e-5 * float(want.abs().max()), 1e-5)
    ref_starts = ref.state_pass_ref(ref_states, ref_totals)
    y = sk.chunk_scan_cuda(x, b, c, a, ref_starts)
    torch.cuda.synchronize()
    assert sk.launches.count == before + 3
    assert y.shape == x.shape and y.dtype == torch.float32
    assert y.permute(0, 2, 3, 1, 4).is_contiguous()   # the model's layout
    close(y, ref.chunk_scan_ref(x, b, c, a, ref_starts))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_kernel_reads_the_model_layout(cuda, dtype):
    """The call as mamba_apply makes it: x and a float32 views of (B, S, H,
    *), B and C views of the conv output in ``dtype``; equal to the
    recurrence, y stored as (B, nc, Lc, H, P)."""
    from repro_torch.kernels.ssd_scan import ssd_scan as sk
    from repro_torch.kernels.ssd_scan.ref import ssd_ref
    B, S, H, P, G, N, Lc = 2, 512, 4, 64, 1, 128, 256
    nc, din = S // Lc, H * P
    rng = np.random.default_rng(7)
    xbc = (_normal(rng, (B, S, din + 2 * G * N), torch.float32, cuda)
           * 0.5).to(dtype)
    xdt = _normal(rng, (B, S, H, P), torch.float32, cuda) * 0.5
    a = -torch.nn.functional.softplus(_normal(rng, (B, S, H), torch.float32,
                                              cuda))
    Bc, Cc = xbc[..., din:din + G * N], xbc[..., din + G * N:]

    def groups(t):
        return t.reshape(B, nc, Lc, G, N).permute(0, 3, 1, 2, 4)
    args = (xdt.reshape(B, nc, Lc, H, P).permute(0, 3, 1, 2, 4), groups(Bc),
            groups(Cc), a.reshape(B, nc, Lc, H).permute(0, 3, 1, 2))
    assert all(sk.bulk_ready(t) for t in args[:3])
    y = sk.ssd_scan_cuda(*args)
    torch.cuda.synchronize()
    assert y.dtype == torch.float32
    assert y.permute(0, 2, 3, 1, 4).is_contiguous()
    np.testing.assert_allclose(y.cpu().numpy(),
                               ssd_ref(*args).cpu().numpy(), atol=1e-4,
                               rtol=1e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_model_on_card_kernel_equals_plain(cuda, dtype):
    """mamba2-130m at full width and depth on the card: prefill through the
    kernel launches it once a layer, decode launches nothing, and forward
    agrees with the plain chunked form and with the token-by-token
    recurrence over two chunks."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd_scan import ssd_scan as sk
    from repro_torch.models import model as M
    cfg = get_config("mamba2-130m").with_(dtype=dtype)
    params = M.init_params(cfg, 0, device=cuda)
    P = 512
    toks = torch.randint(0, cfg.vocab_size, (2, P), device=cuda,
                         generator=torch.Generator(cuda).manual_seed(1))
    sk.launches.reset()
    full, _ = M.forward(params, cfg, tokens=toks)
    assert sk.launches.count == sk.LAUNCHES_PER_CALL * cfg.num_layers
    plain, _ = M.forward(params, cfg, tokens=toks, use_kernels=False)
    caches = M.init_cache(cfg, 2, P, device=cuda)
    steps = []
    for i in range(P):
        out, caches = M.decode_step(params, cfg, toks[:, i:i + 1], i, caches)
        steps.append(out[:, 0])
    assert sk.launches.count == sk.LAUNCHES_PER_CALL * cfg.num_layers
    rec = torch.stack(steps, 1)
    # chip_smoke.MAMBA_GATE_TOL's limits (readings in PERF.md)
    tol_plain, tol_rec = (1e-4, 1e-4) if dtype == "float32" else (3.5e-2,
                                                                  7e-2)
    scale = float(rec.abs().max())
    assert float((full - plain).abs().max()) <= tol_plain * scale
    assert float((full - rec).abs().max()) <= tol_rec * scale

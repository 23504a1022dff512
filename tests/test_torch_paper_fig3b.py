"""The paper's Fig. 3b example (tests/test_paper_examples.py) through the
port's event-driven engine, held to JAX's run on every field and to the
example's own claims.

The longest of the Section VII examples (two policies over 400,000 slots
in both packages), so it has a file of its own; the others run in
tests/test_torch_stability.py."""
import dataclasses

import numpy as np

import repro.core as J
import repro_torch.core as P


def assert_same_result(a, b):
    """Every SimResult field equal, floats bit for bit."""
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype, f.name
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert x == y, (f.name, x, y)


def test_fig3b_vqs_stable_bf_unstable():
    """Fig 3b: fixed service 100, sizes 0.2/0.5 (2:1), rate 0.0306: VQS
    stays stable; BF-J/S drifts (lock-in to the (2,1) mixed packing)."""
    out = {}
    for name in ("vqs", "bfjs"):
        res = [mod.simulate(mod.VQS(J=3) if name == "vqs" else mod.BFJS(),
                            L=1, lam=0.0306,
                            dist=mod.Discrete([0.2, 0.5], [2 / 3, 1 / 3]),
                            service=mod.ServiceModel("fixed", 100.0),
                            horizon=400_000, seed=7) for mod in (J, P)]
        assert_same_result(*res)
        out[name] = res[1]
    vqs, bf = out["vqs"], out["bfjs"]
    assert vqs.mean_queue_tail < 60
    q = bf.queue_lens
    assert q[-len(q) // 4:].mean() > 2.0 * q[: len(q) // 4].mean()
    assert bf.mean_queue_tail > 2 * vqs.mean_queue_tail

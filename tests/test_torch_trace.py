"""The port's trace readers (``repro_torch.core.trace``) against the JAX
package's ``repro.core.trace``: the same arrays, the same ``skipped``
counts, the same warnings and the same error strings, on the checked-in
fixtures and on small files written here; the Google-like synthesis bit
for bit; and ``streams_from_trace`` on a port ``Trace`` equal to JAX's."""
import os
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import trace as jt  # noqa: E402
from repro.core.engine import streams_from_trace as j_streams  # noqa: E402
from repro_torch.core import trace as pt  # noqa: E402
from repro_torch.core.engine import streams_from_trace  # noqa: E402

DATA = os.path.join(os.path.dirname(__file__), "data")
FIXTURE = os.path.join(DATA, "google_like_50.csv")
CORRUPT = os.path.join(DATA, "google_like_corrupt.csv")
FIELDS = ("arrival_slots", "cpu", "mem", "durations", "skipped")

_MACHINE_CSV = ("time,machine_id,type,cpus,memory\n"
                "0,70,1,16,64\n"
                "0,71,1,8,32\n"
                "50,71,2,,\n"
                "80,71,1,8,32\n"
                "90,70,3,16,128\n")


def _outcome(fn):
    """(value, warning messages, error) of one call, so both packages'
    calls can be compared whole."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            value, err = fn(), None
        except ValueError as e:
            value, err = None, str(e)
    return value, [(w.category, str(w.message)) for w in caught], err


def _equal_traces(a, b):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        np.testing.assert_array_equal(x, y, err_msg=f)
        assert np.asarray(x).dtype == np.asarray(y).dtype, f


def _equal_outcomes(port, ref):
    (pv, pw, pe), (jv, jw, je) = port, ref
    assert pe == je and pw == jw
    if jv is None:
        assert pv is None
    elif isinstance(jv, list):
        assert len(pv) == len(jv)
        for a, b in zip(pv, jv):
            _equal_traces(a, b)
    elif isinstance(jv, jt.Trace):
        _equal_traces(pv, jv)
    else:
        assert pv == jv


def _both(name, *args, listed=False, **kw):
    def call(mod):
        fn = getattr(mod, name)
        return _outcome(lambda: list(fn(*args, **kw)) if listed
                        else fn(*args, **kw))
    return call(pt), call(jt)


@pytest.mark.parametrize("kw", [
    {}, dict(slot_seconds=10.0), dict(slot_seconds=60.0),
    dict(normalize=False), dict(strict=True)])
@pytest.mark.parametrize("path", [FIXTURE, CORRUPT])
def test_load_trace_csv_equals_jax(path, kw):
    port, ref = _both("load_trace_csv", path, **kw)
    if path == CORRUPT and not kw.get("strict"):
        assert ref[0] is not None and ref[0].skipped == 6 and ref[1]
    _equal_outcomes(port, ref)


@pytest.mark.parametrize("chunk_rows", [1, 7, 50])
@pytest.mark.parametrize("path", [FIXTURE, CORRUPT])
def test_iter_trace_csv_and_maxima_equal_jax(path, chunk_rows):
    maxima = _both("scan_trace_maxima", path)
    _equal_outcomes(*maxima)
    cpu_cap, mem_cap = maxima[1][0]
    for kw in (dict(cpu_capacity=cpu_cap, mem_capacity=mem_cap),
               dict(normalize=False), dict(normalize=False, strict=True),
               {}):
        _equal_outcomes(*_both("iter_trace_csv", path, listed=True,
                               chunk_rows=chunk_rows, slot_seconds=10.0,
                               **kw))


@pytest.mark.parametrize("body", [
    "",                                                   # empty file
    "job_id,submit_time,cpu\n1,0.0,0.5\n",                # missing column
    "job_id,submit_time,cpu,mem,duration\n",              # no rows
    "job_id,submit_time,cpu,mem,duration\n1,x,0.5,0.5,10\n",
    "submit_time,cpu,mem,duration\n0.0,0.25,0.5,10\n3.0,0.5,0.125,5\n",
    "job_id,submit_time,cpu,mem,duration\n1,5.0,0.25,0.5,10\n"
    "9,1.0,0.3,0.3,7\n2,7.0,0.5,0.125,5\n",               # backwards time
])
def test_reader_errors_and_warnings_equal_jax(tmp_path, body):
    p = tmp_path / "t.csv"
    p.write_text(body)
    for kw in ({}, dict(strict=True), dict(normalize=False)):
        _equal_outcomes(*_both("load_trace_csv", p, **kw))
        _equal_outcomes(*_both("iter_trace_csv", p, listed=True,
                               chunk_rows=1, **kw))
    for kw in (dict(chunk_rows=0), dict(chunk_rows=1, cpu_capacity=2.0),
               dict(chunk_rows=1, cpu_capacity=-1.0, mem_capacity=1.0)):
        _equal_outcomes(*_both("iter_trace_csv", p, listed=True, **kw))
    _equal_outcomes(*_both("scan_trace_maxima", p))


@pytest.mark.parametrize("body", [
    _MACHINE_CSV,
    "time,machine_id,type,cpus,memory\n0,1,9,4,8\n",     # unknown type
    "time,machine_id,type,cpus,memory\n0,5,2,,\n",       # only REMOVEd
    "time,machine_id,type,cpus,memory\n0,1,1,x,8\n3,1,1,4,8\n",
])
def test_machine_events_equal_jax(tmp_path, body):
    p = tmp_path / "machines.csv"
    p.write_text(body)
    for kw in ({}, dict(strict=True), dict(slot_seconds=10.0)):
        (pv, pw, pe), (jv, jw, je) = _both("load_machine_events_csv", p,
                                           **kw)
        assert (pw, pe) == (jw, je)
        if jv is not None:
            for f in ("machine_ids", "cpu_capacity", "mem_capacity"):
                np.testing.assert_array_equal(getattr(pv, f),
                                              getattr(jv, f))
            assert pv.events == jv.events
            assert pv.num_servers == jv.num_servers
    if body == _MACHINE_CSV:
        me_p, me_j = pt.load_machine_events_csv(p), \
            jt.load_machine_events_csv(p)
        t = tmp_path / "trace.csv"
        t.write_text("submit_time,cpu,mem,duration\n0.0,16,128,10\n"
                     "1.0,4,32,5\n")
        _equal_outcomes(
            _outcome(lambda: list(pt.iter_trace_csv(t, chunk_rows=10,
                                                    machine_events=me_p))),
            _outcome(lambda: list(jt.iter_trace_csv(t, chunk_rows=10,
                                                    machine_events=me_j))))


class _Flaky:
    """A transport that dies on its 3rd chunk for the first two passes."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.passes = 0

    def _open(self):
        self.passes += 1
        gen = super()._open()
        if self.passes <= 2:
            def wrap(g=gen):
                for i, c in enumerate(g):
                    if i == 2:
                        raise OSError("flaky transport")
                    yield c
            return wrap()
        return gen


def test_resumable_reader_equals_jax():
    cc, mc = jt.scan_trace_maxima(FIXTURE)
    kw = dict(chunk_rows=13, slot_seconds=10.0, cpu_capacity=cc,
              mem_capacity=mc)
    runs = []
    for mod in (pt, jt):
        reader = type("Flaky", (_Flaky, mod.ResumableTraceReader), {})(
            FIXTURE, **kw)
        got = []
        while True:
            try:
                got.append(next(reader))
            except StopIteration:
                break
            except OSError:
                continue
        runs.append((got, reader.reopens))
    (pg, pr), (jg, jr) = runs
    assert pr == jr == 2
    _equal_outcomes((pg, [], None), (jg, [], None))
    _equal_outcomes((list(pt.ResumableTraceReader(FIXTURE, **kw)), [], None),
                    (jg, [], None))


@pytest.mark.parametrize("seed,kw", [
    (0, dict(n_tasks=400, horizon_slots=300)),
    (1, dict(n_tasks=2000, horizon_slots=1500, mean_duration=60.0)),
    (7, dict(n_tasks=900, horizon_slots=700, spike_values=(0.5, 1.0),
             spike_prob=0.5)),
])
def test_synthesis_and_preprocessing_equal_jax_bit_for_bit(seed, kw):
    p = pt.synthesize_google_like_trace(seed=seed, **kw)
    j = jt.synthesize_google_like_trace(seed=seed, **kw)
    _equal_traces(p, j)
    np.testing.assert_array_equal(pt.collapse_resources(p),
                                  jt.collapse_resources(j))
    _equal_traces(pt.scale_arrivals(p, 1.7), jt.scale_arrivals(j, 1.7))
    assert pt.empirical_size_stats(pt.collapse_resources(p)) == \
        jt.empirical_size_stats(jt.collapse_resources(j))

    # streams_from_trace takes the port's Trace directly, collapsed (the
    # paper's max preprocessing) and uncollapsed (cpu, mem)
    for collapse in (True, False):
        got = streams_from_trace(p, collapse=collapse, device="cpu")
        ref = j_streams(j, collapse=collapse)
        assert got.up is None and ref.up is None
        for f in ("n", "sizes", "durs"):
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(ref, f)))
        assert got.num_resources == (1 if collapse else 2)


def test_core_exports_the_jax_trace_names():
    import repro.core as j
    import repro_torch.core as p
    assert sorted(p.__all__) == sorted(j.__all__)
    for name in ("Trace", "MachineEvents", "load_trace_csv",
                 "iter_trace_csv", "synthesize_google_like_trace"):
        assert getattr(p, name) is getattr(pt, name)

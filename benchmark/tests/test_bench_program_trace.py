"""The readers of the program's own records (`harness/program.py` and
the nine metrics that use it) on a synthetic traced run and synthetic
tracer records: the window is the records before the profiled ones, the
records that raised are skipped, and every reader returns None where it
has nothing to read."""
import sys
from types import SimpleNamespace

import pytest

from harness import program, spec

FIT_METRICS = ("readbacks.fit", "readback_wait_pct.fit", "laplace_evals.fit",
               "plugin_evals.fit", "bfgs_converged_pct.fit",
               "sampler_host_us_per_round.fit", "wasted_rounds_pct.fit",
               "geweke_ms.fit")


def fit_record(i, grid=False, raised=False):
    """A fit record whose times and most counts grow with i."""
    spans = {
        "laplace": [1, 1000 * i, 800 * i],
        "laplace/bfgs": [1, 800 * i, 300 * i],
        "laplace/bfgs/readback": [6 * i, 300 * i, 0],
        "sampler": [1, 100_000 * i, 90_000 * i],
        "sampler/chunk": [5, 80_000 * i, 20_000 * i],
        "sampler/chunk/readback": [5, 20_000 * i, 0],
        "sampler/geweke": [2, 10_000 * i, 4_000 * i],
        "sampler/geweke/readback": [2, 4_000 * i, 0],
    }
    counts = {
        "laplace/bfgs": {"bfgs.evals": 3 * i, "bfgs.stop.line_search": 1},
        "laplace/bfgs/readback": {"readbacks": 6 * i},
        "sampler/chunk": {"rounds.launched": 120 * i},
        "sampler": {"rounds.kept": 100 * i},
        "sampler/chunk/readback": {"readbacks": 5},
        "sampler/geweke/readback": {"readbacks": 2},
    }
    if not grid:
        spans.update({"plugin": [1, 500 * i, 400 * i],
                      "plugin/bfgs": [8, 400 * i, 0]})
        counts["plugin/bfgs"] = {"bfgs.evals": 20 * i,
                                 "bfgs.stop.converged": 6,
                                 "bfgs.stop.maxiter": 2}
    return {"id": i, "name": "fit", "raised": raised, "start_ns": 0,
            "ns": 200_000 * i, "child_ns": 0, "spans": spans,
            "counts": counts}


def predict_record(i, raised=False):
    return {"id": i, "name": "predict", "raised": raised, "start_ns": 0,
            "ns": 10_000 * i, "child_ns": 0,
            "spans": {"moments": [1, 6_000 * i, 0],
                      "intervals": [1, 4_000 * i, 3_000 * i],
                      "intervals/draws": [1, 3_000 * i, 0]},
            "counts": {}}


@pytest.fixture
def records(monkeypatch):
    """Feed the readers these records in place of the tracer's."""
    from ccgp_tpu_torch.utils import trace

    box = []
    monkeypatch.setattr(trace, "requests", lambda: list(box))
    return box


def traced(kind, n_window, n_profiled):
    return SimpleNamespace(kind=kind, requests=[{}] * n_window,
                           profiled=[{}] * n_profiled, cfg={}, profile=None)


def read(name, tr):
    return spec.metric_reader(name)(tr)


def test_window_drops_profiled_and_raised_records(records):
    # warm-up fit 1, window fits 2-4 (and a fit 9 that raised), profiled
    # fits 5-6; each fit is followed by its predict record
    for i in (1, 2, 3, 9, 4, 5, 6):
        records.append(fit_record(i, raised=i == 9))
        records.append(predict_record(i))
    recs = program.window_records(traced("fit_predict", 3, 2))
    assert [r["id"] for r in recs] == [2, 3, 4]
    tr = traced("fit_predict", 3, 2)
    assert read("readbacks.fit", tr) == pytest.approx(
        sum(6 * i + 7 for i in (2, 3, 4)) / 3)
    assert read("laplace_evals.fit", tr) == pytest.approx(9.0)
    assert read("plugin_evals.fit", tr) == pytest.approx(60.0)
    assert read("bfgs_converged_pct.fit", tr) == pytest.approx(
        100 * 18 / 27)
    assert read("readback_wait_pct.fit", tr) == pytest.approx(
        100 * 24_300 / 200_000)
    assert read("sampler_host_us_per_round.fit", tr) == pytest.approx(
        1e-3 * (100_000 - 24_000) / 100)
    assert read("wasted_rounds_pct.fit", tr) == pytest.approx(
        100 * (1 - 100 / 120))
    assert read("geweke_ms.fit", tr) == pytest.approx(1e-6 * 10_000 * 3)
    # the predict cell: its records after the set-up fit
    records.clear()
    records.append(fit_record(1))
    for i in range(1, 8):
        records.append(predict_record(i, raised=i == 3))
    tr = traced("predict", 4, 2)
    assert [r["id"] for r in program.window_records(tr)] == [1, 2, 4, 5]
    assert read("draws_ms.predict", tr) == pytest.approx(
        1e-6 * 3_000 * (1 + 2 + 4 + 5) / 4)


def test_a_request_whose_predict_raised_is_skipped(records):
    # window requests 2-4 and 8, whose fit succeeded and whose predict
    # raised; profiled requests 5-6
    for i in (1, 2, 3, 8, 4, 5, 6):
        records.append(fit_record(i))
        records.append(predict_record(i, raised=i == 8))
    tr = traced("fit_predict", 3, 2)
    assert [r["id"] for r in program.window_records(tr)] == [2, 3, 4]


def test_a_full_buffer_gives_the_windows_newest(records, monkeypatch,
                                                capsys):
    from ccgp_tpu_torch.utils import trace

    monkeypatch.setattr(trace, "CAPACITY", 8)
    # the buffer kept the last 8 records: fits 3-6 and their predicts, of
    # a window of 4 fits (1-4) and 2 profiled (5-6)
    for i in range(3, 7):
        records.append(fit_record(i))
        records.append(predict_record(i))
    tr = traced("fit_predict", 4, 2)
    assert [r["id"] for r in program.window_records(tr)] == [3, 4]
    assert "holds the newest 2 of the window's 4" in capsys.readouterr().err
    assert read("laplace_evals.fit", tr) == pytest.approx(3 * 3.5)
    # a buffer that is not full and holds too few: nothing to read
    records.pop()
    assert program.window_records(tr) is None
    # a full buffer of the profiled requests alone: nothing to read
    records[:] = [predict_record(i) for i in range(8)]
    assert program.window_records(traced("predict", 4, 8)) is None


def test_none_where_nothing_to_read(records, monkeypatch):
    tr = traced("fit_predict", 3, 2)
    for name in FIT_METRICS:                 # an empty buffer
        assert read(name, tr) is None
    for i in range(1, 4):                    # too few records
        records.append(fit_record(i))
    for name in FIT_METRICS:
        assert read(name, tr) is None
    records.clear()
    for i in range(1, 6):                    # the grid plug-in runs no BFGS
        records.append(fit_record(i, grid=True))
    assert read("plugin_evals.fit", tr) is None
    assert read("laplace_evals.fit", tr) is not None
    records.clear()
    for i in range(1, 6):                    # a fit with no device
        rec = fit_record(i)
        rec["spans"] = {"laplace": [1, 10, 0]}
        rec["counts"] = {}
        records.append(rec)
    for name in FIT_METRICS:
        assert read(name, tr) is None, name
    assert read("draws_ms.predict", traced("predict", 3, 2)) is None
    # a program without the tracer (the parent of the change that adds it)
    import ccgp_tpu_torch.utils

    monkeypatch.setitem(sys.modules, "ccgp_tpu_torch.utils.trace", None)
    monkeypatch.delattr(ccgp_tpu_torch.utils, "trace")
    records.clear()
    for i in range(1, 6):
        records.append(fit_record(i))
    for name in FIT_METRICS:
        assert read(name, tr) is None
    assert read("draws_ms.predict", traced("predict", 3, 2)) is None


def test_readers_of_the_real_tracer():
    """The package's own tracer, as the run leaves it: a request opened and
    closed through `trace.span` is what the readers count."""
    from ccgp_tpu_torch.utils import trace

    trace.clear()
    tracer = trace.TRACER
    tracer.cpu_as_device = True
    try:
        import torch

        for _ in range(3):
            with trace.span("fit"):
                with trace.span("laplace"):
                    with trace.span("bfgs"):
                        trace.count("bfgs.evals", 4)
                        trace.readback(torch.ones(2))
                        trace.count("bfgs.stop.converged")
                with trace.span("sampler"):
                    with trace.span("chunk"):
                        trace.count("rounds.launched", 120)
                        trace.readback(torch.ones(2))
                    with trace.span("geweke"):
                        pass
                    trace.count("rounds.kept", 100)
    finally:
        tracer.cpu_as_device = False
    tr = traced("fit_predict", 2, 1)
    assert read("readbacks.fit", tr) == 2.0
    assert read("laplace_evals.fit", tr) == 4.0
    assert read("bfgs_converged_pct.fit", tr) == 100.0
    assert read("wasted_rounds_pct.fit", tr) == pytest.approx(100 / 6)
    for name in ("readback_wait_pct.fit", "sampler_host_us_per_round.fit",
                 "geweke_ms.fit"):
        v = read(name, tr)
        assert v is not None and v >= 0.0, name
    assert read("plugin_evals.fit", tr) is None
    trace.clear()

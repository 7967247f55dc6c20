"""`bfgs_graphed_pct.fit`, the share of BFGS's evaluations replayed as CUDA
graphs, on synthetic tracer records: replays over evaluations over the
window's fits, and nothing to read from a program that counts no graph
(the parent of the change that adds them, or a fit on the CPU)."""
from types import SimpleNamespace

import pytest

from harness import spec


def fit_record(i, graphs=True):
    """A fit whose plug-in multistart and Laplace search each captured one
    graph and replayed every evaluation after their first."""
    counts = {"plugin/bfgs": {"bfgs.evals": 30 + i,
                              "bfgs.stop.converged": 8},
              "laplace/bfgs": {"bfgs.evals": 20 + i,
                               "bfgs.stop.line_search": 1}}
    if graphs:
        counts["plugin/bfgs"].update({"bfgs.graph.captures": 1,
                                      "bfgs.graph.replays": 29 + i})
        counts["laplace/bfgs"].update({"bfgs.graph.captures": 1,
                                       "bfgs.graph.replays": 19 + i})
    return {"id": i, "name": "fit", "raised": False, "start_ns": 0,
            "ns": 1000, "child_ns": 0,
            "spans": {"plugin/bfgs": [8, 10, 0], "laplace/bfgs": [1, 10, 0]},
            "counts": counts}


@pytest.fixture
def records(monkeypatch):
    from ccgp_tpu_torch.utils import trace

    box = []
    monkeypatch.setattr(trace, "requests", lambda: list(box))
    return box


def read(tr):
    return spec.metric_reader("bfgs_graphed_pct.fit")(tr)


def traced(n_window, n_profiled):
    return SimpleNamespace(kind="fit_predict", requests=[{}] * n_window,
                           profiled=[{}] * n_profiled, cfg={}, profile=None)


@pytest.mark.parametrize("graphs", [True, False])
def test_replays_over_evaluations(records, graphs):
    # warm-up fit 1, window fits 2-4, profiled fits 5-6
    for i in range(1, 7):
        records.append(fit_record(i, graphs))
    got = read(traced(3, 2))
    if graphs:
        assert got == pytest.approx(
            100 * sum(48 + 2 * i for i in (2, 3, 4))
            / sum(50 + 2 * i for i in (2, 3, 4)))
    else:
        assert got is None

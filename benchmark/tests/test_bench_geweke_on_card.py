"""`geweke_on_card_pct.fit`, the share of Geweke's checks run by the card's
kernel, on synthetic tracer records: launches over `sampler/geweke` spans
over the window's fits, and nothing to read where no span exists or no
launch was counted (a program that tests its windows on the host)."""
from types import SimpleNamespace

import pytest

from harness import spec


def fit_record(i, checks=3, launched=3):
    """A fit with `checks` Geweke checks, `launched` of them on the card."""
    counts = {"sampler": {"rounds.kept": 900 + i},
              "sampler/geweke/readback": {"readbacks": checks}}
    if launched:
        counts["sampler/geweke"] = {"geweke.kernel": launched}
    spans = {"sampler": [1, 1000, 10]}
    if checks:
        spans["sampler/geweke"] = [checks, 10, 5]
        spans["sampler/geweke/readback"] = [checks, 5, 0]
    return {"id": i, "name": "fit", "raised": False, "start_ns": 0,
            "ns": 2000, "child_ns": 1000, "spans": spans, "counts": counts}


@pytest.fixture
def records(monkeypatch):
    from ccgp_tpu_torch.utils import trace

    box = []
    monkeypatch.setattr(trace, "requests", lambda: list(box))
    return box


def read(tr):
    return spec.metric_reader("geweke_on_card_pct.fit")(tr)


def traced(n_window, n_profiled):
    return SimpleNamespace(kind="fit_predict", requests=[{}] * n_window,
                           profiled=[{}] * n_profiled, cfg={}, profile=None)


@pytest.mark.parametrize("share,expected", [("all", 100.0), ("half", 50.0),
                                            ("no_span", None),
                                            ("no_launch", None)])
def test_launches_over_checks(records, share, expected):
    # warm-up fit 1, window fits 2-4, profiled fits 5-6
    for i in range(1, 7):
        if share == "all":
            records.append(fit_record(i, checks=2 + i, launched=2 + i))
        elif share == "half":
            records.append(fit_record(i, checks=4, launched=2))
        elif share == "no_span":
            records.append(fit_record(i, checks=0, launched=0))
        else:
            records.append(fit_record(i, checks=4, launched=0))
    got = read(traced(3, 2))
    if expected is None:
        assert got is None
    else:
        assert got == pytest.approx(expected)

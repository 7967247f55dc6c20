"""The end-to-end arithmetic: a rate is all the window's time over all
its requests, and a percentile is taken over every request."""
import pytest

from harness import window


def test_rate_is_all_time_over_all_requests():
    lat = [0.5] * 10
    assert window.end_to_end("fit_predict_ms", 5.0, lat, 1.0) == 500.0
    assert window.end_to_end("setup_s", 5.0, lat, 1.25) == 1.25


def test_percentile_over_every_request():
    lat = [float(i) for i in range(1, 101)]
    assert window.end_to_end("x_p80_ms", 1.0, lat, 0.0) == pytest.approx(
        1e3 * 80.2)
    assert window.percentile([3.0, 1.0, 2.0], 50) == 2.0


def test_a_stall_moves_both():
    steady = [0.1] * 50
    stalled = [0.1] * 45 + [1.1] * 5
    rate = window.end_to_end("predict_ms", sum(steady), steady, 0.0)
    rate_s = window.end_to_end("predict_ms", sum(stalled), stalled, 0.0)
    p = window.end_to_end("predict_p99_ms", 0.0, steady, 0.0)
    p_s = window.end_to_end("predict_p99_ms", 0.0, stalled, 0.0)
    assert rate_s == pytest.approx(200.0) and rate == pytest.approx(100.0)
    assert p_s > 1000.0 > p


def test_unknown_metric_raises():
    with pytest.raises(ValueError):
        window.end_to_end("tokens_per_s", 1.0, [0.1], 0.0)

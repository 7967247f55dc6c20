"""Helpers the per-layer metric readers (`metrics/<name>.py`) share.
Each returns None where the traced run gave it nothing to read."""
from __future__ import annotations

from harness import roofline


def mean_span_ms(tr, *names):
    """A span's mean milliseconds per request, over the requests the
    profiler did not slow."""
    reqs = [r for r in tr.requests if any(n in r["spans"] for n in names)]
    if not reqs:
        return None
    return 1e3 * sum(sum(r["spans"].get(n, 0.0) for n in names)
                     for r in reqs) / len(reqs)


def idle_pct(tr):
    p = tr.profile
    if not p or p["window_s"] <= 0 or p["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])


def elem(cfg) -> int:
    return 8 if cfg["dtype"] == "float64" else 4


def request_flops(tr, r) -> float:
    """The algorithm's floating-point operations of one request."""
    cfg = tr.cfg
    n, d, net = cfg["n"], cfg["dim"], cfg["net_samp_size"]
    flops = roofline.predict_flops(n, d, net, r["m"])
    if tr.kind == "fit_predict":
        flops += roofline.plugin_flops(n, d, cfg["plugin"], 8)
        flops += roofline.chain_flops(n, d, r["n_proposals"])
    return flops


def mfu_pct(tr):
    if not tr.requests:
        return None
    secs = sum(r["seconds"] for r in tr.requests)
    flops = sum(request_flops(tr, r) for r in tr.requests)
    return 100.0 * flops / (secs * roofline.PEAK_OPS[elem(tr.cfg)])

"""What the study cell's per-layer readers take from the program's tracer
(`ccgp_tpu_torch.utils.trace`): a study request is one record whose root
is `study` (`experiments.common.run_study`), with the combined GP's `fit`
and `predict`, mlegp's `mlegp`, the single GP's `single`, the composite
GP's `cgp` (`cgp/candidates`, `cgp/bfgs`, `cgp/jackknife`) and
`cgp_predict` below it; and the floating-point operations of one study.

Every function returns None where there is nothing to read: a program
without the tracer or without the study's root span, too few records."""
from __future__ import annotations

import sys

from harness import roofline
from harness.program import counter, span_ns

ROOT = "study"


def window_records(tr):
    """The window's `study` records, oldest first, as
    `harness.program.window_records` picks a fit cell's: the records of
    studies that did not raise, counted from the newest, less the last
    `len(tr.profiled)`, then the `len(tr.requests)` before them."""
    try:
        from ccgp_tpu_torch.utils import trace
    except ImportError:
        return None
    kept = trace.requests()
    recs = [r for r in kept if r.get("name") == ROOT and not r.get("raised")]
    n_prof, n_win = len(tr.profiled), len(tr.requests)
    if n_win == 0:
        return None
    if len(recs) >= n_prof + n_win:
        return recs[len(recs) - n_prof - n_win:len(recs) - n_prof]
    if len(kept) < trace.CAPACITY or len(recs) <= n_prof:
        return None
    print(f"program records: the tracer's buffer ({trace.CAPACITY} "
          f"records) holds the newest {len(recs) - n_prof} of the window's "
          f"{n_win} studies; the readers read those", file=sys.stderr)
    return recs[:len(recs) - n_prof]


def mean_span_ms(tr, name: str):
    """The mean ms a study of the spans named `name`."""
    recs = window_records(tr)
    if not recs or not any(span_ns(r, name) for r in recs):
        return None
    return 1e-6 * sum(span_ns(r, name) for r in recs) / len(recs)


def mean_counter(tr, name: str, prefix: str = ""):
    """The mean a study of counter `name` under `prefix` (the whole study
    where it is empty), where some study has `prefix` (or counts `name`)."""
    recs = window_records(tr)
    if not recs:
        return None
    if prefix:
        if not any(any(p == prefix or p.startswith(prefix + "/")
                       for p in r["spans"]) for r in recs):
            return None
    elif not any(counter(r, name) for r in recs):
        return None
    return sum(counter(r, name, prefix) for r in recs) / len(recs)


# -- operations ---------------------------------------------------------------

def se_gram_flops(n: int, m: int, d: int) -> float:
    """An SE correlation block: per entry 3d for the weighted distance and
    2 for the exponential."""
    return n * m * (3 * d + 2)


def ard_eval_flops(n: int, d: int) -> float:
    """One profile-nll evaluation at an ARD rate: the Gram (lower half),
    its factorization and the solves of 1 and y."""
    return se_gram_flops(n, n, d) / 2 + roofline.chol_solve_flops(n, 2)


def cgp_eval_flops(n: int, p: int) -> float:
    """One composite-GP objective: three Grams, four local-variance
    rounds (Q, its factorization, the GLS solves, Q^-1 (y - beta), G times
    it and the smoothing B e^2, B 1) and the last factorization with its
    solves."""
    rnd = 3 * n * n + roofline.chol_solve_flops(n, 4) + 3 * 2 * n * n
    return (3 * se_gram_flops(n, n, p) + 4 * rnd
            + roofline.chol_solve_flops(n, 3))


def study_flops(cfg: dict, rec: dict, chain: dict, m: int) -> float:
    """A study's floating-point operations: a searched evaluation is its
    forward and a backward pass counted twice the forward; the searches'
    solutions evaluated again; mlegp's isotropic grid; the composite GP's
    candidates and jackknife refits; the three predictors; the combined
    GP's chain as `harness.readers.request_flops` counts a fit's."""
    n, d, net = cfg["n"], cfg["dim"], cfg["net_samp_size"]
    ard = ard_eval_flops(n, d)
    cgp = cgp_eval_flops(n, d)
    mlegp_starts = counter(rec, "mlegp.starts", "mlegp")
    flops = 3 * ard * counter(rec, "bfgs.evals", "mlegp")
    flops += ard * (mlegp_starts + 1)
    flops += roofline.plugin_flops(n, d, "grid", 0)
    # the combined GP's own ARD plug-in search (run, and then replaced by
    # mlegp's sigma^2)
    flops += 3 * ard * counter(rec, "bfgs.evals", "fit/plugin")
    flops += 3 * cgp * counter(rec, "bfgs.evals", "cgp")
    flops += cgp * (counter(rec, "cgp.candidates", "cgp")
                    + 2 * cfg["cgp"]["starts"] + 1)
    flops += counter(rec, "cgp.jackknife_refits", "cgp") * cgp_eval_flops(
        n - 1, d)
    # predictors: single GP (cross block, solve), CGP (three cross blocks,
    # the solves of q and 1)
    flops += se_gram_flops(n, m, d) + n * n * m
    flops += 3 * se_gram_flops(n, m, d) + n * n * m + 8 * n * m
    flops += roofline.chain_flops(n, d, chain["n_proposals"])
    flops += roofline.predict_flops(n, d, net, m)
    return flops


def mfu_pct(tr):
    """The window's studies' operations over their seconds times the
    float64 peak, %."""
    recs = window_records(tr)
    if not recs or not tr.requests:
        return None
    reqs = tr.requests[-len(recs):]
    secs = sum(r["seconds"] for r in reqs)
    flops = sum(study_flops(tr.cfg, rec, r, r["m"])
                for rec, r in zip(recs, reqs))
    return 100.0 * flops / (secs * roofline.PEAK_OPS[8])

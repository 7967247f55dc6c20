"""What the per-layer readers take from the program's own tracer
(`ccgp_tpu_torch.utils.trace`): the request records of the window.

The tracer keeps one record per call of an entry point at every trace
level above 0, so the untraced and the traced runs carry the same
records; the readers read them after the window. A record is a dict:
`name` (the root span, `fit` or `predict`), `raised`, `ns` (the root's
span), `spans` ({path below the root: [count, total ns, children's ns]})
and `counts` ({path: {counter: value}}).

Every function returns None where there is nothing to read: a program
without the tracer, too few records, or no record with the span or
counter asked for."""
from __future__ import annotations

import sys

ROOTS = {"fit_predict": "fit", "predict": "predict"}


def requests_of(kind: str, records) -> list:
    """The program's records of the cell's requests, oldest first, each
    with whether its request raised: a fit+predict request is a `fit`
    record and the `predict` record after it, and raised where either of
    them did; a query is a `predict` record."""
    out = []
    for r in records:
        name = r.get("name")
        if name == ROOTS[kind]:
            out.append([r, bool(r.get("raised"))])
        elif (kind == "fit_predict" and name == "predict" and out
              and r.get("raised")):
            out[-1][1] = True
    return out


def window_records(tr):
    """The window's request records, oldest first: the records of the
    cell's requests that did not raise, counted from the newest, less the
    last `len(tr.profiled)` (the profiled requests, which the profiler
    slows), then the `len(tr.requests)` before them. Where the tracer's
    buffer is full and holds fewer, its oldest of the window's records
    went out of it: the window's newest are read, and standard error says
    so."""
    try:
        from ccgp_tpu_torch.utils import trace
    except ImportError:
        return None
    if tr.kind not in ROOTS:
        return None
    kept = trace.requests()
    recs = [r for r, raised in requests_of(tr.kind, kept) if not raised]
    n_prof, n_win = len(tr.profiled), len(tr.requests)
    if n_win == 0:
        return None
    if len(recs) >= n_prof + n_win:
        return recs[len(recs) - n_prof - n_win:len(recs) - n_prof]
    if len(kept) < trace.CAPACITY or len(recs) <= n_prof:
        return None     # the program kept fewer records than it served
    print(f"program records: the tracer's buffer ({trace.CAPACITY} "
          f"records) holds the newest {len(recs) - n_prof} of the window's "
          f"{n_win} requests; the readers read those", file=sys.stderr)
    return recs[:len(recs) - n_prof]


def under(path: str, prefix: str) -> bool:
    """Whether `path` is `prefix` or lies below it ("" is the root)."""
    return (not prefix or path == prefix
            or path.startswith(prefix + "/"))


def leaf(path: str) -> str:
    return path.rsplit("/", 1)[-1]


def counter(rec, name: str, prefix: str = "") -> int:
    """Counter `name` of a record, summed over the paths under prefix."""
    return sum(c.get(name, 0) for p, c in rec["counts"].items()
               if under(p, prefix))


def counter_prefixed(rec, start: str, prefix: str = "") -> int:
    """Counters whose names start with `start`, summed likewise."""
    return sum(v for p, c in rec["counts"].items() if under(p, prefix)
               for k, v in c.items() if k.startswith(start))


def span_ns(rec, name: str, prefix: str = "") -> int:
    """Total ns of the spans named `name` (the last part of their path)
    under prefix."""
    return sum(a[1] for p, a in rec["spans"].items()
               if leaf(p) == name and under(p, prefix))


def has_span(rec, name: str, prefix: str = "") -> bool:
    return any(leaf(p) == name and under(p, prefix) for p in rec["spans"])


def mean_per_request(tr, value, needs=None):
    """The mean of value(record) over the window's records; None without
    records, or where no record passes `needs`."""
    recs = window_records(tr)
    if not recs or (needs is not None and not any(needs(r) for r in recs)):
        return None
    return sum(value(r) for r in recs) / len(recs)


def ratio(tr, num, den, scale: float = 1.0, needs=None):
    """scale x sum of num(record) over sum of den(record), over the
    window's records; None where the denominator sums to 0, or where no
    record passes `needs`."""
    recs = window_records(tr)
    if not recs or (needs is not None and not any(needs(r) for r in recs)):
        return None
    d = sum(den(r) for r in recs)
    if d <= 0:
        return None
    return scale * sum(num(r) for r in recs) / d

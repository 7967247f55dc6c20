"""`utils/trace.py`, the port's tracer: spans nest by thread into one
record per request with self times by path, counters land on the
innermost span, the buffer is bounded, level 0 records nothing, an
exception closes its spans, and level 2 keeps a timeline. A small CPU fit
(the BFGS plug-in, a short chunked chain) carries the paths and counters
the benchmark's readers read, and its outputs are bit-identical at every
level."""
import collections
import sys
import threading
import time

import numpy as np
import pytest
import torch

from ccgp_tpu_torch.infer import optim
from ccgp_tpu_torch.models.combination import MixtureSpec
from ccgp_tpu_torch.models.combined_gp import (
    MCMCConfig, fit_combined_gp, predict_combined_gp)
from ccgp_tpu_torch.models.priors import InverseGamma, LogNormal
from ccgp_tpu_torch.ops import kernels, rng
from ccgp_tpu_torch.utils import progress, trace
from ccgp_tpu_torch.utils.trace import Tracer

CFG = dict(start=(1.0, 1.0, 0.0, 0.0), n_max=400, samp_size=120,
           net_samp_size=120, speculative=4)
N_STARTS = 8    # kriging_mle's multistart


def busy(ns):
    t0 = trace._now()
    while trace._now() - t0 < ns:
        pass


def test_nesting_paths_and_self_time():
    tr = Tracer()
    with tr.span("fit"):
        busy(200_000)
        with tr.span("laplace"):
            with tr.span("bfgs"):
                busy(300_000)
            with tr.span("bfgs"):
                busy(300_000)
        with tr.span("sampler"):
            with tr.span("chunk"):
                pass
    rec = tr.last()
    assert rec["name"] == "fit" and not rec["raised"]
    assert set(rec["spans"]) == {"laplace", "laplace/bfgs", "sampler",
                                 "sampler/chunk"}
    n, tot, child = rec["spans"]["laplace/bfgs"]
    assert n == 2 and tot >= 600_000 and child == 0
    n, tot, child = rec["spans"]["laplace"]
    assert n == 1 and child == rec["spans"]["laplace/bfgs"][1] <= tot
    assert rec["child_ns"] == tot + rec["spans"]["sampler"][1]
    assert rec["ns"] - rec["child_ns"] >= 200_000     # the root's self time
    assert tr.requests() == [rec]


def test_counters_land_on_the_innermost_path():
    tr = Tracer()
    tr.count("lost")                        # outside a request: dropped
    with tr.span("fit"):
        tr.count("readbacks")
        with tr.span("laplace"):
            tr.count("bfgs.evals", 3)
            with tr.span("bfgs"):
                tr.count("bfgs.evals")
                tr.count("bfgs.evals", 2)
            tr.count("bfgs.evals")
    assert tr.last()["counts"] == {"": {"readbacks": 1},
                                   "laplace": {"bfgs.evals": 4},
                                   "laplace/bfgs": {"bfgs.evals": 3}}
    assert len(tr.requests()) == 1


def test_buffer_is_bounded_and_level_0_records_nothing():
    tr = Tracer(capacity=4)
    for i in range(10):
        with tr.span(f"r{i}"):
            tr.count("n", i)
    assert [r["name"] for r in tr.requests()] == ["r6", "r7", "r8", "r9"]
    assert tr.last()["counts"] == {"": {"n": 9}}
    tr.clear()
    tr.set_level(0)
    with tr.span("fit") as sp:
        with tr.span("laplace"):
            tr.count("bfgs.evals")
            busy(100_000)
    assert tr.requests() == [] and tr.last() is None and tr.timeline() == []
    assert sp.seconds >= 1e-4          # a span still times itself
    with pytest.raises(ValueError):
        tr.set_level(3)


def test_level_from_the_environment(monkeypatch):
    monkeypatch.setenv("CCGP_TRACE_LEVEL", "0")
    tr = Tracer()
    assert tr.level == 0
    with tr.span("fit"):
        tr.count("n")
    assert tr.requests() == []
    monkeypatch.setenv("CCGP_TRACE_LEVEL", "2")
    assert Tracer().level == 2
    monkeypatch.delenv("CCGP_TRACE_LEVEL")
    assert Tracer().level == 1
    monkeypatch.setenv("CCGP_TRACE_LEVEL", "5")
    with pytest.raises(ValueError):
        Tracer()


def test_an_exception_closes_its_spans():
    tr = Tracer()
    with pytest.raises(ZeroDivisionError):
        with tr.span("fit"):
            with tr.span("laplace"):
                with tr.span("bfgs"):
                    1 / 0
    rec = tr.last()
    assert rec["raised"]
    assert {p: a[0] for p, a in rec["spans"].items()} == {
        "laplace": 1, "laplace/bfgs": 1}
    assert rec["spans"]["laplace"][2] == rec["spans"]["laplace/bfgs"][1]
    # a caught exception closes the inner span only
    with tr.span("predict"):
        try:
            with tr.span("moments"):
                raise KeyError
        except KeyError:
            pass
    rec = tr.last()
    assert rec["name"] == "predict" and not rec["raised"]
    assert rec["spans"]["moments"][0] == 1 and rec["counts"] == {}
    assert len(tr.requests()) == 2        # every stack closed


def test_threads_keep_separate_stacks():
    tr = Tracer()
    barrier = threading.Barrier(4, timeout=30)

    def shard(i):
        with tr.span(f"shard{i}"):
            barrier.wait()
            with tr.span("fit"):
                barrier.wait()
                tr.count("rounds.kept", i)

    threads = [threading.Thread(target=shard, args=(i,)) for i in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
        assert not th.is_alive()
    recs = {r["name"]: r for r in tr.requests()}
    assert set(recs) == {f"shard{i}" for i in range(4)}
    for i in range(4):
        assert set(recs[f"shard{i}"]["spans"]) == {"fit"}
        assert recs[f"shard{i}"]["counts"] == {"fit": {"rounds.kept": i}}


def test_level_2_timeline():
    tr = Tracer()
    tr.set_level(2)
    tr.cpu_as_device = True
    with tr.span("fit"):
        with tr.span("laplace"):
            tr.readback(torch.ones(3))
    ents = {e["path"]: e for e in tr.timeline()}
    assert set(ents) == {"fit", "laplace", "laplace/readback"}
    rid = tr.last()["id"]
    assert {e["request"] for e in ents.values()} == {rid}
    assert ents["fit"]["parent"] is None
    assert ents["laplace"]["parent"] == ents["fit"]["span"]
    assert ents["laplace/readback"]["parent"] == ents["laplace"]["span"]
    for child, parent in (("laplace", "fit"), ("laplace/readback",
                                               "laplace")):
        assert ents[parent]["start_ns"] <= ents[child]["start_ns"]
        assert ents[child]["end_ns"] <= ents[parent]["end_ns"]
    off = trace.unix_offset_ns()
    assert abs(trace._now() + off - time.time_ns()) < 5_000_000


def test_readback_counts_only_device_tensors():
    tr = Tracer()
    t = torch.arange(4)
    with tr.span("fit"):
        assert tr.readback(t) is t.cpu()      # a CPU tensor: not counted
    assert tr.last()["counts"] == {} and tr.last()["spans"] == {}
    tr.cpu_as_device = True
    with tr.span("fit"):
        with tr.span("sampler"):
            out = tr.readback(t)
            tr.readback(t)
        tr.readback(t)
    assert torch.equal(out, t)
    rec = tr.last()
    assert rec["counts"] == {"sampler/readback": {"readbacks": 2},
                             "readback": {"readbacks": 1}}
    assert rec["spans"]["sampler/readback"][0] == 2
    assert rec["spans"]["sampler"][2] == rec["spans"]["sampler/readback"][1]


def test_stage_timer_is_a_span():
    sink = {}
    with trace.span("study"):
        with progress.stage_timer("fit", sink):
            busy(100_000)
    assert sink["fit"] >= 1e-4
    rec = trace.last()
    assert rec["name"] == "study" and rec["spans"]["fit"][0] == 1
    assert rec["spans"]["fit"][1] == pytest.approx(sink["fit"] * 1e9,
                                                   abs=1)


# --- a small CPU fit --------------------------------------------------------

@pytest.fixture(scope="module")
def data():
    r = np.random.default_rng(0)
    x = torch.tensor(r.uniform(size=(20, 2)))
    y = torch.sin(5 * x[:, 0]) + torch.cos(3 * x[:, 1])
    u = np.linspace(0, 1, 6)
    grid = torch.tensor(np.stack(np.meshgrid(u, u), -1).reshape(-1, 2))
    spec = MixtureSpec(kernels.sqexp_family(), kernels.sqexp_family(),
                       dim=2, rough="tied", anisotropic=True)
    return spec, x, y, grid


def fit_predict(data, mle_method="bfgs"):
    spec, x, y, grid = data
    kf, kp = rng.split(rng.PRNGKey(1, device="cpu"), 2)
    fit = fit_combined_gp(spec, x, y, kf, mcmc=MCMCConfig(**CFG),
                          theta1_prior=LogNormal(-1.0, 1.0),
                          theta2_prior=InverseGamma(3, 4), jitter=1e-6,
                          mle_method=mle_method, device="cpu")
    pred = predict_combined_gp(spec, fit, x, grid, kp, device="cpu")
    return fit, pred


@pytest.fixture(scope="module")
def runs(data):
    """The fit at levels 0, 1 and 2 (read-backs counted from the CPU). At
    level 1 the BFGS evaluations are counted, and so are the line searches
    and the read-backs by the function that makes them."""
    mp = pytest.MonkeyPatch()
    out = {}
    try:
        trace.TRACER.cpu_as_device = True
        for level in (0, 1, 2):
            trace.set_level(level)
            trace.clear()
            evals = []
            if level == 1:
                reads = collections.Counter()
                searches = []
                vg, ls, rb = (optim._value_and_grad, optim.line_search,
                              trace.readback)

                def counted_vg(fn, x):
                    evals.append(1)
                    return vg(fn, x)

                def counted_ls(*a, **k):
                    searches.append(1)
                    return ls(*a, **k)

                def counted_rb(t):
                    reads[sys._getframe(1).f_code.co_name] += 1
                    return rb(t)

                mp.setattr(optim, "_value_and_grad", counted_vg)
                mp.setattr(optim, "line_search", counted_ls)
                mp.setattr(trace, "readback", counted_rb)
            fit, pred = fit_predict(data)
            mp.undo()
            out[level] = (fit, pred, trace.requests(), trace.timeline(),
                          len(evals))
            if level == 1:
                out["reads"], out["line_searches"] = reads, len(searches)
    finally:
        mp.undo()
        trace.set_level(1)
        trace.TRACER.cpu_as_device = False
        trace.clear()
    return out


def test_fit_record_has_the_readers_paths(runs):
    fit, pred, recs, _, n_evals = runs[1]
    assert [r["name"] for r in recs] == ["fit", "predict"]
    f, p = recs
    assert not f["raised"] and not p["raised"]
    paths = set(f["spans"])
    assert {"plugin", "plugin/bfgs", "laplace", "laplace/bfgs",
            "laplace/hessian", "laplace/eigh", "sampler", "sampler/chunk",
            "sampler/chunk/readback", "sampler/geweke",
            "sampler/geweke/readback", "factors"} <= paths
    assert f["spans"]["plugin/bfgs"][0] == N_STARTS
    assert set(p["spans"]) == {"moments", "intervals", "intervals/draws"}

    def total(rec, name, prefix=""):
        return sum(c.get(name, 0) for path, c in rec["counts"].items()
                   if not prefix or path == prefix
                   or path.startswith(prefix + "/"))

    assert total(f, "rounds.kept", "sampler") == fit.mcmc.n_rounds
    launched = total(f, "rounds.launched", "sampler")
    assert launched >= fit.mcmc.n_rounds
    stops = sum(v for c in f["counts"].values() for k, v in c.items()
                if k.startswith("bfgs.stop."))
    assert stops == N_STARTS + 1
    assert total(f, "bfgs.evals") == n_evals > 0
    assert 0 < total(f, "bfgs.evals", "laplace") < n_evals
    # one read-back a chunk (its flags) and one a Geweke check (its window)
    n_chunks = f["spans"]["sampler/chunk"][0]
    assert f["counts"]["sampler/chunk/readback"]["readbacks"] == n_chunks
    checks = f["spans"]["sampler/geweke"][0]
    assert checks > 0
    assert f["counts"]["sampler/geweke/readback"]["readbacks"] == checks
    # no BFGS evaluation reads back (its guard has no branch): each run
    # reads its first convergence test, each iteration its own test, and
    # the line search its branches
    reads, iterations = runs["reads"], runs["line_searches"]
    assert "_value_and_grad" not in reads and "__call__" not in reads
    assert iterations > 0
    assert reads["_bfgs"] == N_STARTS + 1 + iterations
    bfgs_reads = sum(c.get("readbacks", 0) for path, c in f["counts"].items()
                     if path.endswith("bfgs/readback"))
    assert bfgs_reads == (N_STARTS + 1 + iterations + reads["line_search"]
                          + reads["_zoom"])
    # the grid plug-in reads back its two argmins; Laplace its two guards
    assert f["counts"]["laplace/readback"]["readbacks"] == 2


def test_grid_plugin_reads_back_its_argmins(data):
    trace.clear()
    trace.TRACER.cpu_as_device = True
    try:
        fit_predict(data, mle_method="grid")
    finally:
        trace.TRACER.cpu_as_device = False
    f = trace.requests()[-2]
    assert f["counts"]["plugin/readback"]["readbacks"] == 2
    assert "plugin/bfgs" not in f["spans"]
    trace.clear()


def test_outputs_are_bit_identical_at_every_level(runs):
    ref_fit, ref_pred = runs[1][:2]
    for level in (0, 2):
        fit, pred = runs[level][:2]
        for a, b in ((fit.sigma2, ref_fit.sigma2),
                     (fit.mle.theta, ref_fit.mle.theta),
                     (fit.mcmc.laplace.mode, ref_fit.mcmc.laplace.mode),
                     (fit.mcmc.laplace.cov, ref_fit.mcmc.laplace.cov),
                     (fit.mcmc.samples, ref_fit.mcmc.samples),
                     (fit.mcmc.logposts, ref_fit.mcmc.logposts),
                     (fit.zs, ref_fit.zs), (fit.cache.chol,
                                            ref_fit.cache.chol),
                     (pred.draw_mean, ref_pred.draw_mean),
                     (pred.draw_var, ref_pred.draw_var),
                     (pred.mean, ref_pred.mean),
                     (pred.lower, ref_pred.lower),
                     (pred.upper, ref_pred.upper)):
            assert torch.equal(a, b)
        assert (fit.mcmc.n_rounds, fit.mcmc.n_recorded) == (
            ref_fit.mcmc.n_rounds, ref_fit.mcmc.n_recorded)
    assert runs[0][2] == [] and runs[0][3] == []
    assert runs[1][3] == []


def test_level_2_timeline_of_the_fit(runs):
    recs, tl = runs[2][2], runs[2][3]
    f = recs[0]
    mine = [e for e in tl if e["request"] == f["id"]]
    n_spans = 1 + sum(a[0] for a in f["spans"].values())
    assert len(mine) == n_spans
    by_id = {e["span"]: e for e in mine}
    for e in mine:
        if e["parent"] is None:
            assert e["path"] == "fit"
            continue
        parent = by_id[e["parent"]]
        assert parent["start_ns"] <= e["start_ns"] <= e["end_ns"] \
            <= parent["end_ns"]
        assert e["path"].startswith(parent["path"] + "/") or (
            parent["path"] == "fit" and "/" not in e["path"])
    # the level-2 record aggregates what the level-1 record does
    assert set(f["spans"]) == set(runs[1][2][0]["spans"])
    assert f["counts"] == runs[1][2][0]["counts"]

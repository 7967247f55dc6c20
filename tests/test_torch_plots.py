"""`eval/plots.py` against the JAX package's figures on the same inputs,
compared by their data, not their pixels: every axes' title and labels,
its lines' data (3-D lines' too), its collections' paths and offsets
(the PI ribbon, the scatter, the trisurf's faces after a draw), its bar
heights and its legend entries. The port takes tensors (here on the
CPU); JAX's take the same values as numpy arrays. The priors of
`prior_posterior_plot` are the port's, evaluated in torch (float64), so
its prior curves agree with JAX's within 1e-12 relative; everything else
must be equal.
"""
import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from ccgp_tpu.eval import plots as jplots  # noqa: E402
from ccgp_tpu.models import InverseGamma as JIG, LogNormal as JLN  # noqa: E402
from ccgp_tpu_torch.eval import plots as tplots  # noqa: E402
from ccgp_tpu_torch.models.priors import InverseGamma, LogNormal  # noqa: E402


def _arr(a):
    return np.asarray(a, dtype=np.float64)


def _fig_data(fig):
    fig.canvas.draw()
    out = []
    for ax in fig.axes:
        d = {"title": ax.get_title(), "xlabel": ax.get_xlabel(),
             "ylabel": ax.get_ylabel(), "lines": [], "collections": [],
             "bars": [p.get_height() for p in ax.patches]}
        for ln in ax.lines:
            d["lines"].append(_arr(ln.get_data_3d()) if hasattr(
                ln, "get_data_3d") else _arr(ln.get_xydata()))
        for c in ax.collections:
            paths = [_arr(p.vertices) for p in c.get_paths()]
            off = getattr(c, "_offsets3d", None)
            d["collections"].append(
                (paths, _arr(c.get_offsets()) if off is None
                 else _arr(np.stack([np.asarray(o) for o in off]))))
        leg = ax.get_legend()
        d["legend"] = [t.get_text() for t in leg.get_texts()] if leg else []
        out.append(d)
    out.append(fig._suptitle.get_text() if fig._suptitle else None)
    plt.close(fig)
    return out


def _same(got, ref, rtol=0.0):
    assert len(got) == len(ref)
    for g, r in zip(got[:-1], ref[:-1]):
        for k in ("title", "xlabel", "ylabel", "legend", "bars"):
            assert g[k] == r[k], k
        assert len(g["lines"]) == len(r["lines"])
        for a, b in zip(g["lines"], r["lines"]):
            np.testing.assert_allclose(a, b, rtol=rtol, atol=0)
        assert len(g["collections"]) == len(r["collections"])
        for (pa, oa), (pb, ob) in zip(g["collections"], r["collections"]):
            assert len(pa) == len(pb)
            for a, b in zip(pa, pb):
                np.testing.assert_allclose(a, b, rtol=rtol, atol=0)
            np.testing.assert_allclose(oa, ob, rtol=rtol, atol=0)
    assert got[-1] == ref[-1]


@pytest.fixture
def data():
    g = np.random.default_rng(0)
    x = np.sort(g.uniform(size=40))
    return dict(x=x, y=np.sin(6 * x), m=np.sin(6 * x) + 0.05,
                lo=np.sin(6 * x) - 0.3, hi=np.sin(6 * x) + 0.3,
                s=np.sin(6 * x) - 0.02, xt=g.uniform(size=6),
                yt=g.normal(size=6), xy=g.uniform(size=(50, 2)),
                z=g.normal(size=50), chain=g.normal(size=(300, 3)).cumsum(0),
                p=g.beta(2, 3, size=500), th1=g.gamma(3, 0.5, size=500),
                th2=g.gamma(5, 2.0, size=500))


def _t(a):
    return torch.tensor(a, dtype=torch.float64)


@pytest.mark.parametrize("full", [True, False])
def test_plot_gp_1d(data, full):
    d = data
    kw = (dict(single_mean=d["s"], x_train=d["xt"], y_train=d["yt"],
               title="1-D") if full else {})
    ref = jplots.plot_gp_1d(d["x"], d["y"], d["m"], d["lo"], d["hi"], **kw)
    got = tplots.plot_gp_1d(*(_t(d[k]) for k in ("x", "y", "m", "lo", "hi")),
                            **{k: _t(v) if isinstance(v, np.ndarray) else v
                               for k, v in kw.items()})
    _same(_fig_data(got), _fig_data(ref))


@pytest.mark.parametrize("full", [True, False])
def test_plot_gp_2d(data, full):
    d = data
    kw = (dict(lower=d["z"] - 1, upper=d["z"] + 1, x_train=d["xy"][:7],
               y_train=d["z"][:7], title="2-D") if full else {})
    ref = jplots.plot_gp_2d(d["xy"], d["z"], **kw)
    got = tplots.plot_gp_2d(_t(d["xy"]), _t(d["z"]),
                            **{k: _t(v) if isinstance(v, np.ndarray) else v
                               for k, v in kw.items()})
    _same(_fig_data(got), _fig_data(ref))


def test_prior_posterior_plot(data):
    d = data
    ref = jplots.prior_posterior_plot(d["p"], d["th1"], d["th2"],
                                      theta1_prior=JIG(3, 2),
                                      theta2_prior=JLN(1.0, 0.5),
                                      title="priors")
    got = tplots.prior_posterior_plot(_t(d["p"]), _t(d["th1"]), _t(d["th2"]),
                                      theta1_prior=InverseGamma(3, 2),
                                      theta2_prior=LogNormal(1.0, 0.5),
                                      title="priors")
    _same(_fig_data(got), _fig_data(ref), rtol=1e-12)


def test_prior_posterior_plot_without_priors_on_a_grid(data):
    d = data
    grid = np.linspace(0.01, 6.0, 50)
    ref = jplots.prior_posterior_plot(d["p"], d["th1"], d["th2"],
                                      theta_grid=grid)
    got = tplots.prior_posterior_plot(d["p"], d["th1"], d["th2"],
                                      theta_grid=grid)
    _same(_fig_data(got), _fig_data(ref))


@pytest.mark.parametrize("names", [None, ["a", "b", "c"]])
def test_mcmc_diagnostics_plot(data, names):
    ref = jplots.mcmc_diagnostics_plot(data["chain"], names=names, max_lag=20)
    got = tplots.mcmc_diagnostics_plot(_t(data["chain"]), names=names,
                                       max_lag=20)
    _same(_fig_data(got), _fig_data(ref))


def test_predicted_vs_true_plot(data):
    ref = jplots.predicted_vs_true_plot(data["y"], data["m"], title="pvt")
    got = tplots.predicted_vs_true_plot(_t(data["y"]), _t(data["m"]),
                                        title="pvt")
    _same(_fig_data(got), _fig_data(ref))


def test_kde_matches_jax(data):
    grid = np.linspace(0, 1, 30)
    np.testing.assert_array_equal(tplots._kde(_t(data["p"]), grid),
                                  jplots._kde(data["p"], grid))


def test_plots_take_cuda_style_tensors_through_the_host(data):
    """A tensor that needs grad, or sits on another device, is read
    through `.detach().cpu()`: the figure is the same."""
    t = _t(data["y"]).requires_grad_(True)
    got = tplots.predicted_vs_true_plot(t, _t(data["m"]))
    ref = tplots.predicted_vs_true_plot(data["y"], data["m"])
    _same(_fig_data(got), _fig_data(ref))

"""Plotting: the reference's visualization layer on matplotlib (port of
`ccgp_tpu/eval/plots.py`).

Covers (with reference citations for the parity check):
* 1-D truth/prediction curve with PI ribbon and training points — `plot.GP`
  (`1D Codes and Designs/1D Combined GP Public.R:1027-1066`);
* 2-D predicted surface with interval whiskers — `plot2dGP`
  (`2D Codes and Designs/2D Combined GP Isotropic Public.R:796-830`, rgl);
* prior-vs-posterior density panels for (p, theta1, theta2) —
  `prior_posterior_plot` (`1D...Public.R:908-979`, ggplot2) and the
  base-graphics density triptychs (`Heat Exchanger Emulator/Combined GP
  Heat Exchanger.R:781-813`);
* MCMC trace / autocorrelation panels (`1D...Public.R:760-770`, coda).

All functions take data (not model objects: tensors on any device, or
arrays) and return the matplotlib Figure so callers can save or display
it. The priors of `prior_posterior_plot` are evaluated through the
port's `models/priors.py`.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def _np(a) -> np.ndarray:
    """A tensor on any device, or an array, as a numpy array."""
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _mpl():
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    return plt


def plot_gp_1d(x_new, y_true, combined_mean, combined_lower, combined_upper,
               single_mean=None, x_train=None, y_train=None, title=None):
    """1-D comparison plot: truth, combined GP (with PI ribbon), single GP."""
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(10, 5))
    x = _np(x_new).reshape(-1)
    order = np.argsort(x)
    ax.fill_between(x[order], _np(combined_lower)[order],
                    _np(combined_upper)[order], color="0.85",
                    label="95% PI (combined)")
    ax.plot(x[order], _np(y_true)[order], "r-", lw=2, label="True")
    ax.plot(x[order], _np(combined_mean)[order], "k--", lw=2,
            label="Combined")
    if single_mean is not None:
        ax.plot(x[order], _np(single_mean)[order], "b:", lw=2,
                label="Single")
    if x_train is not None:
        ax.plot(_np(x_train).reshape(-1), _np(y_train), "o",
                color="darkgreen", ms=8, label="Design")
    ax.set_xlabel("x")
    ax.set_ylabel("y(x)")
    ax.legend()
    if title:
        ax.set_title(title)
    fig.tight_layout()
    return fig


def plot_gp_2d(x_new, mean, lower=None, upper=None, x_train=None,
               y_train=None, title=None):
    """2-D predicted surface (trisurf) with optional PI whiskers."""
    plt = _mpl()
    fig = plt.figure(figsize=(9, 7))
    ax = fig.add_subplot(111, projection="3d")
    xy = _np(x_new)
    z = _np(mean)
    ax.plot_trisurf(xy[:, 0], xy[:, 1], z, cmap="viridis", alpha=0.8,
                    linewidth=0.1)
    if lower is not None and upper is not None:
        lo, hi = _np(lower), _np(upper)
        step = max(1, len(z) // 60)  # whisker subsample like the rgl plot
        for i in range(0, len(z), step):
            ax.plot([xy[i, 0]] * 2, [xy[i, 1]] * 2, [lo[i], hi[i]],
                    c="gray", lw=0.8)
    if x_train is not None and y_train is not None:
        xt = _np(x_train)
        ax.scatter(xt[:, 0], xt[:, 1], _np(y_train), c="red", s=40)
    ax.set_xlabel("x1")
    ax.set_ylabel("x2")
    ax.set_zlabel("y")
    if title:
        ax.set_title(title)
    fig.tight_layout()
    return fig


def _kde(samples, grid):
    from scipy.stats import gaussian_kde

    return gaussian_kde(_np(samples))(grid)


def prior_posterior_plot(p_samples, theta1_samples, theta2_samples,
                         theta1_prior=None, theta2_prior=None,
                         theta_grid=None, title=None):
    """Three-panel prior-vs-posterior overlay for (p, theta1, theta2).

    theta*_prior: objects with .prob(x) (e.g. models.priors.InverseGamma),
    evaluated on a float64 tensor;
    p's prior is flat on (0,1).
    """
    plt = _mpl()
    fig, axes = plt.subplots(1, 3, figsize=(15, 4))
    names = ["$p$", r"$\theta_1$", r"$\theta_2$"]
    samp = [_np(p_samples), _np(theta1_samples), _np(theta2_samples)]
    import torch

    for i, (ax, name, s) in enumerate(zip(axes, names, samp)):
        if i == 0:
            grid = np.linspace(1e-3, 1 - 1e-3, 200)
            prior = np.ones_like(grid)
        else:
            hi = max(np.quantile(s, 0.999) * 1.3, 1.0)
            grid = np.linspace(1e-3, hi, 300) if theta_grid is None else theta_grid
            pr = theta1_prior if i == 1 else theta2_prior
            prior = (_np(pr.prob(torch.as_tensor(grid, dtype=torch.float64)))
                     if pr is not None else None)
        ax.plot(grid, _kde(s, grid), "k-", lw=2, label="Posterior")
        if prior is not None:
            ax.plot(grid, prior, "r--", lw=2, label="Prior")
        ax.set_title(f"Distribution of {name}")
        ax.legend()
    if title:
        fig.suptitle(title)
    fig.tight_layout()
    return fig


def mcmc_diagnostics_plot(samples, names: Optional[Sequence[str]] = None,
                          max_lag: int = 40):
    """Autocorrelation (top row) + trace (bottom row) per parameter —
    the coda autocorr.plot/traceplot panel."""
    plt = _mpl()
    s = _np(samples)
    n, d = s.shape
    names = names or [f"param {i}" for i in range(d)]
    fig, axes = plt.subplots(2, d, figsize=(4.5 * d, 6))
    axes = np.atleast_2d(axes)
    for j in range(d):
        col = s[:, j] - s[:, j].mean()
        denom = np.dot(col, col)
        acf = [1.0] + [np.dot(col[:-l], col[l:]) / denom
                       for l in range(1, max_lag + 1)]
        axes[0, j].bar(range(max_lag + 1), acf, width=0.6)
        axes[0, j].set_title(f"Autocorrelation of {names[j]}")
        axes[0, j].set_ylim(-1, 1)
        axes[1, j].plot(s[:, j], lw=0.6)
        axes[1, j].set_title(f"Trace of {names[j]}")
    fig.tight_layout()
    return fig


def predicted_vs_true_plot(y_true, y_pred, title=None):
    """Scatter of predictions against truth with the 45-degree line
    (`Heat Exchanger Emulator/Combined GP Heat Exchanger.R:837-840`)."""
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(6, 6))
    yt, yp = _np(y_true), _np(y_pred)
    ax.plot(yt, yp, "ko", ms=5)
    lims = [min(yt.min(), yp.min()), max(yt.max(), yp.max())]
    ax.plot(lims, lims, "r--", lw=2)
    ax.set_xlabel("True Values")
    ax.set_ylabel("Predicted Values")
    if title:
        ax.set_title(title)
    fig.tight_layout()
    return fig

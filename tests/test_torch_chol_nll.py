"""K9, the per-matrix Cholesky + NLL kernel (`ops/chol_nll.py`), on the
CPU: its plain twin against the JAX package's Pallas kernel in interpret
mode (`chol_quadratics(use_pallas=True, interpret=True)`), float64.

Tolerances: the twin performs the Pallas kernel's left-looking panels in
the same order, but XLA sums the panels' dot products and the quadratics
in an order of its own, so the two agree to roundoff amplified by the
Grams' condition number. At the shapes and jitters of
`tests/test_pallas_chol.py:37-45,77-85` with rates that keep the condition
number at 1e4-1e6: 1e-10 relative to max(1, |value|) (measured <= 1e-11).
The same file's own data (rate 1 at jitter 1e-8: condition ~1e9) differs
by up to 1e-8 between the Pallas kernel and XLA's bordered path too; it is
held to 1e-7. `use_pallas=False` is the same bordered factorization in both
packages: 1e-10.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccgp_tpu.ops import kernels as jkern
from ccgp_tpu.ops.pallas_chol import chol_quadratics as jchol_quadratics
from ccgp_tpu_torch.ops import chol_lanes, chol_nll
from ccgp_tpu_torch.ops.chol import chol_quadratics

KEYS = ("logdet", "qyy", "qoy", "qoo")


def close(got, ref, tol):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    err = np.abs(got - ref) / np.maximum(1.0, np.abs(ref))
    assert float(err.max(initial=0.0)) <= tol, float(err.max())


def batch(b, n, seed, lo=20.0, hi=60.0):
    """(B, n, n) SE Grams of one uniform 2-D design (rates lo..hi over the
    batch; hi alone for B = 1) and a response, as numpy float64."""
    r = np.random.default_rng(seed)
    x = r.uniform(size=(n, 2))
    th = np.linspace(lo, hi, b)
    grams = np.stack([np.asarray(jkern.sqexp_gram(jnp.asarray(x), t))
                      for t in th])
    return grams, r.normal(size=n)


@pytest.mark.parametrize("b,n,jitter,lo,tol", [
    (4, 33, 1e-8, 20.0, 1e-10), (1, 128, 1e-6, 60.0, 1e-10),
    (4, 33, 1e-8, 1.0, 1e-7)])         # test_pallas_chol.py's rates 1..12
def test_plain_matches_pallas_interpret(b, n, jitter, lo, tol):
    if lo == 1.0:
        g, y = batch(b, n, seed=0, lo=1.0, hi=12.0)
    else:
        g, y = batch(b, n, seed=n, lo=lo)
    ref = jchol_quadratics(jnp.asarray(g), jnp.asarray(y), jitter=jitter,
                           use_pallas=True, interpret=True)
    before = chol_nll.chol_nll.launches
    got = chol_quadratics(torch.tensor(g), torch.tensor(y), jitter=jitter,
                          use_pallas=True)
    assert chol_nll.chol_nll.launches == before   # the CPU takes the twin
    for k in KEYS:
        close(got[k], ref[k], tol)


def test_use_pallas_false_matches_jax():
    g, y = batch(5, 20, seed=1)
    ref = jchol_quadratics(jnp.asarray(g), jnp.asarray(y), jitter=1e-10,
                           use_pallas=False)
    got = chol_quadratics(torch.tensor(g), torch.tensor(y), jitter=1e-10,
                          use_pallas=False)
    for k in KEYS:
        close(got[k], ref[k], 1e-10)


def test_use_pallas_none_keeps_the_routing():
    """The default still takes K3 for B >= 64 (here its plain twin, the
    same numbers bit for bit)."""
    g, y = (torch.tensor(a) for a in batch(64, 14, seed=2))
    got = chol_quadratics(g, y, jitter=1e-8)
    ref = chol_lanes.chol_quadratics_lanes_plain(g, y, 1e-8)
    for k in KEYS:
        assert torch.equal(got[k], ref[k])


def test_partial_panel_against_dense():
    """n not a multiple of the panel width, against numpy's dense algebra."""
    g, y = batch(3, 13, seed=3)
    got = chol_nll.chol_nll(torch.tensor(g), torch.tensor(y), jitter=1e-8)
    for i in range(3):
        r = g[i] + 1e-8 * np.eye(13)
        rinv = np.linalg.inv(r)
        ones = np.ones(13)
        close(got["logdet"][i], np.linalg.slogdet(r)[1], 1e-8)
        close(got["qyy"][i], y @ rinv @ y, 1e-6)
        close(got["qoy"][i], ones @ rinv @ y, 1e-6)
        close(got["qoo"][i], ones @ rinv @ ones, 1e-6)


def test_nan_on_indefinite_members_only():
    r = np.random.default_rng(4)
    v = r.normal(size=(6, 20, 10))
    low = v @ np.swapaxes(v, 1, 2) / 20
    shift = np.where(np.arange(6) % 2 == 1, -1e-2, 1e-2)
    g = torch.tensor(low + shift[:, None, None] * np.eye(20))
    got = chol_nll.chol_nll(g, torch.tensor(r.normal(size=20)))
    for k in KEYS:
        assert torch.equal(~torch.isfinite(got[k]),
                           torch.arange(6) % 2 == 1), k


def test_reads_the_lower_triangle_only():
    g, y = (torch.tensor(a) for a in batch(3, 21, seed=5))
    junk = g.clone()
    iu = torch.triu_indices(21, 21, 1)
    junk[:, iu[0], iu[1]] = float("nan")
    a = chol_nll.chol_nll(g, y, jitter=1e-8)
    b = chol_nll.chol_nll(junk, y, jitter=1e-8)
    for k in KEYS:
        assert torch.equal(a[k], b[k]), k


def test_n_above_128_raises():
    g = torch.eye(129, dtype=torch.float64)[None]
    with pytest.raises(ValueError, match="n must be <= 128"):
        chol_quadratics(g, torch.zeros(129, dtype=torch.float64),
                        use_pallas=True)
    with pytest.raises(ValueError):
        jchol_quadratics(jnp.asarray(g.numpy()), jnp.zeros(129),
                         use_pallas=True, interpret=True)

"""The port's 1-D families (Matern, cubic spline) and their mixtures against
the JAX package, float64 on the CPU: grams, crosses, the spline's support
edges |h| = theta/2 and theta, and `mixed_gram` / `mixed_cross` for the
two 1-D specs of the reference (Matern x Matern, Matern x spline).

Tolerance 1e-12 relative to max(1, |value|): the same elementwise
formulas, with K_v held to 1e-12 in test_torch_bessel.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccgp_tpu.models import MixtureSpec as JSpec
from ccgp_tpu.models.combination import (
    mixed_cross as jcross, mixed_gram as jgram, unpack as junpack)
from ccgp_tpu.ops import distance as jdist
from ccgp_tpu.ops import kernels as jkern
from ccgp_tpu_torch.models.combination import (
    MixtureSpec as TSpec, mixed_cross as tcross, mixed_gram as tgram,
    unpack as tunpack)
from ccgp_tpu_torch.ops import distance as tdist
from ccgp_tpu_torch.ops import kernels as tkern

TOL = 1e-12


def close(got, ref):
    got = got.detach().numpy()
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref) / np.maximum(1.0, np.abs(ref))
    assert float(err.max(initial=0.0)) <= TOL, float(err.max())


@pytest.fixture(scope="module")
def pts():
    r = np.random.default_rng(5)
    return r.uniform(size=(9, 1)), np.linspace(0, 1, 13)[:, None]


def test_absdiff(pts):
    x, xn = pts
    close(tdist.pairwise_absdiff(torch.tensor(x[:, 0])),
          jdist.pairwise_absdiff(jnp.asarray(x[:, 0])))
    close(tdist.cross_absdiff(torch.tensor(x[:, 0]), torch.tensor(xn[:, 0])),
          jdist.cross_absdiff(jnp.asarray(x[:, 0]), jnp.asarray(xn[:, 0])))


@pytest.mark.parametrize("nu", [0.5, 1.5, 2.2, 5.0])
@pytest.mark.parametrize("theta", [0.05, 0.4, 3.0])
def test_matern_gram_and_cross(pts, nu, theta):
    x, xn = pts
    close(tkern.matern_gram(torch.tensor(x), torch.tensor(theta, dtype=torch.float64), nu),
          jkern.matern_gram(jnp.asarray(x), theta, nu))
    close(tkern.matern_cross(torch.tensor(x), torch.tensor(xn),
                             torch.tensor(theta, dtype=torch.float64), nu),
          jkern.matern_cross(jnp.asarray(x), jnp.asarray(xn), theta, nu))


@pytest.mark.parametrize("theta", [0.05, 0.4, 3.0])
def test_spline_gram_and_cross(pts, theta):
    x, xn = pts
    close(tkern.spline_gram(torch.tensor(x), torch.tensor(theta, dtype=torch.float64)),
          jkern.spline_gram(jnp.asarray(x), theta))
    close(tkern.spline_cross(torch.tensor(x), torch.tensor(xn),
                             torch.tensor(theta, dtype=torch.float64)),
          jkern.spline_cross(jnp.asarray(x), jnp.asarray(xn), theta))


def test_spline_support_edges():
    theta = 0.8
    h = np.array([0.0, 0.2, 0.4, np.nextafter(0.4, 1.0), 0.6, 0.8,
                  np.nextafter(0.8, 1.0), 1.2])
    got = tkern.spline_corr(torch.tensor(h), torch.tensor(theta, dtype=torch.float64))
    close(got, jkern.spline_corr(jnp.asarray(h), theta))
    # continuous at theta / 2 (value 1/4) and zero from theta on
    assert abs(float(got[2]) - 0.25) < 1e-15
    assert float(got[5]) == 0.0 and float(got[7]) == 0.0


def test_matern_at_zero_and_far():
    h = np.array([0.0, 1e-300, 1e-12, 0.3, 50.0, 1e4])
    close(tkern.matern_corr(torch.tensor(h), torch.tensor(0.2, dtype=torch.float64), 5.0),
          jkern.matern_corr(jnp.asarray(h), 0.2, 5.0))


def test_batched_scales_match_a_vmap(pts):
    """The port batches scales (K,) where the JAX package vmaps."""
    x, _ = pts
    th = np.array([0.1, 0.5, 2.0])
    ref = jax.vmap(lambda t: jkern.matern_gram(jnp.asarray(x), t, 5.0))(
        jnp.asarray(th))
    close(tkern.matern_gram(torch.tensor(x), torch.tensor(th)[:, None], 5.0),
          ref)
    close(tkern.matern_family(5.0).corr_from_raw(
        tdist.pairwise_absdiff(torch.tensor(x[:, 0])), torch.tensor(th)), ref)


FAMILIES = {
    "matern_matern": lambda k: (k.matern_family(5.0), k.matern_family(5.0)),
    "matern_spline": lambda k: (k.matern_family(5.0), k.spline_family()),
}


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_mixed_gram_and_cross(pts, name):
    x, xn = pts
    js = JSpec(*FAMILIES[name](jkern), dim=1)
    ts = TSpec(*FAMILIES[name](tkern), dim=1)
    zs = np.random.default_rng(1).normal(size=(5, 3)) * [1.0, 1.0, 1.5]
    jp = jax.vmap(lambda z: junpack(js, z)[0])(jnp.asarray(zs))
    tp, _ = tunpack(ts, torch.tensor(zs))
    close(tgram(ts, torch.tensor(x), tp),
          jax.vmap(lambda p: jgram(js, jnp.asarray(x), p))(jp))
    for normalized in (True, False):
        close(tcross(ts, torch.tensor(x), torch.tensor(xn), tp,
                     normalized=normalized),
              jax.vmap(lambda p: jcross(js, jnp.asarray(x), jnp.asarray(xn),
                                        p, normalized=normalized))(jp))
    # one unbatched draw, as make_logpost evaluates it
    tp1, _ = tunpack(ts, torch.tensor(zs[0]))
    jp1, _ = junpack(js, jnp.asarray(zs[0]))
    close(tgram(ts, torch.tensor(x), tp1), jgram(js, jnp.asarray(x), jp1))

"""The maximum-entropy design slice on the CPU, float64, against the JAX
package: `ops/linalg`'s PSD and Schur functions, the entropy criteria and
their gradients, `optimum_lhs`, the design searches and k-medoids.

Tolerances: deterministic math at the same inputs 1e-10 relative to
max(1, |value|), NaN and +inf in the same places; `optimum_lhs` designs
and k-medoids indices equal (bit for bit). A design search from scratch
carries BFGS's stopping point (`tests/test_torch_baselines.py`): starts
equal, designs within 1e-6, scores within 1e-9.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccgp_tpu import design as jdesign
from ccgp_tpu.design import lhs as jlhs
from ccgp_tpu.models.combination import MixParams as JParams
from ccgp_tpu.models.combination import MixtureSpec as JSpec
from ccgp_tpu.models.combination import mixed_gram as jgram
from ccgp_tpu.ops import kernels as jkern, linalg as jlinalg
from ccgp_tpu_torch import design as tdesign
from ccgp_tpu_torch.design import lhs as tlhs
from ccgp_tpu_torch.design import optimize as toptimize
from ccgp_tpu_torch.models.combination import MixParams as TParams
from ccgp_tpu_torch.models.combination import MixtureSpec as TSpec
from ccgp_tpu_torch.models.combination import mixed_gram as tgram
from ccgp_tpu_torch.ops import kernels as tkern, linalg as tlinalg, rng

JSPEC = JSpec(jkern.sqexp_family(), jkern.sqexp_family(), dim=2)
TSPEC = TSpec(tkern.sqexp_family(), tkern.sqexp_family(), dim=2)
# the reference's prior-mean plug-in of the initial ME design
JPAR = JParams(p=jnp.asarray(0.5), theta1=jnp.asarray(1.0),
               theta2=jnp.asarray(4.0))
TPAR = TParams(p=torch.tensor(0.5, dtype=torch.float64),
               theta1=torch.tensor(1.0, dtype=torch.float64),
               theta2=torch.tensor(4.0, dtype=torch.float64))


def t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def close(got, ref, tol=1e-10):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert np.array_equal(np.isnan(got), np.isnan(ref))
    assert np.array_equal(np.isinf(got), np.isinf(ref))
    ok = np.isfinite(ref)
    err = np.abs(got[ok] - ref[ok]) / np.maximum(1.0, np.abs(ref[ok]))
    assert float(err.max(initial=0.0)) <= tol, float(err.max())


def psd(r, n, rank=None):
    a = r.normal(size=(n, rank or n))
    return a @ a.T + (0.0 if rank else n * np.eye(n))


# ---------------------------------------------------------------------------
# ops/linalg: solve_psd, logdet_psd, schur_complement, augmented_logdet
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("jitter", [0.0, 1e-6])
def test_psd_solve_and_logdet_match_jax(jitter):
    r = np.random.default_rng(1)
    a = np.stack([psd(r, 9) for _ in range(3)])
    b = r.normal(size=(3, 9))
    bm = r.normal(size=(3, 9, 2))
    close(tlinalg.solve_psd(t(a), t(b), jitter),
          jlinalg.solve_psd(jnp.asarray(a), jnp.asarray(b), jitter))
    close(tlinalg.solve_psd(t(a), t(bm), jitter),
          jlinalg.solve_psd(jnp.asarray(a), jnp.asarray(bm), jitter))
    close(tlinalg.logdet_psd(t(a), jitter),
          jlinalg.logdet_psd(jnp.asarray(a), jitter))


def test_schur_and_augmented_logdet_match_jax():
    r = np.random.default_rng(2)
    full = psd(r, 12)
    r_old, r_cross, r_new = full[:8, :8], full[8:, :8], full[8:, 8:]
    j_chol = jlinalg.jitter_cholesky(jnp.asarray(r_old))
    t_chol = tlinalg.jitter_cholesky(t(r_old))
    close(t_chol, j_chol)
    close(tlinalg.schur_complement(t(r_new), t(r_cross), t_chol),
          jlinalg.schur_complement(jnp.asarray(r_new), jnp.asarray(r_cross),
                                   j_chol))
    for jitter in (0.0, 1e-8):
        got = tlinalg.augmented_logdet(t(r_new), t(r_cross), t_chol, jitter)
        close(got, jlinalg.augmented_logdet(
            jnp.asarray(r_new), jnp.asarray(r_cross), j_chol, jitter))
    # the log det of the Schur complement is that of the whole minus R_old's
    want = np.linalg.slogdet(full)[1] - np.linalg.slogdet(r_old)[1]
    close(tlinalg.augmented_logdet(t(r_new), t(r_cross), t_chol), want, 1e-9)


def test_singular_matrix_gives_nan_not_an_exception():
    r = np.random.default_rng(3)
    a = np.stack([psd(r, 6, rank=3), psd(r, 6)])     # one singular, one not
    b = r.normal(size=(2, 6))
    got = tlinalg.solve_psd(t(a), t(b))
    ld = tlinalg.logdet_psd(t(a))
    assert bool(torch.isnan(got[0]).all()) and bool(torch.isnan(ld[0]))
    close(got, jlinalg.solve_psd(jnp.asarray(a), jnp.asarray(b)))
    close(ld, jlinalg.logdet_psd(jnp.asarray(a)))


# ---------------------------------------------------------------------------
# design/entropy: me_criterion, augmented_me_criterion and their gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("criterion", ["logdet", "det"])
def test_me_criterion_and_gradient_match_jax(criterion):
    d = np.random.default_rng(4).uniform(-1, 1, size=(8, 2))
    jv, jg = jax.value_and_grad(lambda z: jdesign.me_criterion(
        JSPEC, z, JPAR, criterion=criterion))(jnp.asarray(d))
    z = t(d).requires_grad_(True)
    tv = tdesign.me_criterion(TSPEC, z, TPAR, criterion=criterion)
    (tg,) = torch.autograd.grad(tv, z)
    close(tv, jv)
    close(tg, jg)
    # the scores are -det R and -log det R
    r = np.asarray(jgram(JSPEC, jnp.asarray(d), JPAR))
    want = (-np.linalg.det(r) if criterion == "det"
            else -np.linalg.slogdet(r)[1])
    close(tv, want, 1e-9)


@pytest.mark.parametrize("criterion", ["logdet", "det"])
@pytest.mark.parametrize("jitter", [0.0, 1e-8])
def test_augmented_criterion_and_gradient_match_jax(criterion, jitter):
    r = np.random.default_rng(5)
    d_old = r.uniform(-1, 1, size=(10, 2))
    d_new = r.uniform(-1, 1, size=(4, 2))
    j_chol = jlinalg.jitter_cholesky(jgram(JSPEC, jnp.asarray(d_old), JPAR))
    t_chol = tlinalg.jitter_cholesky(tgram(TSPEC, t(d_old), TPAR))
    close(t_chol, j_chol)
    jv, jg = jax.value_and_grad(lambda z: jdesign.augmented_me_criterion(
        JSPEC, jnp.asarray(d_old), j_chol, z, JPAR, criterion=criterion,
        jitter=jitter))(jnp.asarray(d_new))
    z = t(d_new).requires_grad_(True)
    tv = tdesign.augmented_me_criterion(TSPEC, t(d_old), t_chol, z, TPAR,
                                        criterion=criterion, jitter=jitter)
    (tg,) = torch.autograd.grad(tv, z)
    close(tv, jv)
    close(tg, jg)


def test_failed_factorization_scores_plus_inf():
    """A NaN coordinate fails the factorization: +inf under both criteria
    and for the augmented one, never NaN. A repeated point makes R singular
    in exact arithmetic; its Cholesky then ends in a pivot of rounding
    size, so both packages score it far worse than any design (log det
    below -30) but not alike."""
    d = np.random.default_rng(6).uniform(-1, 1, size=(6, 2))
    nan_d = d.copy()
    nan_d[2, 0] = np.nan
    for crit in ("logdet", "det"):
        got = tdesign.me_criterion(TSPEC, t(nan_d), TPAR, criterion=crit)
        ref = jdesign.me_criterion(JSPEC, jnp.asarray(nan_d), JPAR,
                                   criterion=crit)
        assert float(got) == np.inf
        close(got, ref)
    d_old = d[:3]
    t_chol = tlinalg.jitter_cholesky(tgram(TSPEC, t(d_old), TPAR))
    j_chol = jlinalg.jitter_cholesky(jgram(JSPEC, jnp.asarray(d_old), JPAR))
    d_new = np.stack([[np.nan, 0.2], [0.3, 0.4]])
    for crit in ("logdet", "det"):
        got = tdesign.augmented_me_criterion(TSPEC, t(d_old), t_chol,
                                             t(d_new), TPAR, criterion=crit)
        ref = jdesign.augmented_me_criterion(JSPEC, jnp.asarray(d_old),
                                             j_chol, jnp.asarray(d_new),
                                             JPAR, criterion=crit)
        assert float(got) == np.inf
        close(got, ref)
    d[3] = d[1]
    got = float(tdesign.me_criterion(TSPEC, t(d), TPAR))
    ref = float(jdesign.me_criterion(JSPEC, jnp.asarray(d), JPAR))
    assert got > 30.0 and ref > 30.0


# ---------------------------------------------------------------------------
# design/lhs.optimum_lhs: bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("n", [5, 7, 14])
def test_optimum_lhs_equals_jax_bit_for_bit(n, d, seed):
    ref = np.asarray(jlhs.optimum_lhs(jax.random.PRNGKey(seed), n, d))
    got = tlhs.optimum_lhs(rng.PRNGKey(seed, device="cpu"), n, d).numpy()
    assert np.array_equal(got, ref)
    # a Latin hypercube: one point per stratum in every column
    for j in range(d):
        assert np.array_equal(np.sort(np.floor(got[:, j] * n)), np.arange(n))


def test_optimum_lhs_improves_the_s_criterion():
    key = rng.PRNGKey(4, device="cpu")
    start = tlhs.random_lhs(key, 10, 2)
    best = tlhs.optimum_lhs(key, 10, 2)
    assert float(tlhs._s_criterion(best)) < float(tlhs._s_criterion(start))


# ---------------------------------------------------------------------------
# design/optimize: me_design and batch_me_design from scratch
# ---------------------------------------------------------------------------

SMALL = dict(n_starts=3, maxiter=40)


def test_search_starts_equal_jax():
    key = 11
    jstarts = np.stack([
        -1.0 + 2.0 * np.asarray(jlhs.optimum_lhs(k, 6, 2)).reshape(-1)
        for k in jax.random.split(jax.random.PRNGKey(key), 3)])
    got = toptimize._starts(rng.PRNGKey(key, device="cpu"), 6, 2, 3,
                            (-1.0, 1.0), torch.float64)
    assert np.array_equal(got.numpy(), jstarts)


def test_me_design_matches_jax():
    ref = jdesign.me_design(JSPEC, JPAR, 6, 2, jax.random.PRNGKey(0), **SMALL)
    got = tdesign.me_design(TSPEC, TPAR, 6, 2, rng.PRNGKey(0, device="cpu"),
                            **SMALL)
    close(got.design, ref.design, 1e-6)
    close(got.score, ref.score, 1e-9)
    close(got.log_entropy, ref.log_entropy, 1e-9)
    assert bool((got.design.abs() <= 1.0).all())


def test_batch_me_design_matches_jax():
    d_old = np.asarray(jlhs.optimum_lhs(jax.random.PRNGKey(5), 8, 2)) * 2 - 1
    ref = jdesign.batch_me_design(JSPEC, JPAR, jnp.asarray(d_old), 3,
                                  jax.random.PRNGKey(1), **SMALL)
    got = tdesign.batch_me_design(TSPEC, TPAR, t(d_old), 3,
                                  rng.PRNGKey(1, device="cpu"), **SMALL)
    close(got.design, ref.design, 1e-6)
    close(got.score, ref.score, 1e-9)
    close(got.log_entropy, ref.log_entropy, 1e-9)
    # the found batch beats a uniform one at the same plug-in
    chol = tlinalg.jitter_cholesky(tgram(TSPEC, t(d_old), TPAR))
    rand = t(np.random.default_rng(0).uniform(-1, 1, (3, 2)))
    assert float(got.score) < float(tdesign.augmented_me_criterion(
        TSPEC, t(d_old), chol, rand, TPAR))


# ---------------------------------------------------------------------------
# design/kmedoids
# ---------------------------------------------------------------------------

def _kmedoids_equal(pts, k, seed, **kw):
    ref = jdesign.kmedoids(jnp.asarray(pts), k, jax.random.PRNGKey(seed),
                           **kw)
    got = tdesign.kmedoids(t(pts), k, rng.PRNGKey(seed, device="cpu"), **kw)
    assert np.array_equal(got.medoid_idx.numpy(), np.asarray(ref.medoid_idx))
    assert np.array_equal(got.labels.numpy(), np.asarray(ref.labels))
    close(got.medoids, ref.medoids, 0.0)
    close(got.cost, ref.cost)
    return got


def test_kmedoids_blobs_match_jax():
    r = np.random.default_rng(0)
    centers = np.array([[0, 0], [5, 5], [-5, 5]])
    pts = np.concatenate([c + 0.3 * r.normal(size=(40, 2)) for c in centers])
    got = _kmedoids_equal(pts, 3, 0)
    med = np.sort(got.medoids.numpy(), axis=0)
    assert np.allclose(med, np.sort(centers, axis=0), atol=0.6)
    _kmedoids_equal(pts, 3, 1, metric="sqeuclidean", n_restarts=4)


def test_kmedoids_on_the_subdesign_cloud_matches_jax():
    """The first 700 points of the in-repo cloud of regenerated
    second-batch subdesigns, 7 medoids from 16 restarts."""
    import pathlib

    cloud = np.load(pathlib.Path(__file__).resolve().parent.parent
                    / "results" / "regenerated_subdesigns.npy")[:700]
    _kmedoids_equal(cloud, 7, 3, n_restarts=16)

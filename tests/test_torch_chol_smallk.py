"""The small-K kernels' plain twins (K5 `chol_quadratics_smallk`, K6
`fused_mix_quadratics_smallk`, K7 `fused_mix_mh_round`) against the JAX
package's Pallas kernels run with interpret=True, float64 on the CPU, as
tests/test_pallas_chol.py runs them; and the routes that reach them.

Tolerance 1e-10 relative to max(1, |value|): both sides run a
right-looking Cholesky with the [y, 1] solve fused in; the Pallas core
and the twin round the same sums in a different order (masked lane
reductions against elementwise updates).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccgp_tpu.models import MixtureSpec as JSpec
from ccgp_tpu.models.combination import (
    _effective_rates as j_rates, mix_weights as jmixw, unpack as junpack)
from ccgp_tpu.ops import kernels as jkern
from ccgp_tpu.ops.pallas_chol_smallk import (
    chol_quadratics_smallk as j_k5, fused_mix_mh_round as j_k7,
    fused_mix_quadratics_smallk as j_k6)
from ccgp_tpu_torch.models import likelihood as tlik
from ccgp_tpu_torch.models.combination import MixtureSpec as TSpec
from ccgp_tpu_torch.models.priors import InverseGamma, LogNormal
from ccgp_tpu_torch.ops import chol, chol_smallk
from ccgp_tpu_torch.ops import kernels as tkern

TOL = 1e-10


def t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def close(got, ref, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    assert np.array_equal(np.isfinite(got), np.isfinite(ref))
    m = np.isfinite(ref)
    err = np.abs(got[m] - ref[m]) / np.maximum(1.0, np.abs(ref[m]))
    assert float(err.max(initial=0.0)) <= tol, float(err.max())


def se_grams(kk, n, seed):
    r = np.random.default_rng(seed)
    x = r.uniform(size=(n, 2))
    d2 = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    # rough enough that the quadratics' conditioning (kappa eps) stays
    # well inside the tolerance
    theta = np.exp(np.linspace(2.5, 4.0, kk))
    return np.exp(-theta[:, None, None] * d2[None]), r.normal(size=n)


@pytest.mark.parametrize("kk,n,jitter", [(4, 8, 0.0), (4, 33, 1e-6),
                                         (1, 5, 1e-6), (16, 12, 1e-8)])
def test_k5_twin_matches_pallas(kk, n, jitter):
    g, y = se_grams(kk, n, seed=kk * n)
    ref = j_k5(jnp.asarray(g), jnp.asarray(y), jitter=jitter, interpret=True)
    got = chol_smallk.chol_quadratics_smallk(t(g), t(y), jitter=jitter)
    assert set(got) == set(ref)
    for k in ref:
        close(got[k], ref[k])


def _oracle_quads(g, y, jitter):
    """logdet and the quadratics of each Gram's lower triangle (+ jitter
    I) by a right-looking Cholesky with the [y, 1] solve fused in, in
    np.longdouble (x87 extended, 64-bit mantissa on x86-64)."""
    kk, n, _ = g.shape
    out = {k: np.zeros(kk, np.longdouble)
           for k in ("logdet", "qyy", "qoy", "qoo")}
    for k in range(kk):
        m = np.tril(g[k]).astype(np.longdouble)
        m = m + np.tril(m, -1).T + jitter * np.eye(n, dtype=np.longdouble)
        r = np.stack([y, np.ones(n)], 1).astype(np.longdouble)
        w = np.zeros((n, 2), np.longdouble)
        for j in range(n):
            s = np.sqrt(m[j, j])
            out["logdet"][k] += np.log(m[j, j])
            lo = m[j + 1:, j] / s
            w[j] = r[j] / s
            m[j + 1:, j + 1:] -= np.outer(lo, lo)
            r[j + 1:] -= np.outer(lo, w[j])
        out["qyy"][k] = (w[:, 0] * w[:, 0]).sum()
        out["qoy"][k] = (w[:, 0] * w[:, 1]).sum()
        out["qoo"][k] = (w[:, 1] * w[:, 1]).sum()
    return out


def _rel_to(a, ref) -> float:
    a, ref = np.asarray(a, np.longdouble), np.asarray(ref, np.longdouble)
    return float((np.abs(a - ref) / np.maximum(1, np.abs(ref))).max())


@pytest.mark.parametrize("n", [129, 200])
def test_k5_twin_above_one_tile(n):
    """Above one 128-wide tile JAX runs its blocked-Schur core
    (`_chol_quad_core_multitile`) and the twin its right-looking loop.
    At n = 129 the two agree within the file's 1e-10 (interpret mode,
    ~16 s). At n = 200 they do not: on these Grams (theta e^2.5..e^4,
    jitter 1e-6) kappa eps is above 1e-10, for JAX as for the twin, and
    qoy reads ~2.4e-9 apart. There each quantity of the twin is held no
    farther from a long-double oracle than JAX's is (~29 s): a port fault
    would show as the twin drifting past JAX, conditioning as both
    drifting alike."""
    g, y = se_grams(2, n, seed=2 * n)
    ref = j_k5(jnp.asarray(g), jnp.asarray(y), jitter=1e-6, interpret=True)
    got = chol_smallk.chol_quadratics_smallk(t(g), t(y), jitter=1e-6)
    if n <= 129:
        for k in ref:
            close(got[k], ref[k])
        return
    oracle = _oracle_quads(g, y, 1e-6)
    for k in oracle:
        assert (_rel_to(got[k].numpy(), oracle[k])
                <= _rel_to(np.asarray(ref[k]), oracle[k])), k


def _mix_above_one_tile(kk, n, seed, rates=(3.5, 5.0)):
    """K6's inputs beyond one tile: x (n, 2) uniform, smooth rates
    e^3.5..e^5 per axis, rough rates twice them, p in (0.2, 0.8). Rougher
    than se_grams: with its e^2.5..e^4 JAX's own K6 lies past the 1e-10
    tier from the long-double oracle at n = 129, so kappa eps is past the
    tier (`python tests/test_torch_chol_smallk.py` prints the distances)."""
    r = np.random.default_rng(seed)
    x = r.uniform(size=(n, 2))
    r1 = np.repeat(np.exp(np.linspace(*rates, kk))[:, None], 2, axis=1)
    return x, r.normal(size=n), r1, 2.0 * r1, np.linspace(0.2, 0.8, kk)


def _mix_gram_longdouble(x, r1, r2, p):
    """The SE-mixture Grams (K, n, n) in np.longdouble."""
    x, r1, r2, p = (np.asarray(a, np.longdouble) for a in (x, r1, r2, p))
    d2 = (x[:, None, :] - x[None, :, :]) ** 2
    w1, w2 = p * p, (1 - p) * (1 - p)
    e1 = np.exp(-np.einsum("ija,ka->kij", d2, r1))
    e2 = np.exp(-np.einsum("ija,ka->kij", d2, r2))
    return ((w1[:, None, None] * e1 + w2[:, None, None] * e2)
            / (w1 + w2)[:, None, None])


@pytest.mark.parametrize("n", [129, 200])
def test_k6_twin_above_one_tile(n):
    """Above one tile JAX's K6 runs its blocked-Schur core and the twin
    its right-looking loop (the order of K6's panel core on the card). On
    inputs whose conditioning keeps kappa eps inside the tier, the twin
    agrees with JAX's K6 in interpret mode within 1e-10 at n = 129 and 200
    (~14 s and ~23 s), and at n = 200 each quantity lies within 1e-10 of a
    long-double oracle (the Grams built in long double too). Which of the
    two lies nearer the oracle is rounding noise here (both 1e-11 to
    1e-14 from it), so the oracle holds each to the tier, not to the
    other."""
    x, y, r1, r2, p = _mix_above_one_tile(2, n, seed=3 * n)
    ref = j_k6(jnp.asarray(x), jnp.asarray(y), jnp.asarray(r1),
               jnp.asarray(r2), jnp.asarray(p), jitter=1e-6, interpret=True)
    got = chol_smallk.fused_mix_quadratics_smallk(t(x), t(y), t(r1), t(r2),
                                                  t(p), jitter=1e-6)
    for k in ref:
        close(got[k], ref[k])
    if n > 129:
        oracle = _oracle_quads(_mix_gram_longdouble(x, r1, r2, p), y, 1e-6)
        for k in oracle:
            assert _rel_to(got[k].numpy(), oracle[k]) <= TOL, k


def test_k5_twin_nan_and_lower_triangle():
    """An indefinite member gives NaN quadratics on that member only; NaN
    above the diagonal changes nothing."""
    g, y = se_grams(4, 10, seed=1)
    g = g + 1e-6 * np.eye(10)
    g[2] -= 2.0 * np.eye(10)
    got = chol_smallk.chol_quadratics_smallk(t(g), t(y))
    assert np.array_equal(~np.isfinite(got["logdet"].numpy()),
                          [False, False, True, False])
    junk = g.copy()
    junk[:, np.triu_indices(10, 1)[0], np.triu_indices(10, 1)[1]] = np.nan
    again = chol_smallk.chol_quadratics_smallk(t(junk), t(y))
    for k in got:
        assert torch.equal(torch.isnan(again[k]), torch.isnan(got[k]))
        assert torch.equal(torch.nan_to_num(again[k]),
                           torch.nan_to_num(got[k]))


SPECS = [
    (lambda k: JSpec(k.sqexp_family(), k.sqexp_family(), dim=2), 3),
    (lambda k: JSpec(k.sqexp_family(), k.sqexp_family(), dim=2,
                     rough="tied", anisotropic=True), 4),
]


def _rates(jspec, zs, kk):
    params, log_jac = jax.vmap(lambda z: junpack(jspec, z))(jnp.asarray(zs))
    th1, th2 = j_rates(jspec, params, predict=False)
    r1 = jnp.broadcast_to(jnp.reshape(th1, (kk, -1)), (kk, 2))
    r2 = jnp.broadcast_to(jnp.reshape(th2, (kk, -1)), (kk, 2))
    return params, log_jac, r1, r2


@pytest.mark.parametrize("which", [0, 1], ids=["iso_free", "aniso_tied"])
@pytest.mark.parametrize("kk,n", [(4, 23), (16, 9)])
def test_k6_twin_matches_pallas(which, kk, n):
    mk, dimz = SPECS[which]
    js = mk(jkern)
    r = np.random.default_rng(n + kk)
    x = r.uniform(size=(n, 2))
    y = np.sin(5 * x[:, 0])
    zs = r.normal(size=(kk, dimz)) + 1.0     # rates around e (see se_grams)
    params, _, r1, r2 = _rates(js, zs, kk)
    ref = j_k6(jnp.asarray(x), jnp.asarray(y), r1, r2, params.p,
               jitter=1e-6, interpret=True)
    got = chol_smallk.fused_mix_quadratics_smallk(
        t(x), t(y), t(r1), t(r2), t(params.p), jitter=1e-6)
    for k in ref:
        close(got[k], ref[k])


@pytest.mark.parametrize("scale", [0.4, 2.0, 6.0])
def test_k7_twin_matches_pallas(scale):
    """The whole round, including the no-acceptance outputs."""
    js = SPECS[1][0](jkern)
    kk, n = 4, 17
    r = np.random.default_rng(int(scale * 10))
    x = r.uniform(size=(n, 2))
    y = np.sin(5 * x[:, 0]) + np.cos(3 * x[:, 1])
    cands = r.normal(size=(kk, 4)) * scale
    params, log_jac, r1, r2 = _rates(js, cands, kk)
    _, _, s = jmixw(params.p)
    extra = log_jac + 0.1 * jnp.arange(kk)
    log_scale = jnp.log(s * 0.9)
    log_u = np.log(r.uniform(size=kk))
    for lp_val in (-40.0, 0.0, 40.0):
        ref = j_k7(jnp.asarray(x), jnp.asarray(y), r1, r2, params.p, extra,
                   log_scale, jnp.asarray(cands), lp_val, 0.25,
                   jnp.asarray(log_u), jitter=1e-6, interpret=True)
        got = chol_smallk.fused_mix_mh_round(
            t(x), t(y), t(r1), t(r2), t(params.p), t(extra), t(log_scale),
            t(cands), t(lp_val), t(0.25), t(log_u), jitter=1e-6)
        assert bool(got[3]) == bool(ref[3])
        assert int(got[4]) == int(ref[4])
        for a, b in zip(got[:3], ref[:3]):
            close(a, b)


def test_dispatcher_sends_small_batches_to_k5(monkeypatch):
    """chol_quadratics, in JAX's order: B >= 64 (n <= 128) to the lanes
    kernel, B <= 16 inside the envelope to K5, the rest to the bordered
    path."""
    calls = []
    real = chol_smallk.chol_quadratics_smallk

    def spy(grams, y, jitter=0.0):
        calls.append(grams.shape[0])
        return real(grams, y, jitter=jitter)

    monkeypatch.setattr(chol_smallk, "chol_quadratics_smallk", spy)
    for kk in (1, 4, 16, 17, 32):
        g, y = se_grams(kk, 10, seed=kk)
        q = chol.chol_quadratics(t(g), t(y), jitter=1e-8)
        assert q["logdet"].shape == (kk,)
    assert calls == [1, 4, 16]


def test_logpost_batch_routes():
    """make_logpost_batch: SE/SE takes K6 (its twin here), a Matern
    mixture K5 through the dispatcher; both equal make_logpost per
    candidate."""
    r = np.random.default_rng(2)
    for spec, x, dimz in (
            (TSpec(tkern.sqexp_family(), tkern.sqexp_family(), dim=2,
                   rough="tied", anisotropic=True), r.uniform(size=(15, 2)),
             4),
            (TSpec(tkern.matern_family(5.0), tkern.spline_family(), dim=1),
             r.uniform(size=(8, 1)), 3)):
        y = np.sin(5 * x[:, 0])
        pri = dict(theta1_prior=LogNormal(-1.0, 1.0),
                   theta2_prior=InverseGamma(3, 4))
        lb = tlik.make_logpost_batch(spec, t(x), t(y), t(0.3), jitter=1e-8,
                                     **pri)
        lp = tlik.make_logpost(spec, t(x), t(y), t(0.3), jitter=1e-8, **pri)
        zs = r.normal(size=(4, dimz)) * 0.5
        vals, betas = lb(t(zs))
        for i in range(4):
            one = lp(t(zs[i]))
            close(vals[i], one.val.numpy(), 1e-9)
            close(betas[i], one.beta.numpy(), 1e-9)


if __name__ == "__main__":
    # the distances behind _mix_above_one_tile's rates: each quantity of
    # the twin and of JAX's K6 from the long-double oracle, and from each
    # other, at K = 2 on se_grams' rates and on the test's
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    for rates in ((2.5, 4.0), (3.5, 5.0)):
        for n in (129, 200):
            x, y, r1, r2, p = _mix_above_one_tile(2, n, 3 * n, rates)
            ref = j_k6(*(jnp.asarray(a) for a in (x, y, r1, r2, p)),
                       jitter=1e-6, interpret=True)
            got = chol_smallk.fused_mix_quadratics_smallk(
                t(x), t(y), t(r1), t(r2), t(p), jitter=1e-6)
            oracle = _oracle_quads(_mix_gram_longdouble(x, r1, r2, p), y,
                                   1e-6)
            for k in oracle:
                tw, jx = got[k].numpy(), np.asarray(ref[k])
                print(f"rates e^{rates[0]}..e^{rates[1]} n={n} {k}: twin "
                      f"{_rel_to(tw, oracle[k]):.3g}, JAX "
                      f"{_rel_to(jx, oracle[k]):.3g} from the oracle; "
                      f"{_rel_to(tw, jx):.3g} apart")

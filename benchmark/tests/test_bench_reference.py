"""The plain reference against `ccgp_tpu_torch`'s CPU path (its plain
twins) at a tiny size, in float64. The test may import the port; the
reference may not."""
import numpy as np
import pytest
import torch

from harness import spec
from harness.spec import load_module
from reference import combined_gp as ref
from reference import threefry

from ccgp_tpu_torch.models.combination import MixtureSpec
from ccgp_tpu_torch.models.likelihood import make_logpost
from ccgp_tpu_torch.ops import gp, kernels, linalg, rng
from ccgp_tpu_torch.predict.factors import build_factors
from ccgp_tpu_torch.predict.posterior import (
    posterior_predict, predictive_moments)

F64 = torch.float64
f2 = load_module("functions", "f2").f
System = load_module("systems", "combined_gp").System


def _cfg(name):
    return spec.load_cell(name).config


def _problem(cfg, n=9, t=7, seed=0):
    r = np.random.default_rng(seed)
    d = cfg["dim"]
    x = torch.tensor(r.uniform(size=(n, d)), dtype=F64)
    y = torch.tensor(f2(r.uniform(size=(n, 2))) + x[:, 0].numpy(), dtype=F64)
    x_new = torch.tensor(r.uniform(size=(t, d)), dtype=F64)
    k = (d + 2) if cfg["anisotropic"] else 3
    zs = torch.tensor(r.normal(scale=0.5, size=(6, k)), dtype=F64)
    return x, y, x_new, zs


def _spec(cfg):
    return MixtureSpec(kernels.sqexp_family(), kernels.sqexp_family(),
                       dim=cfg["dim"], rough=cfg["rough"],
                       anisotropic=cfg["anisotropic"])


def test_threefry_copy_bit_equal():
    key = rng.PRNGKey(2**31 + 77, device="cpu")
    mine = threefry.prng_key(2**31 + 77)
    assert torch.equal(key, mine)
    assert torch.equal(rng.fold_in(key, 5), threefry.fold_in(mine, 5))
    assert torch.equal(rng.split(key, 3), threefry.split(mine, 3))
    for dt in (torch.float32, F64):
        a = rng.normal(key, (40, 30), dt)
        b = threefry.normal(mine, (40, 30), dt)
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["bench2d.n100", "gv9d.splits"])
def test_logpost_and_plugin(name):
    cfg = _cfg(name)
    x, y, _, zs = _problem(cfg)
    sp = _spec(cfg)
    s2 = torch.tensor(0.7, dtype=F64)
    lp = make_logpost(sp, x, y, s2, jitter=1e-6,
                      **System(dict(cfg, dtype="float64"),
                                      "cpu").priors)
    want = torch.stack([lp(z).val for z in zs])
    want_beta = torch.stack([lp(z).beta for z in zs])
    got = ref.logpost(ref.Model.from_config(cfg), x, y, s2, zs, 1e-6)
    assert torch.allclose(got["val"], want, rtol=1e-9, atol=1e-8)
    assert torch.allclose(got["beta"], want_beta, rtol=1e-9, atol=1e-9)

    theta = torch.tensor(3.0, dtype=F64)
    chol = linalg.jitter_cholesky(kernels.sqexp_family().gram(x, theta),
                                  1e-6)
    beta = gp.gls_beta(chol, y)
    p = ref.plugin(x, y, theta, 1e-6)
    assert float(p["beta"]) == pytest.approx(float(beta), rel=1e-9)
    assert float(p["sigma2"]) == pytest.approx(
        float(gp.sigma2_mle(chol, y, beta)), rel=1e-9)


@pytest.mark.parametrize("name", ["bench2d.n100", "gv9d.splits"])
def test_moments_and_intervals(name):
    cfg = _cfg(name)
    x, y, x_new, zs = _problem(cfg)
    sp = _spec(cfg)
    model = ref.Model.from_config(cfg)
    s2 = torch.tensor(0.7, dtype=F64)
    betas = ref.logpost(model, x, y, s2, zs, 1e-6)["beta"]
    cache = build_factors(sp, x, y, zs, betas, jitter=1e-6)
    dm, dv = predictive_moments(sp, cache, x, x_new, s2)
    got = ref.moments(model, x, y, x_new, s2, zs, 1e-6)
    assert torch.allclose(got["mean"], dm, rtol=1e-8, atol=1e-9)
    assert torch.allclose(got["var"], dv, rtol=1e-7, atol=1e-9)

    key = rng.PRNGKey(9, device="cpu")
    pred = posterior_predict(key, dm, dv, alpha=0.05)
    iv = ref.intervals(key, dm, dv, 0.05, F64)
    for k in ("mean", "lower", "upper"):
        assert torch.allclose(iv[k], getattr(pred, k), rtol=1e-12,
                              atol=1e-12), k


def test_control_precision_is_the_step_below():
    from harness.check import control_precision

    assert control_precision({"dtype": "float64"}) == ref.Precision(
        torch.float32)
    assert control_precision({"dtype": "float32"}) == (
        ref.Precision(torch.float32, tf32=True))
    a = torch.tensor([1.0 + 2.0 ** -12, 1.0 + 2.0 ** -9])
    assert torch.equal(ref._round_tf32(a), torch.tensor([1.0, 1.0 + 2.0 ** -9]))


def test_stream_bit_equal():
    key = rng.PRNGKey(2**31 + 99, device="cpu")
    for dt in (torch.float32, F64):
        _, eps, log_u = rng.chunk_draws_plain(key, 9, 4, 3, dt)
        e2, l2 = threefry.round_draws(threefry.prng_key(2**31 + 99), 9, 4,
                                      3, dt)
        assert torch.equal(eps, e2) and torch.equal(log_u, l2)


def test_plugin_search_and_objective():
    from ccgp_tpu_torch.infer.mle import kriging_mle_grid

    x = torch.tensor(np.random.default_rng(1).uniform(size=(20, 2)),
                     dtype=F64)
    y = torch.tensor(f2(x.numpy()), dtype=F64)
    fam = kernels.sqexp_family()
    lts = torch.tensor([-2.0, 0.5, 3.0], dtype=F64)
    want = torch.stack([gp.profile_nll(linalg.jitter_cholesky(
        fam.gram(x, torch.exp(lt)), 1e-6), y) for lt in lts])
    got = ref.profile_objective(x, y, lts, 1e-6)
    assert torch.allclose(got, want, rtol=1e-10)
    m = kriging_mle_grid(fam, x, y, jitter=1e-6)
    lt = ref.grid_search(x, y, 1e-6, (-5.0, 6.0), 32, 17)
    assert float(lt) == pytest.approx(float(torch.log(m.theta)), abs=1e-9)
    best = ref.scan_search(x, y, 1e-6, (-5.0, 6.0))
    f = ref.profile_objective(x, y, torch.stack([lt, best]), 1e-6)
    assert -5.0 < float(lt) < 6.0
    assert float(f[0]) - 1e-4 < float(f[1]) <= float(f[0]) + 1e-9


@pytest.mark.parametrize("name", ["bench2d.n100", "gv9d.splits"])
def test_laplace(name):
    from ccgp_tpu_torch.infer.laplace import laplace

    cfg = _cfg(name)
    x, y, _, _ = _problem(cfg)
    s2 = torch.tensor(0.7, dtype=F64)
    lp = make_logpost(_spec(cfg), x, y, s2, jitter=1e-6,
                      **System(dict(cfg, dtype="float64"), "cpu").priors)
    start = torch.tensor(cfg["start"], dtype=F64)
    fit = laplace(lambda z: lp(z).val, start)
    model = ref.Model.from_config(cfg)
    cov = ref.laplace_at(model, x, y, s2, fit.mode, 1e-6)
    assert torch.allclose(cov, fit.cov, rtol=1e-7, atol=1e-10)
    assert ref.mode_gain(model, x, y, s2, fit.mode, 1e-6) < 1e-6
    assert ref.mode_gain(model, x, y, s2, start, 1e-6) > 1e-2


def test_geweke():
    from ccgp_tpu_torch.infer.geweke import geweke_pvalue
    from reference import geweke

    g = torch.Generator().manual_seed(3)
    noise = torch.randn(3, 1000, 4, generator=g, dtype=F64)
    walk = torch.cumsum(noise, 1) * 0.02 + noise
    for w in torch.cat([noise, walk]):
        assert float(geweke.pvalue(w)) == pytest.approx(
            float(geweke_pvalue(w)), rel=1e-9, abs=1e-12)
    assert torch.allclose(geweke.pvalue(walk), torch.stack(
        [geweke_pvalue(w) for w in walk]), rtol=1e-9, atol=1e-12)

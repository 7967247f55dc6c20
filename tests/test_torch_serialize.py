"""Fit checkpoints (`models/serialize.py`) on the CPU, float64, against the
JAX package: a fit saved by either package loads in the other and
predicts what the saving package predicts with the same key (1e-10
relative to max(1, |value|): the same factors and draws, the normals
within ulps of XLA's); every saved field survives a round trip; a file
without the optional keys loads; the port's own key (`mcmc_n_rounds`)
is ignored by JAX's loader."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccgp_tpu.models import InverseGamma as JIG
from ccgp_tpu.models import MCMCConfig as JCfg, MixtureSpec as JSpec
from ccgp_tpu.models import fit_combined_gp as jfit
from ccgp_tpu.models import predict_combined_gp as jpredict
from ccgp_tpu.models.serialize import load_fit as jload, save_fit as jsave
from ccgp_tpu.ops import kernels as jkern
from ccgp_tpu_torch.models.combination import MixtureSpec as TSpec
from ccgp_tpu_torch.models.combined_gp import (
    MCMCConfig, fit_combined_gp, predict_combined_gp)
from ccgp_tpu_torch.models.priors import InverseGamma
from ccgp_tpu_torch.models.serialize import load_fit, save_fit
from ccgp_tpu_torch.ops import kernels as tkern, rng

CFG = dict(start=(1.0, 1.0, 0.0), n_max=500, samp_size=150,
           net_samp_size=100)
TOL = 1e-10
OPTIONAL = ("chain_ok", "y", "jitter", "mcmc_n_rounds")


def close(got, ref, tol=TOL):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref) / np.maximum(1.0, np.abs(ref))
    assert float(err.max(initial=0.0)) <= tol, float(err.max())


@pytest.fixture(scope="module")
def data():
    r = np.random.default_rng(3)
    x = r.uniform(size=(8, 2))
    return x, np.sin(6 * x[:, 0]) + x[:, 1], r.uniform(size=(5, 2))


@pytest.fixture(scope="module")
def jax_fit(data):
    x, y, _ = data
    spec = JSpec(jkern.sqexp_family(), jkern.sqexp_family(), dim=2)
    return jfit(spec, jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(0),
                mcmc=JCfg(**CFG), theta1_prior=JIG(3, 2),
                theta2_prior=JIG(5, 16))


@pytest.fixture(scope="module")
def port_fit(data):
    x, y, _ = data
    spec = TSpec(tkern.sqexp_family(), tkern.sqexp_family(), dim=2)
    return fit_combined_gp(spec, x, y, rng.PRNGKey(0, device="cpu"),
                           mcmc=MCMCConfig(**CFG, speculative=4),
                           theta1_prior=InverseGamma(3, 2),
                           theta2_prior=InverseGamma(5, 16), device="cpu")


def port_predict(fit, data):
    x, _, xn = data
    spec = TSpec(tkern.sqexp_family(), tkern.sqexp_family(), dim=2)
    return predict_combined_gp(spec, fit, x, xn, rng.PRNGKey(1, device="cpu"),
                               device="cpu")


def jax_predict(fit, data):
    x, _, xn = data
    spec = JSpec(jkern.sqexp_family(), jkern.sqexp_family(), dim=2)
    return jpredict(spec, fit, jnp.asarray(x), jnp.asarray(xn),
                    jax.random.PRNGKey(1))


def same_predictions(got, ref):
    for f in ("mean", "lower", "upper", "draw_mean", "draw_var"):
        close(getattr(got, f), getattr(ref, f))


def test_jax_file_loads_in_the_port(tmp_path, data, jax_fit):
    path = tmp_path / "jax.npz"
    jsave(path, jax_fit)
    fit = load_fit(path, device="cpu")
    assert fit.zs.device.type == "cpu" and fit.zs.dtype == torch.float64
    assert fit.mcmc.n_recorded == int(jax_fit.mcmc.n_recorded)
    assert fit.mcmc.n_proposals == int(jax_fit.mcmc.n_proposals)
    assert fit.mcmc.converged == bool(jax_fit.mcmc.converged)
    assert fit.chain_ok == bool(jax_fit.chain_ok)
    assert fit.mcmc.n_rounds is None     # JAX's save_fit keeps no round count
    for got, ref in ((fit.zs, jax_fit.zs), (fit.cache.chol, jax_fit.cache.chol),
                     (fit.mcmc.laplace.cov, jax_fit.mcmc.laplace.cov),
                     (fit.mle.theta, jax_fit.mle.theta), (fit.y, jax_fit.y)):
        assert np.array_equal(got.numpy(), np.asarray(ref))
    same_predictions(port_predict(fit, data), jax_predict(jax_fit, data))


def test_port_file_loads_in_jax(tmp_path, data, port_fit):
    path = tmp_path / "port.npz"
    save_fit(path, port_fit)
    assert set(OPTIONAL) <= set(np.load(path).files)
    fit = jload(path)
    assert int(fit.mcmc.n_recorded) == port_fit.mcmc.n_recorded
    assert int(fit.mcmc.n_accepted) == port_fit.mcmc.n_accepted
    assert bool(fit.chain_ok) == port_fit.chain_ok
    assert np.array_equal(np.asarray(fit.cache.a), port_fit.cache.a.numpy())
    same_predictions(port_predict(port_fit, data), jax_predict(fit, data))


def test_port_round_trip_keeps_every_field(tmp_path, data, port_fit):
    path = tmp_path / "port.npz"
    save_fit(path, port_fit)
    fit = load_fit(path, device="cpu")
    for name in ("n_recorded", "n_proposals", "n_accepted", "pvalue",
                 "converged", "n_rounds"):
        got, ref = getattr(fit.mcmc, name), getattr(port_fit.mcmc, name)
        assert type(got) is type(ref) and got == ref, name
    assert fit.chain_ok is port_fit.chain_ok
    pairs = [(fit.sigma2, port_fit.sigma2), (fit.zs, port_fit.zs),
             (fit.y, port_fit.y), (fit.jitter, port_fit.jitter),
             (fit.mcmc.samples, port_fit.mcmc.samples),
             (fit.mcmc.logposts, port_fit.mcmc.logposts)]
    pairs += list(zip(fit.mle, port_fit.mle))
    pairs += list(zip(fit.mcmc.laplace, port_fit.mcmc.laplace))
    pairs += list(zip(fit.cache[:4], port_fit.cache[:4]))
    pairs += list(zip(fit.params, port_fit.params))
    for got, ref in pairs:
        assert got.dtype == ref.dtype and torch.equal(got, ref)
    a, b = port_predict(fit, data), port_predict(port_fit, data)
    for f in ("mean", "lower", "upper"):
        assert torch.equal(getattr(a, f), getattr(b, f))


def test_file_without_optional_keys_loads(tmp_path, data, jax_fit):
    path = tmp_path / "jax.npz"
    jsave(path, jax_fit)
    z = dict(np.load(path))
    bare = tmp_path / "bare.npz"
    np.savez(bare, **{k: v for k, v in z.items() if k not in OPTIONAL})
    fit = load_fit(bare, device="cpu")
    assert fit.chain_ok is None and fit.y is None and fit.jitter is None
    assert fit.mcmc.n_rounds is None and fit.mcmc.factors is None
    same_predictions(port_predict(fit, data), jax_predict(jax_fit, data))


def test_load_fit_needs_cuda_unless_cpu_is_asked_for(tmp_path, port_fit,
                                                     monkeypatch):
    path = tmp_path / "port.npz"
    save_fit(path, port_fit)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_fit(path)
    assert load_fit(path, device="cpu").zs.device.type == "cpu"

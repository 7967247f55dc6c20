"""The whole ported slice — grid kriging MLE -> Laplace -> chunked
speculative Metropolis with the stash -> factor cache -> posterior
predict — against the JAX package at a small size, float64 on the CPU.

JAX on the CPU takes its one-round sampler plus `build_factors`; the port
takes the chunked driver with the fused rounds' plain twin and decodes the
stash. The two are law-equal (tests/test_mh_rounds.py), so with the same
key they run the same chain.

Tolerances: chain counters equal; sigma2 1e-8 relative (JAX fuses the
jitted program's reductions in another order, and the jitter-1e-6 Grams
amplify that roundoff; the eager MLE agrees to 1e-10 in
test_torch_infer.py); mean, lower and
upper 1e-6 relative to max(1, |value|) — the Laplace mode and covariance
agree to ~1e-7 (BFGS stopping tolerance, see test_torch_infer.py) and the
proposals inherit that. A JAX fit converted to the port predicts to 1e-10.
"""
import pathlib
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccgp_tpu.models import InverseGamma as JIG, LogNormal as JLN
from ccgp_tpu.models import MCMCConfig as JCfg, MixtureSpec as JSpec
from ccgp_tpu.models import fit_combined_gp as jfit
from ccgp_tpu.models import predict_combined_gp as jpredict
from ccgp_tpu.ops import kernels as jkern
from ccgp_tpu_torch.models.combination import MixtureSpec as TSpec
from ccgp_tpu_torch.models.combined_gp import (
    MCMCConfig, fit_combined_gp, predict_combined_gp)
from ccgp_tpu_torch.models.convert import fit_from_numpy, key_from_numpy
from ccgp_tpu_torch.models.priors import InverseGamma, LogNormal
from ccgp_tpu_torch.ops import chol_smallk, kernels as tkern, rng
from ccgp_tpu_torch.predict.factors import build_factors

ROOT = pathlib.Path(__file__).resolve().parent.parent
CFG = dict(start=(1.0, 1.0, 0.0, 0.0), n_max=400, samp_size=120,
           net_samp_size=120, speculative=4)


def t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def assert_close(got, ref, tol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref) / np.maximum(1.0, np.abs(ref))
    assert float(err.max(initial=0.0)) <= tol, float(err.max())


@pytest.fixture(scope="module")
def data():
    r = np.random.default_rng(0)
    x = r.uniform(size=(20, 2))
    y = np.sin(5 * x[:, 0]) + np.cos(3 * x[:, 1])
    u = np.linspace(0, 1, 6)
    grid = np.stack(np.meshgrid(u, u), -1).reshape(-1, 2)
    return x, y, grid


@pytest.fixture(scope="module")
def jax_run(data):
    x, y, grid = data
    spec = JSpec(jkern.sqexp_family(), jkern.sqexp_family(), dim=2,
                 rough="tied", anisotropic=True)

    def run(x, y, grid, key):
        kf, kp = jax.random.split(key)
        fit = jfit(spec, x, y, kf, mcmc=JCfg(**CFG),
                   theta1_prior=JLN(-1.0, 1.0), theta2_prior=JIG(3, 4),
                   jitter=1e-6, mle_method="grid")
        return fit, jpredict(spec, fit, x, grid, kp), kp

    return jax.jit(run)(jnp.asarray(x), jnp.asarray(y), jnp.asarray(grid),
                        jax.random.PRNGKey(1))


@pytest.fixture(scope="module")
def torch_run(data):
    x, y, grid = data
    spec = TSpec(tkern.sqexp_family(), tkern.sqexp_family(), dim=2,
                 rough="tied", anisotropic=True)
    counts = (rng.threefry_split_chain.launches,
              chol_smallk.fused_mix_mh_rounds.launches)
    kf, kp = rng.split(rng.PRNGKey(1, device="cpu"), 2)
    fit = fit_combined_gp(spec, t(x), t(y), kf, mcmc=MCMCConfig(**CFG),
                          theta1_prior=LogNormal(-1.0, 1.0),
                          theta2_prior=InverseGamma(3, 4), jitter=1e-6,
                          mle_method="grid", device="cpu")
    pred = predict_combined_gp(spec, fit, t(x), t(grid), kp, device="cpu")
    after = (rng.threefry_split_chain.launches,
             chol_smallk.fused_mix_mh_rounds.launches)
    return spec, fit, pred, counts, after


def test_slice_matches_jax(jax_run, torch_run):
    jf, jp, _ = jax_run
    _, tf, tp, _, _ = torch_run
    assert tf.mcmc.n_recorded == int(jf.mcmc.n_recorded)
    assert tf.mcmc.n_proposals == int(jf.mcmc.n_proposals)
    assert tf.mcmc.n_rounds == int(jf.mcmc.n_rounds)
    assert tf.mcmc.converged == bool(jf.mcmc.converged)
    assert tf.chain_ok == bool(jf.chain_ok)
    assert tf.chain_ok    # the chain stops by Geweke inside n_max
    assert_close(tf.sigma2, jf.sigma2, 1e-8)
    assert_close(tf.zs, jf.zs, 1e-6)
    for f in ("mean", "lower", "upper"):
        assert_close(getattr(tp, f), getattr(jp, f), 1e-6)
    assert tp.mean.shape == (36,) and bool(torch.isfinite(tp.mean).all())


def test_stash_cache_equals_rebuilt_factors(data, torch_run):
    """The factor cache decoded from the sampler's stash is the one
    `build_factors` rebuilds from the retained draws."""
    x, y, _ = data
    spec, fit, _, _, _ = torch_run
    assert fit.mcmc.factors is not None and fit.mcmc.factors_ok
    ref = build_factors(spec, t(x), t(y), fit.zs, fit.cache.beta, jitter=1e-6)
    for f in ("chol", "a", "u"):
        assert_close(getattr(fit.cache, f), getattr(ref, f), 1e-8)


def test_cpu_run_never_launches_kernels(torch_run):
    _, _, _, before, after = torch_run
    assert before == after


def test_converted_jax_fit_predicts_the_same(data, jax_run):
    x, _, grid = data
    jf, jp, kp = jax_run
    spec = TSpec(tkern.sqexp_family(), tkern.sqexp_family(), dim=2,
                 rough="tied", anisotropic=True)
    fit = fit_from_numpy(
        sigma2=np.asarray(jf.sigma2), zs=np.asarray(jf.zs),
        p=np.asarray(jf.params.p), theta1=np.asarray(jf.params.theta1),
        theta2=np.asarray(jf.params.theta2), chol=np.asarray(jf.cache.chol),
        a=np.asarray(jf.cache.a), u=np.asarray(jf.cache.u),
        beta=np.asarray(jf.cache.beta), y=np.asarray(jf.y),
        jitter=np.asarray(jf.jitter), device="cpu")
    pred = predict_combined_gp(spec, fit, t(x), t(grid),
                               key_from_numpy(np.asarray(kp), device="cpu"),
                               device="cpu")
    for f in ("mean", "lower", "upper", "quant", "draw_mean", "draw_var"):
        assert_close(getattr(pred, f), getattr(jp, f), 1e-10)


def test_unported_options_raise(data):
    x, y, _ = data
    spec = TSpec(tkern.sqexp_family(), tkern.sqexp_family(), dim=2,
                 rough="tied", anisotropic=True)
    key = rng.PRNGKey(0, device="cpu")
    with pytest.raises(NotImplementedError):
        fit_combined_gp(spec, t(x), t(y), key, mcmc=MCMCConfig(**CFG),
                        whiten=True, device="cpu")


_IMPORT = re.compile(r"^\s*(?:import|from)\s+(jax|ccgp_tpu)(?:\.|\s|$)",
                     re.MULTILINE)


def test_port_never_imports_jax():
    files = sorted((ROOT / "ccgp_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]
    assert len(files) > 20
    for f in files:
        assert not _IMPORT.search(f.read_text()), f
    code = (
        "import sys, importlib, pkgutil\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['ccgp_tpu'] = None\n"
        "import ccgp_tpu_torch\n"
        "for m in pkgutil.walk_packages(ccgp_tpu_torch.__path__, "
        "'ccgp_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "assert 'jax' not in [k for k, v in sys.modules.items() if v]\n"
        "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


def test_entry_points_need_cuda_unless_cpu_is_asked_for(monkeypatch, data):
    """The entry points run on the GPU by default: without one they raise
    rather than run on the CPU; device="cpu" runs there."""
    from ccgp_tpu_torch.eb import choose_hyperpars
    from ccgp_tpu_torch.models.convert import laplace_from_numpy

    x, y, grid = data
    spec = TSpec(tkern.sqexp_family(), tkern.sqexp_family(), dim=2,
                 rough="tied", anisotropic=True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    key = rng.PRNGKey(0, device="cpu")
    fit_kw = dict(mcmc=MCMCConfig(**CFG), mle_method="grid")
    for call in (
            lambda: rng.PRNGKey(0),
            lambda: key_from_numpy(np.array([0, 7], np.uint32)),
            lambda: laplace_from_numpy(np.zeros(4), np.eye(4), 0.0),
            lambda: fit_from_numpy(sigma2=1.0, zs=np.zeros((1, 4)), p=0.5,
                                   theta1=np.ones((1, 2)), theta2=1.0,
                                   chol=np.eye(20)[None], a=np.zeros((1, 20)),
                                   u=np.zeros((1, 20)), beta=np.zeros(1)),
            lambda: fit_combined_gp(spec, x, y, key, **fit_kw),
            lambda: choose_hyperpars(spec, x, y, np.ones((1, 4)), 1.0)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    fit = fit_from_numpy(sigma2=1.0, zs=np.zeros((1, 4)), p=np.full(1, 0.5),
                         theta1=np.ones((1, 2)), theta2=np.ones(1),
                         chol=np.eye(20)[None], a=np.zeros((1, 20)),
                         u=np.zeros((1, 20)), beta=np.zeros(1), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        predict_combined_gp(spec, fit, t(x), t(grid), key)
    # device="cpu" takes numpy inputs and runs there
    pred = predict_combined_gp(spec, fit, x, grid, key, device="cpu")
    assert pred.mean.device.type == "cpu" and pred.mean.shape == (36,)
    assert rng.PRNGKey(5, device="cpu").device.type == "cpu"

"""K8, the fused mixture-Gram -> Cholesky -> quadratics kernel
(`ops/gram_chol.py`, exported as `ccgp_tpu_torch.ops.fused_mix_quadratics`),
on the CPU: its plain twin against the JAX package's Pallas kernel in
interpret mode, float64.

Tolerances: 1e-10 relative to max(1, |value|). The twin builds the same
covariance in the same order, then factors it with K6's right-looking
core (rsqrt-scaled pivots) where the Pallas kernel divides by sqrt: the
two agree to roundoff amplified by the covariances' condition number,
which these cases keep near 1e3-1e6. Against the port's own dispatcher on
materialized covariances (a batch of 6: K5's twin, the same factorization
core; the Gram summed in another order): 1e-10 as well.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccgp_tpu.ops.pallas_gram_chol import fused_mix_quadratics as jfused
from ccgp_tpu_torch import ops
from ccgp_tpu_torch.ops import gram_chol
from ccgp_tpu_torch.ops.chol import chol_quadratics

KEYS = ("logdet", "qyy", "qoy", "qoo")


def close(got, ref, tol):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    err = np.abs(got - ref) / np.maximum(1.0, np.abs(ref))
    assert float(err.max(initial=0.0)) <= tol, float(err.max())


def case(n, d, b, seed, per_lane):
    """`tests/test_pallas_chol.py:111-136`'s draws: x uniform, p in
    (0.3, 0.8), r1 in (0.5, 2), r2 in (4, 12), scale in (0.5, 2), shift in
    (0, 3); scalar scale and shift when per_lane is False."""
    r = np.random.default_rng(seed)
    c = dict(x=r.uniform(size=(n, d)), y=r.normal(size=n),
             p=r.uniform(0.3, 0.8, b), r1=r.uniform(0.5, 2.0, (b, d)),
             r2=r.uniform(4.0, 12.0, (b, d)), scale=r.uniform(0.5, 2.0, b),
             shift=r.uniform(0.0, 3.0, b))
    if not per_lane:
        c["scale"], c["shift"] = 1.7, 0.4
    return c


def run_both(c, jitter):
    j = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
         for k, v in c.items()}
    t = {k: (torch.tensor(v) if isinstance(v, np.ndarray) else v)
         for k, v in c.items()}
    ref = jfused(j["x"], j["y"], j["r1"], j["r2"], j["p"], scale=j["scale"],
                 shift=j["shift"], jitter=jitter, interpret=True)
    got = ops.fused_mix_quadratics(t["x"], t["y"], t["r1"], t["r2"], t["p"],
                                   scale=t["scale"], shift=t["shift"],
                                   jitter=jitter)
    return got, ref, t


@pytest.mark.parametrize("n,d,b", [(26, 3, 5), (20, 16, 3)])
@pytest.mark.parametrize("per_lane", [True, False])
def test_plain_matches_pallas_interpret(n, d, b, per_lane):
    before = gram_chol.fused_mix_quadratics.launches
    got, ref, _ = run_both(case(n, d, b, seed=n + d, per_lane=per_lane),
                           1e-8)
    assert gram_chol.fused_mix_quadratics.launches == before   # the twin
    for k in KEYS:
        close(got[k], ref[k], 1e-10)


@pytest.mark.parametrize("jitter", [0.0, 1e-8])
def test_matches_materialized_covariances(jitter):
    """scale R_mix + shift J built densely, then the port's dispatcher."""
    c = case(14, 2, 6, seed=3, per_lane=True)
    t = {k: torch.tensor(v) for k, v in c.items()}
    diff = t["x"][:, None, :] - t["x"][None, :, :]
    d1 = torch.einsum("ijk,bk->bij", diff * diff, t["r1"])
    d2 = torch.einsum("ijk,bk->bij", diff * diff, t["r2"])
    w1, w2 = t["p"] ** 2, (1.0 - t["p"]) ** 2
    rmix = ((w1[:, None, None] * torch.exp(-d1)
             + w2[:, None, None] * torch.exp(-d2))
            / (w1 + w2)[:, None, None])
    cov = t["scale"][:, None, None] * rmix + t["shift"][:, None, None]
    ref = chol_quadratics(cov, t["y"], jitter=jitter)
    got = ops.fused_mix_quadratics(t["x"], t["y"], t["r1"], t["r2"], t["p"],
                                   t["scale"], t["shift"], jitter)
    for k in KEYS:
        close(got[k], ref[k], 1e-10)


def test_nan_on_indefinite_lanes_only():
    c = case(24, 2, 6, seed=4, per_lane=True)
    c["r1"][1::2] = -5.0          # a negative rate: an indefinite Gram
    t = {k: torch.tensor(v) for k, v in c.items()}
    got = ops.fused_mix_quadratics(t["x"], t["y"], t["r1"], t["r2"], t["p"],
                                   t["scale"], 0.0, 1e-2)
    for k in KEYS:
        assert torch.equal(~torch.isfinite(got[k]),
                           torch.arange(6) % 2 == 1), k


def test_limits_raise():
    c = case(129, 2, 2, seed=5, per_lane=True)
    t = {k: torch.tensor(v) for k, v in c.items()}
    with pytest.raises(ValueError, match="n must be <= 128"):
        ops.fused_mix_quadratics(t["x"], t["y"], t["r1"], t["r2"], t["p"])
    c = case(10, 17, 2, seed=6, per_lane=True)
    t = {k: torch.tensor(v) for k, v in c.items()}
    with pytest.raises(ValueError, match="d must be <= 16"):
        ops.fused_mix_quadratics(t["x"], t["y"], t["r1"], t["r2"], t["p"])
    with pytest.raises(ValueError, match="d must be <= 16"):
        jfused(*(jnp.asarray(c[k]) for k in ("x", "y", "r1", "r2", "p")),
               interpret=True)
    c = case(10, 2, 3, seed=7, per_lane=True)
    t = {k: torch.tensor(v) for k, v in c.items()}
    with pytest.raises(ValueError, match="scale and shift"):
        ops.fused_mix_quadratics(t["x"], t["y"], t["r1"], t["r2"], t["p"],
                                 scale=torch.ones(2, dtype=torch.float64))

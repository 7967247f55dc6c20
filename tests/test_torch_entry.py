"""The port's entry points (`ccgp_tpu_torch/graft_entry.py`) against the
root `__graft_entry__.py` of the JAX package, on the CPU:

* `_flagship`'s forward (log-posterior, predictive mean and variance of
  the 2-D anisotropic tied-rough model) within 1e-10 of JAX's in float64,
  relative to max(|value|, 1) as JAX's dry run measures (a predictive
  mean near 0 parts by 1.4e-12 absolute), at the example point and at two
  others; `entry()`'s float32 forward within 5e-3 of the float64 one (the
  Gram at the example point, jitter 1e-6, is ill-conditioned for float32:
  the port's log-posterior reads 2.2e-3 and JAX's 6.0e-4 from float64);
* `entry()` runs on the GPU by default and raises without one;
* `dryrun_multichip(8, device="cpu")`: the training step and the four
  other sharded functions on an 8-device mesh equal their one-device
  runs (0 difference: the same arithmetic per shard), and the training
  step's metrics equal JAX's dry-run step within 1e-5 relative in float32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
from ccgp_tpu_torch import graft_entry as tentry


def _rel(a, b, floor=1e-300):
    a = np.asarray(a.detach().cpu().numpy() if hasattr(a, "detach") else a,
                   np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), floor)))


@pytest.mark.parametrize("z", [[0.0, 0.0, 0.0, 0.0], [0.5, -0.3, 0.2, 1.0],
                               [-1.0, 1.5, -0.7, -0.5]])
def test_flagship_forward_matches_jax_f64(z):
    jf, (jz0, jx) = jentry._flagship(jnp.float64)
    tf, (tz0, tx) = tentry._flagship(torch.float64, device="cpu")
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(tz0.numpy(), np.asarray(jz0))
    got = tf(torch.tensor(z, dtype=torch.float64), tx)
    ref = jf(jnp.asarray(z), jx)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        assert _rel(g, r, floor=1.0) < 1e-10


def test_entry_is_float32_and_near_float64():
    tf, args = tentry.entry(device="cpu")
    assert args[0].dtype == torch.float32 and args[1].shape == (32, 2)
    f64, a64 = tentry._flagship(torch.float64, device="cpu")
    for g, r in zip(tf(*args), f64(*a64)):
        assert g.dtype == torch.float32 and torch.all(torch.isfinite(g))
        assert _rel(g, r, floor=1.0) < 5e-3


def test_entry_needs_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tentry.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tentry.dryrun_multichip(2)


def test_dryrun_multichip_on_eight_cpu_devices(capsys):
    par = tentry.dryrun_multichip(8, device="cpu")
    assert set(par) == {"mean_logpost", "acc_rate", "eb_scan",
                        "design_sweep", "multi_chain", "posterior_predict"}
    assert all(v == 0.0 for v in par.values())
    out = capsys.readouterr().out
    assert "dryrun_multichip OK" in out and "'dp': 4, 'mp': 2" in out


def test_dryrun_train_step_matches_jax():
    """The dry run's training step (f32, n = 8, 16 chains on a
    one-device mesh) against JAX's: the same chains' metrics."""
    from ccgp_tpu.models import InverseGamma as JIG, MixtureSpec as JSpec
    from ccgp_tpu.ops import kernels as jk
    from ccgp_tpu.parallel import distributed_train_step as jstep_fn
    from ccgp_tpu.parallel import make_mesh as jmesh
    from ccgp_tpu_torch.models.combination import MixtureSpec
    from ccgp_tpu_torch.models.priors import InverseGamma
    from ccgp_tpu_torch.ops import kernels, rng
    from ccgp_tpu_torch.parallel import distributed_train_step, make_mesh

    r = np.random.default_rng(0)
    x = r.uniform(size=(8, 2)).astype(np.float32)
    y = np.sin(5 * x[:, 0]).astype(np.float32)
    xe = r.uniform(size=(16, 2)).astype(np.float32)
    jspec = JSpec(jk.sqexp_family(), jk.sqexp_family(), dim=2)
    step, make_state = jstep_fn(
        jspec, jnp.asarray(x), jnp.asarray(y), jnp.asarray(xe),
        jnp.asarray(0.5, jnp.float32), 0.1 * jnp.eye(3, dtype=jnp.float32),
        jmesh(1), theta1_prior=JIG(3, 2), theta2_prior=JIG(5, 16),
        jitter=1e-5)
    _, jm = step(make_state(jax.random.PRNGKey(0), 16,
                            jnp.asarray([0.0, 1.0, 0.0], jnp.float32)))
    spec = MixtureSpec(kernels.sqexp_family(), kernels.sqexp_family(), dim=2)
    t = torch.tensor
    tstep, tmake = distributed_train_step(
        spec, t(x), t(y), t(xe), t(0.5), 0.1 * torch.eye(3),
        make_mesh(devices=["cpu"]), theta1_prior=InverseGamma(3, 2),
        theta2_prior=InverseGamma(5, 16), jitter=1e-5)
    _, tm = tstep(tmake(rng.PRNGKey(0, device="cpu"), 16,
                        t([0.0, 1.0, 0.0])))
    assert float(tm["acc_rate"]) == float(jm["acc_rate"])
    assert _rel(tm["mean_logpost"], jm["mean_logpost"]) < 1e-5
    assert _rel(tm["grid_mean"], jm["grid_mean"], floor=1.0) < 1e-5

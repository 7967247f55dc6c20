"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

These tests need a CUDA device and `nvcc`; without them they skip. The
machine with the card has no JAX, and `tests/conftest.py` imports it, so
run them there without the conftest:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

Tolerances: the threefry chain is integer-exact. The rounds kernel and
the batched Cholesky kernels run their plain versions' operations in the
same order with explicitly rounded arithmetic, so acceptance flags,
consumed counts and NaN positions are equal, and records, factors and
quadratics agree to 1e-4 (float32) and 1e-10 (float64) relative to
max(1, |value|) — room for the math library's exp / log / rsqrt, which
may differ from PyTorch's in the last place.
"""
import numpy as np
import pytest
import torch

from ccgp_tpu_torch.models.combination import MixtureSpec
from ccgp_tpu_torch.models.likelihood import cand_model_for
from ccgp_tpu_torch.models.priors import InverseGamma, LogNormal
from ccgp_tpu_torch.ops import _build, chol_lanes, chol_smallk, kernels, rng
from ccgp_tpu_torch.predict.factors import decode_stash

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the GPU machine)")
    return torch.device("cuda")


def _rel(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    assert torch.equal(torch.isfinite(a), torch.isfinite(b))
    m = torch.isfinite(b)
    return float((torch.abs(a[m] - b[m]) / torch.clamp(torch.abs(b[m]),
                                                       min=1.0)).max())


@pytest.mark.parametrize("rr", [1, 20, 120])
def test_split_chain_kernel_equals_plain(cuda, rr):
    key = rng.PRNGKey(123456789, device=cuda)
    before = rng.threefry_split_chain.launches
    got = rng.threefry_split_chain(key, rr)
    assert rng.threefry_split_chain.launches == before + 1
    for g, r in zip(got, rng.threefry_split_chain_plain(key, rr)):
        assert torch.equal(g, r)


@pytest.mark.parametrize("n,rr,dtype,tol", [
    (16, 6, torch.float64, 1e-10),
    (100, 20, torch.float32, 1e-4),
    (300, 3, torch.float32, 1e-4),      # beyond one 128-wide tile
])
def test_rounds_kernel_equals_plain(cuda, n, rr, dtype, tol):
    spec = MixtureSpec(kernels.sqexp_family(), kernels.sqexp_family(),
                       dim=2, rough="tied", anisotropic=True)
    r = np.random.default_rng(n)
    x = r.uniform(size=(n, 2))
    kk, dim = 4, 4

    def t(a):
        return torch.tensor(np.asarray(a), dtype=dtype, device=cuda)

    args = dict(x=t(x), y=t(np.sin(5 * x[:, 0]) + np.cos(3 * x[:, 1])),
                z=t([0.6, 0.4, 0.1, -0.2]), lp_val=t(-1e6), lp_beta=t(0.0),
                sigma2=t(0.05), deltas=t(0.25 * r.normal(size=(rr * kk, dim))),
                log_u=t(np.log(r.uniform(size=(rr, kk)))),
                model=cand_model_for(spec, t(x), LogNormal(-1.0, 1.0),
                                     InverseGamma(3, 4)),
                jitter=1e-3 if dtype == torch.float32 else 1e-9, stash=True)
    before = chol_smallk.fused_mix_mh_rounds.launches
    got = chol_smallk.fused_mix_mh_rounds(**args)
    torch.cuda.synchronize()
    assert chol_smallk.fused_mix_mh_rounds.launches == before + 1
    ref = chol_smallk.fused_mix_mh_rounds_plain(**args)
    assert torch.equal(got["acc"], ref["acc"])
    assert torch.equal(got["consumed"], ref["consumed"])
    assert _rel(got["rec"], ref["rec"]) <= tol
    acc = ref["acc"]
    assert int(acc.sum()) >= 1
    for a, b in zip(decode_stash(got["stash"][acc], n),
                    decode_stash(ref["stash"][acc], n)):
        assert _rel(a, b) <= tol
    # a tensor left on the host is refused, not computed
    with pytest.raises(TypeError):
        chol_smallk.fused_mix_mh_rounds(**dict(args, y=args["y"].cpu()))


def _se_grams(b, n, seed):
    r = np.random.default_rng(seed)
    x = r.uniform(size=(n, 2))
    d2 = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    theta = np.exp(np.linspace(0.0, 3.0, b))
    return np.exp(-theta[:, None, None] * d2[None]), r.normal(size=n)


@pytest.mark.parametrize("b,n,dtype,jitter,tol", [
    (128, 100, torch.float32, 1e-3, 1e-4),     # the MAP cloud
    (64, 100, torch.float32, 1e-3, 1e-4),      # a lazy predict chunk
    (1728, 14, torch.float64, 1e-6, 1e-10),    # an EB row
    (130, 17, torch.float32, 1e-3, 1e-4),
    # f64 at n = 128 needs 134 KB of shared memory: launched only after the
    # opt-in above 48 KB, refused without it
    (200, 128, torch.float64, 1e-6, 1e-10),
])
def test_chol_lanes_kernels_equal_plain(cuda, b, n, dtype, jitter, tol):
    g, y = _se_grams(b, n, seed=b + n)
    g, y = (torch.tensor(a, dtype=dtype, device=cuda) for a in (g, y))
    for kern, plain in ((chol_lanes.chol_quadratics_lanes,
                         chol_lanes.chol_quadratics_lanes_plain),
                        (chol_lanes.chol_factors_lanes,
                         chol_lanes.chol_factors_lanes_plain)):
        before = kern.launches
        got = kern(g, y, jitter=jitter)
        torch.cuda.synchronize()
        assert kern.launches == before + 1
        ref = plain(g, y, jitter=jitter)
        assert set(got) == set(ref)
        for k in ref:
            assert _rel(got[k], ref[k]) <= tol, k
    # only the lower triangle is loaded: NaN above the diagonal changes
    # nothing
    iu = torch.triu_indices(n, n, 1, device=cuda)
    junk = g.clone()
    junk[:, iu[0], iu[1]] = float("nan")
    for kern in (chol_lanes.chol_quadratics_lanes,
                 chol_lanes.chol_factors_lanes):
        ref, got = kern(g, y, jitter=jitter), kern(junk, y, jitter=jitter)
        for k in ref:
            assert torch.equal(got[k], ref[k]), k
    # a tensor left on the host is refused, not computed
    with pytest.raises(TypeError):
        chol_lanes.chol_quadratics_lanes(g, y.cpu())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_chol_lanes_nan_on_the_same_matrices(cuda, dtype):
    r = np.random.default_rng(3)
    v = r.normal(size=(64, 40, 20))
    low = v @ np.swapaxes(v, 1, 2) / 40
    shift = np.where(np.arange(64) % 2 == 1, -1e-2, 1e-2)
    g = torch.tensor(low + shift[:, None, None] * np.eye(40), dtype=dtype,
                     device=cuda)
    y = torch.tensor(r.normal(size=40), dtype=dtype, device=cuda)
    got = chol_lanes.chol_factors_lanes(g, y)
    ref = chol_lanes.chol_factors_lanes_plain(g, y)
    nan = ~torch.isfinite(got["logdet"])
    assert torch.equal(nan.cpu(), torch.arange(64) % 2 == 1)
    tol = 1e-10 if dtype == torch.float64 else 1e-4
    for k in ref:
        assert _rel(got[k], ref[k]) <= tol, k


def test_refused_launch_raises_and_leaves_no_error(cuda):
    """A launch the card refuses (f64 n = 180 needs 266 KB of shared
    memory, above the 227 KB a block may have) comes back as an error
    code, and the next launch is not charged with it."""
    lib = _build.library()
    n, b = 180, 2
    g = torch.eye(n, dtype=torch.float64, device=cuda).expand(b, n, n)
    g = g.contiguous()
    y = torch.ones(n, dtype=torch.float64, device=cuda)
    q = torch.empty((b, 4), dtype=torch.float64, device=cuda)
    code = lib.ccgp_chol_lanes_f64(g.data_ptr(), y.data_ptr(), q.data_ptr(),
                                   None, None, None, b, n, 0, 0.0,
                                   _build.stream(g.device))
    assert code != 0
    with pytest.raises(RuntimeError):
        _build.check(code, "chol_lanes")
    g2, y2 = _se_grams(64, 20, seed=1)
    g2, y2 = (torch.tensor(a, device=cuda) for a in (g2, y2))
    got = chol_lanes.chol_quadratics_lanes(g2, y2, jitter=1e-6)
    ref = chol_lanes.chol_quadratics_lanes_plain(g2, y2, jitter=1e-6)
    for k in ref:
        assert _rel(got[k], ref[k]) <= 1e-10

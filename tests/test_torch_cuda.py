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


def test_rounds_kernel_widest_x(cuda):
    """K1 at d = MAX_D input axes (dim = MAX_D + 2), in f64."""
    d, n, rr, kk = chol_smallk.MAX_D, 40, 4, 4
    spec = MixtureSpec(kernels.sqexp_family(), kernels.sqexp_family(),
                       dim=d, rough="tied", anisotropic=True)
    r = np.random.default_rng(d)
    x = r.uniform(size=(n, d))

    def t(a):
        return torch.tensor(np.asarray(a), dtype=torch.float64, device=cuda)

    args = dict(x=t(x), y=t(np.sin(5 * x[:, 0])),
                z=t(np.r_[np.full(d, np.log(0.02)), 0.1, -0.2]),
                lp_val=t(-1e6), lp_beta=t(0.0), sigma2=t(0.05),
                deltas=t(0.1 * r.normal(size=(rr * kk, d + 2))),
                log_u=t(np.log(r.uniform(size=(rr, kk)))),
                model=cand_model_for(spec, t(x), LogNormal(-1.0, 1.0),
                                     InverseGamma(3, 4)),
                jitter=1e-8, stash=True)
    got = chol_smallk.fused_mix_mh_rounds(**args)
    ref = chol_smallk.fused_mix_mh_rounds_plain(**args)
    assert torch.equal(got["acc"], ref["acc"])
    assert torch.equal(got["consumed"], ref["consumed"])
    assert _rel(got["rec"], ref["rec"]) <= 1e-10


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


# ---------------------------------------------------------------------------
# the small-K kernels K5 (chol_quadratics_smallk), K6
# (fused_mix_quadratics_smallk) and K7 (fused_mix_mh_round)
# ---------------------------------------------------------------------------

def _tol(dtype):
    return 1e-10 if dtype == torch.float64 else 1e-4


def _quads_equal(got, ref, tol):
    assert set(got) == set(ref)
    for k in ref:
        assert _rel(got[k], ref[k]) <= tol, k


@pytest.mark.parametrize("kk,n,dtype", [
    (4, 8, torch.float64),       # the 1-D models' speculative batch
    (1, 1, torch.float64),
    (16, 100, torch.float32),
    (16, 512, torch.float32),    # K tiles^2 = 256, the envelope's edge
    (4, 1024, torch.float64),    # n = 1024: 16.8 MB, the global workspace
    (4, 100, torch.float64),     # 178 KB: shared memory after the opt-in
])
def test_chol_quadratics_smallk_equals_plain(cuda, kk, n, dtype):
    g, y = _se_grams(kk, n, seed=kk + n)
    g, y = (torch.tensor(a, dtype=dtype, device=cuda) for a in (g, y))
    jitter = 1e-3 if dtype == torch.float32 else 1e-6
    before = chol_smallk.chol_quadratics_smallk.launches
    got = chol_smallk.chol_quadratics_smallk(g, y, jitter=jitter)
    torch.cuda.synchronize()
    assert chol_smallk.chol_quadratics_smallk.launches == before + 1
    ref = chol_smallk.chol_quadratics_smallk_plain(g, y, jitter=jitter)
    _quads_equal(got, ref, _tol(dtype))
    # only the lower triangle is read
    iu = torch.triu_indices(n, n, 1, device=cuda)
    junk = g.clone()
    junk[:, iu[0], iu[1]] = float("nan")
    again = chol_smallk.chol_quadratics_smallk(junk, y, jitter=jitter)
    for k in got:
        assert torch.equal(again[k], got[k]), k
    with pytest.raises(TypeError):
        chol_smallk.chol_quadratics_smallk(g, y.cpu())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_chol_quadratics_smallk_nan_on_the_same_members(cuda, dtype):
    r = np.random.default_rng(4)
    v = r.normal(size=(16, 40, 20))
    low = v @ np.swapaxes(v, 1, 2) / 40
    shift = np.where(np.arange(16) % 2 == 1, -1e-2, 1e-2)
    g = torch.tensor(low + shift[:, None, None] * np.eye(40), dtype=dtype,
                     device=cuda)
    y = torch.tensor(r.normal(size=40), dtype=dtype, device=cuda)
    got = chol_smallk.chol_quadratics_smallk(g, y)
    ref = chol_smallk.chol_quadratics_smallk_plain(g, y)
    nan = ~torch.isfinite(got["logdet"])
    assert torch.equal(nan.cpu(), torch.arange(16) % 2 == 1)
    _quads_equal(got, ref, _tol(dtype))


def _mix_case(kk, n, d, dtype, cuda, seed, indefinite=False):
    r = np.random.default_rng(seed)
    x = r.uniform(size=(n, d))
    r1 = np.exp(r.normal(size=(kk, d)))
    r2 = (1.0 + np.exp(r.normal(size=(kk, 1)))) * r1
    if indefinite:      # a negative rate makes odd members indefinite
        r1[1::2] = -5.0
    p = r.uniform(0.05, 0.95, size=kk)

    def t(a):
        return torch.tensor(np.asarray(a), dtype=dtype, device=cuda)

    return dict(x=t(x), y=t(np.sin(5 * x[:, 0])), r1=t(r1), r2=t(r2),
                p=t(p)), r


@pytest.mark.parametrize("kk,n,d,dtype", [
    (4, 8, 1, torch.float64),
    (4, 100, 2, torch.float32),
    (16, 256, 9, torch.float32),     # the K6/K7 gate's edge, global workspace
    (16, 256, 1, torch.float64),
    (4, 20, 2, torch.float64),       # the small one-round chains' shape
    (4, 40, 128, torch.float64),     # d = MAX_D, dim = MAX_D + 2
])
def test_fused_mix_kernels_equal_plain(cuda, kk, n, d, dtype):
    args, r = _mix_case(kk, n, d, dtype, cuda, seed=n + d)
    jitter = 1e-3 if dtype == torch.float32 else 1e-8
    before = chol_smallk.fused_mix_quadratics_smallk.launches
    got = chol_smallk.fused_mix_quadratics_smallk(**args, jitter=jitter)
    torch.cuda.synchronize()
    assert chol_smallk.fused_mix_quadratics_smallk.launches == before + 1
    _quads_equal(got, chol_smallk.fused_mix_quadratics_smallk_plain(
        **args, jitter=jitter), _tol(dtype))
    # K7 on the same Grams: accept-some and accept-none thresholds
    dim = d + 2

    def t(a):
        return torch.tensor(np.asarray(a), dtype=dtype, device=cuda)

    rnd = dict(extra=t(r.normal(size=kk)), log_scale=t(r.normal(size=kk)),
               cands=t(r.normal(size=(kk, dim))), lp_beta=t(0.3))
    for lp_val, log_u in ((t(-1e6), t(np.log(r.uniform(size=kk)))),
                          (t(1e6), t(np.log(r.uniform(size=kk))))):
        before = chol_smallk.fused_mix_mh_round.launches
        got = chol_smallk.fused_mix_mh_round(**args, **rnd, lp_val=lp_val,
                                             log_u=log_u, jitter=jitter)
        torch.cuda.synchronize()
        assert chol_smallk.fused_mix_mh_round.launches == before + 1
        ref = chol_smallk.fused_mix_mh_round_plain(
            **args, **rnd, lp_val=lp_val, log_u=log_u, jitter=jitter)
        assert bool(got[3]) == bool(ref[3])
        assert int(got[4]) == int(ref[4])
        for a, b in zip(got[:3], ref[:3]):
            assert _rel(a, b) <= _tol(dtype)
    assert not bool(got[3]) and int(got[4]) == kk   # lp_val = 1e6 rejects
    assert torch.equal(got[1], t(1e6)) and torch.equal(got[2], t(0.3))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fused_mix_kernels_nan_on_the_same_members(cuda, dtype):
    kk, n = 8, 30
    args, r = _mix_case(kk, n, 2, dtype, cuda, seed=9, indefinite=True)
    # jitter 1e-2 keeps the PSD members well away from a zero pivot
    args["jitter"] = 1e-2
    got = chol_smallk.fused_mix_quadratics_smallk(**args)
    ref = chol_smallk.fused_mix_quadratics_smallk_plain(**args)
    nan = ~torch.isfinite(got["logdet"])
    assert torch.equal(nan.cpu(), torch.arange(kk) % 2 == 1)
    _quads_equal(got, ref, _tol(dtype))
    # K7 rejects the NaN members: with thresholds that accept every finite
    # member, the first even member is taken
    t = lambda a: torch.tensor(np.asarray(a), dtype=dtype, device=cuda)  # noqa: E731
    z = chol_smallk.fused_mix_mh_round(
        **args, extra=t(np.zeros(kk)), log_scale=t(np.zeros(kk)),
        cands=t(np.arange(kk * 2.0).reshape(kk, 2)), lp_val=t(-1e30),
        lp_beta=t(0.0), log_u=t(np.r_[np.inf, np.full(kk - 1, -1.0)]))
    assert bool(z[3]) and int(z[4]) == 3      # member 1 is NaN, 2 is taken
    assert torch.equal(z[0].cpu(), torch.tensor([4.0, 5.0], dtype=dtype))

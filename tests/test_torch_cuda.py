"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

These tests need a CUDA device and `nvcc`; without them they skip. The
machine with the card has no JAX, and `tests/conftest.py` imports it, so
run them there without the conftest:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

Tolerances: the threefry chain is integer-exact, and the fused keys-and-
draws kernel (`chunk_draws`) bit-equal to its plain version. The rounds kernel and
the batched Cholesky kernels (K3-K9) run their plain versions' operations
in the same order with explicitly rounded arithmetic, so acceptance flags,
consumed counts and NaN positions are equal, and records, factors and
quadratics agree to 1e-4 (float32) and 1e-10 (float64) relative to
max(1, |value|) — room for the math library's exp / log / rsqrt, which
may differ from PyTorch's in the last place. K3 and K4 are held bit for
bit on both their paths, as chip_smoke.py's phase 7 holds them; K5-K7
bit for bit on the shapes where their cores change (n = 127 / 128 / 129)
and at the cluster core's sizes, as phase 11 holds them, K8 at an EB
row and the MAP cloud and K9 on every shape, with NaN on the same
members, as phase 14 holds them. Two paths without a kernel of their
own are held against the CPU: a `whiten=True` fit (the same chain, K1
never launched, draws and predictions within 1e-7) and the first-batch
ME design search (the same starts, the design within 1e-6 and the score
within 1e-9, BFGS's stopping point). K2's lanes launch is held bit for
bit against its plain version and L single launches; the lane-batched
sampler and a small sweep against the CPU (equal chains, 1e-8: the
card's erfinv parts from the CPU's by ulps), HMC over a short run (1e-8),
the dry run on the card four times over (1e-4, JAX's guard) and the
flagship forward in f64 (1e-10).
"""
import ctypes

import numpy as np
import pytest
import torch

from ccgp_tpu_torch.models.combination import MixtureSpec
from ccgp_tpu_torch.models.likelihood import cand_model_for
from ccgp_tpu_torch.models.priors import InverseGamma, JeffreysUnit, LogNormal
from ccgp_tpu_torch.ops import (_build, chol_lanes, chol_nll, chol_smallk,
                                gram_chol, kernels, rng)
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


def _bits(t):
    """A float tensor's bit patterns (bit-equality, -0 apart from +0)."""
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("rr", [1, 7, 120, 300])   # 300: three key segments
def test_chunk_draws_kernel_bit_equal(cuda, rr, dtype):
    """The fused keys-and-draws kernel against its plain version, bit for
    bit, over K in {1, 4, 16} x dim in {1, 4, 9} x three seeds, one launch
    per call."""
    for seed in (0, 7, 123456789):
        key = rng.PRNGKey(seed, device=cuda)
        for kk in (1, 4, 16):
            for dim in (1, 4, 9):
                before = rng.chunk_draws.launches
                got = rng.chunk_draws(key, rr, kk, dim, dtype)
                torch.cuda.synchronize()
                assert rng.chunk_draws.launches == before + 1
                ref = rng.chunk_draws_plain(key, rr, kk, dim, dtype)
                assert torch.equal(got[0], ref[0])
                for g, r in zip(got[1:], ref[1:]):
                    assert g.shape == r.shape and g.dtype == r.dtype
                    assert torch.equal(_bits(g), _bits(r))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_chunk_draws_erfinv_and_log_over_2_20_inputs(cuda, dtype):
    """The kernel's erfinv and log are PyTorch's on the card: 2^20 normals
    and 2^20 log-uniforms bit-equal to the plain version's."""
    key = rng.PRNGKey(2024, device=cuda)
    got = rng.chunk_draws(key, 16, 1 << 16, 1, dtype)
    ref = rng.chunk_draws_plain(key, 16, 1 << 16, 1, dtype)
    for g, r in zip(got[1:], ref[1:]):
        assert g.numel() == 1 << 20
        assert torch.equal(_bits(g), _bits(r))


def _rounds_args(cuda, n, rr, kk, dtype, indefinite=False, jeffreys=False):
    spec = MixtureSpec(kernels.sqexp_family(), kernels.sqexp_family(),
                       dim=2, rough="tied", anisotropic=True)
    r = np.random.default_rng(n)
    x = r.uniform(size=(n, 2))
    dim = 4

    def t(a):
        return torch.tensor(np.asarray(a), dtype=dtype, device=cuda)

    z, lp_val = [0.6, 0.4, 0.1, -0.2], -1e6
    jitter = 1e-3 if dtype == torch.float32 else 1e-9
    deltas = 0.25 * r.normal(size=(rr * kk, dim))
    if indefinite:
        # rough state (rates e^4), candidate 0 of every round smooth (e^-4):
        # the negative jitter makes its near-singular Gram indefinite
        z, lp_val, jitter = [4.0, 4.0, 0.1, -0.2], -1e30, -0.01
        deltas[0::kk, :2] -= 8.0
    return dict(x=t(x), y=t(np.sin(5 * x[:, 0]) + np.cos(3 * x[:, 1])),
                z=t(z), lp_val=t(lp_val), lp_beta=t(0.0), sigma2=t(0.05),
                deltas=t(deltas), log_u=t(np.log(r.uniform(size=(rr, kk)))),
                model=cand_model_for(spec, t(x), LogNormal(-1.0, 1.0),
                                     InverseGamma(3, 4),
                                     JeffreysUnit() if jeffreys else None),
                jitter=jitter, stash=True)


@pytest.mark.parametrize("n,rr,kk,dtype,tol,indefinite,jeffreys", [
    (16, 6, 4, torch.float64, 1e-10, False, False),
    (100, 20, 4, torch.float32, 1e-4, False, False),
    (300, 3, 4, torch.float32, 1e-4, False, False),  # beyond one 128 tile
    (14, 6, 1, torch.float64, 1e-10, False, False),  # a cluster of one block
    (14, 6, 16, torch.float64, 1e-10, False, False),  # two per block
    (128, 4, 5, torch.float32, 1e-4, False, False),  # the single tile's edge
    (129, 3, 16, torch.float64, 1e-10, False, False),  # multi-tile, 8 blocks
    (14, 6, 5, torch.float64, 1e-10, True, False),  # a NaN candidate rejected
    (100, 20, 4, torch.float32, 1e-4, False, True),  # JeffreysUnit p prior
    (20, 6, 4, torch.float64, 1e-10, False, True),
])
def test_rounds_kernel_equals_plain(cuda, n, rr, kk, dtype, tol, indefinite,
                                    jeffreys):
    args = _rounds_args(cuda, n, rr, kk, dtype, indefinite, jeffreys)
    before = chol_smallk.fused_mix_mh_rounds.launches
    got = chol_smallk.fused_mix_mh_rounds(**args)
    torch.cuda.synchronize()
    assert chol_smallk.fused_mix_mh_rounds.launches == before + 1
    ref = chol_smallk.fused_mix_mh_rounds_plain(**args)
    assert torch.equal(got["acc"], ref["acc"])
    assert torch.equal(got["consumed"], ref["consumed"])
    assert torch.equal(torch.isnan(got["stash"]), torch.isnan(ref["stash"]))
    assert _rel(got["rec"], ref["rec"]) <= tol
    acc = ref["acc"]
    assert int(acc.sum()) >= 1
    if indefinite:      # candidate 0 is never taken
        assert bool((ref["consumed"] >= 2).all())
    for a, b in zip(decode_stash(got["stash"][acc], n),
                    decode_stash(ref["stash"][acc], n)):
        assert _rel(a, b) <= tol
    # a tensor left on the host is refused, not computed
    with pytest.raises(TypeError):
        chol_smallk.fused_mix_mh_rounds(**dict(args, y=args["y"].cpu()))


def test_rounds_refused_launch_leaves_no_error(cuda):
    """K1's entry point outside the envelope (K = 17) returns an error code
    without launching, and the next launch is not charged with it."""
    lib = _build.library()
    args = _rounds_args(cuda, 20, 2, 17, torch.float64)
    a = {k: v for k, v in args.items() if isinstance(v, torch.Tensor)}
    st = torch.stack([a["lp_val"], a["lp_beta"], a["sigma2"]])
    rec = torch.empty((2, 6), dtype=torch.float64, device=cuda)
    info = torch.empty((2, 2), dtype=torch.int32, device=cuda)
    code = lib.ccgp_mh_rounds_f64(
        *(t.data_ptr() for t in (a["x"], a["y"], a["z"], st, a["deltas"],
                                 a["log_u"], rec, info)),
        None, None, ctypes.addressof(args["model"]), 20, 2, 4, 2, 17, 0.0,
        _build.stream(a["x"].device))
    assert code != 0
    with pytest.raises(RuntimeError):
        _build.check(code, "fused_mix_mh_rounds")
    ok = _rounds_args(cuda, 20, 3, 4, torch.float64)
    got = chol_smallk.fused_mix_mh_rounds(**ok)
    torch.cuda.synchronize()
    ref = chol_smallk.fused_mix_mh_rounds_plain(**ok)
    assert torch.equal(got["consumed"], ref["consumed"])
    assert _rel(got["rec"], ref["rec"]) <= 1e-10


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


def _bit_equal(got, ref):
    """Every output equal bit for bit (+0 and -0 as equal), NaN in the same
    places."""
    assert set(got) == set(ref)
    for k in ref:
        a, b = got[k].cpu(), ref[k].cpu()
        assert torch.equal(torch.isnan(a), torch.isnan(b)), k
        assert torch.equal(a.nan_to_num(0.0), b.nan_to_num(0.0)), k


@pytest.mark.parametrize("b,n,dtype,jitter", [
    (128, 100, torch.float32, 1e-3),     # the MAP cloud
    (64, 100, torch.float32, 1e-3),      # a lazy predict chunk
    (1728, 14, torch.float64, 1e-6),     # an EB row (the warp path)
    (130, 17, torch.float32, 1e-3),
    (65, 8, torch.float64, 0.0),         # a part-filled warp group
    (64, 32, torch.float32, 1e-3),       # the warp path's widest n
    (64, 33, torch.float64, 1e-6),       # the tile path's narrowest n
    # f64 at n = 128 takes 74 KB of shared memory: launched only after the
    # opt-in above 48 KB, refused without it
    (200, 128, torch.float64, 1e-6),
])
def test_chol_lanes_kernels_equal_plain(cuda, b, n, dtype, jitter):
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
        _bit_equal(got, plain(g, y, jitter=jitter))
    # only the lower triangle is loaded: NaN above the diagonal changes
    # nothing
    iu = torch.triu_indices(n, n, 1, device=cuda)
    junk = g.clone()
    junk[:, iu[0], iu[1]] = float("nan")
    for kern in (chol_lanes.chol_quadratics_lanes,
                 chol_lanes.chol_factors_lanes):
        _bit_equal(kern(junk, y, jitter=jitter), kern(g, y, jitter=jitter))
    # a tensor left on the host is refused, not computed
    with pytest.raises(TypeError):
        chol_lanes.chol_quadratics_lanes(g, y.cpu())


@pytest.mark.parametrize("n", [14, 40])   # the warp path, the tile path
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_chol_lanes_nan_on_the_same_matrices(cuda, dtype, n):
    r = np.random.default_rng(3)
    v = r.normal(size=(64, n, n // 2))
    low = v @ np.swapaxes(v, 1, 2) / n
    shift = np.where(np.arange(64) % 2 == 1, -1e-2, 1e-2)
    g = torch.tensor(low + shift[:, None, None] * np.eye(n), dtype=dtype,
                     device=cuda)
    y = torch.tensor(r.normal(size=n), dtype=dtype, device=cuda)
    got = chol_lanes.chol_factors_lanes(g, y)
    nan = ~torch.isfinite(got["logdet"])
    assert torch.equal(nan.cpu(), torch.arange(64) % 2 == 1)
    _bit_equal(got, chol_lanes.chol_factors_lanes_plain(g, y))
    # the upper triangle stays exactly 0 even where the factor failed
    assert torch.equal(torch.triu(got["chol"], 1),
                       torch.zeros_like(got["chol"]))


@pytest.mark.parametrize("n,group,threads", [
    (1, 8, 64), (8, 8, 64), (9, 16, 64), (16, 16, 64), (17, 32, 64),
    (32, 32, 64),                        # the warp path: 64 / group a block
    (33, 0, 64), (100, 0, 512), (128, 0, 1024),   # a block per matrix
])
def test_chol_lanes_layout(cuda, n, group, threads):
    for dtype in (torch.float32, torch.float64):
        for b in (64, 65, 1728):
            blocks = -(-b * group // threads) if group else b
            assert chol_lanes.lanes_layout(n, b, dtype) == (group, threads,
                                                            blocks)
    with pytest.raises(RuntimeError):
        chol_lanes.lanes_layout(129, 64, torch.float32)


def test_refused_launch_raises_and_leaves_no_error(cuda):
    """A launch the entry point refuses (n = 180, above the 128 the
    kernels hold) comes back as an error code, and the next launch is not
    charged with it."""
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


def _equal_quads(got, ref):
    return all(torch.equal(got[k].nan_to_num(), ref[k].nan_to_num())
               for k in ref)


@pytest.mark.parametrize("kk,n,dtype", [
    (kk, n, dtype) for dtype in (torch.float32, torch.float64)
    for kk in (1, 4, 16) for n in (8, 127, 128, 129, 256, 512)] + [
    (4, 1024, torch.float32), (4, 1024, torch.float64)])
def test_chol_quadratics_smallk_bit_equal(cuda, kk, n, dtype):
    """K5 on both of its cores (register tiles up to n = 128, a cluster
    per Gram beyond; n = 1024 f64 with its rows in the global workspace)
    gives its twin's numbers bit for bit."""
    g, y = _se_grams(kk, n, seed=kk * n)
    g, y = (torch.tensor(a, dtype=dtype, device=cuda) for a in (g, y))
    jitter = 1e-3 if dtype == torch.float32 else 1e-6
    before = chol_smallk.chol_quadratics_smallk.launches
    got = chol_smallk.chol_quadratics_smallk(g, y, jitter=jitter)
    torch.cuda.synchronize()
    assert chol_smallk.chol_quadratics_smallk.launches == before + 1
    ref = chol_smallk.chol_quadratics_smallk_plain(g, y, jitter=jitter)
    assert _equal_quads(got, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_chol_quadratics_smallk_nan_above_one_tile(cuda, dtype):
    """On the cluster core: NaN above the diagonal changes no output
    (n = 300), and an indefinite member is NaN alone (n = 150)."""
    g, y = _se_grams(4, 300, seed=3)
    g, y = (torch.tensor(a, dtype=dtype, device=cuda) for a in (g, y))
    iu = torch.triu_indices(300, 300, 1, device=cuda)
    junk = g.clone()
    junk[:, iu[0], iu[1]] = float("nan")
    a = chol_smallk.chol_quadratics_smallk(g, y, jitter=1e-3)
    b = chol_smallk.chol_quadratics_smallk(junk, y, jitter=1e-3)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    r = np.random.default_rng(5)
    v = r.normal(size=(4, 150, 60))
    shift = np.where(np.arange(4) % 2 == 1, -1e-2, 1e-2)
    g = torch.tensor(v @ np.swapaxes(v, 1, 2) / 150 + shift[:, None, None]
                     * np.eye(150), dtype=dtype, device=cuda)
    y = torch.tensor(r.normal(size=150), dtype=dtype, device=cuda)
    got = chol_smallk.chol_quadratics_smallk(g, y)
    nan = ~torch.isfinite(got["logdet"])
    assert torch.equal(nan.cpu(), torch.arange(4) % 2 == 1)
    assert _equal_quads(got, chol_smallk.chol_quadratics_smallk_plain(g, y))


def test_smallk_refused_launch_leaves_no_error(cuda):
    """K5's entry point refuses what its cluster core cannot run at
    n = 300 (K = 17, outside the envelope; K = 4 without the exchange
    workspace the layout asks for): an error code comes back without a
    launch, raises through `_build.check`, and the next launch is not
    charged with it."""
    lib = _build.library()
    n = 300
    g = torch.eye(n, dtype=torch.float32, device=cuda).expand(17, n, n)
    g = g.contiguous()
    y = torch.ones(n, dtype=torch.float32, device=cuda)
    q = torch.empty((17, 4), dtype=torch.float32, device=cuda)
    for kk in (17, 4):
        code = lib.ccgp_chol_quad_smallk_f32(g.data_ptr(), y.data_ptr(),
                                             q.data_ptr(), None, n, kk, 0.0,
                                             _build.stream(g.device))
        assert code != 0
        with pytest.raises(RuntimeError):
            _build.check(code, "chol_quadratics_smallk")
    g2, y2 = _se_grams(4, n, seed=1)
    g2, y2 = (torch.tensor(a, dtype=torch.float32, device=cuda)
              for a in (g2, y2))
    got = chol_smallk.chol_quadratics_smallk(g2, y2, jitter=1e-3)
    torch.cuda.synchronize()
    assert _equal_quads(got, chol_smallk.chol_quadratics_smallk_plain(
        g2, y2, jitter=1e-3))


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


@pytest.mark.parametrize("kk,n,dtype", [
    (4, 8, torch.float64),
    (4, 100, torch.float32),      # the bench's one-round shape
    (16, 100, torch.float64),     # two candidates per block
    (5, 128, torch.float32),
    (16, 128, torch.float64),
    (16, 256, torch.float32),     # beyond one tile: one block for all K
])
def test_mh_round_bit_equal_for_every_consumed(cuda, kk, n, dtype):
    """K7 gives its twin's outputs bit for bit whichever member is taken
    first (consumed 1..K) and when none is (consumed K, lp_val kept)."""
    args, r = _mix_case(kk, n, 2, dtype, cuda, seed=n + kk)
    jitter = 1e-3 if dtype == torch.float32 else 1e-8

    def t(a):
        return torch.tensor(np.asarray(a), dtype=dtype, device=cuda)

    rnd = dict(extra=t(r.normal(size=kk)), log_scale=t(r.normal(size=kk)),
               cands=t(r.normal(size=(kk, 4))), lp_beta=t(0.3))
    order = np.arange(kk)
    trials = [(t(-1e6), t(np.where(order < m, np.inf, -np.inf)), m + 1)
              for m in range(kk)]
    trials.append((t(1e6), t(np.log(r.uniform(size=kk))), kk))
    for lp_val, log_u, consumed in trials:
        got = chol_smallk.fused_mix_mh_round(**args, **rnd, lp_val=lp_val,
                                             log_u=log_u, jitter=jitter)
        torch.cuda.synchronize()
        ref = chol_smallk.fused_mix_mh_round_plain(
            **args, **rnd, lp_val=lp_val, log_u=log_u, jitter=jitter)
        assert int(got[4]) == int(ref[4]) == consumed
        assert bool(got[3]) == bool(ref[3])
        for a, b in zip(got[:3], ref[:3]):
            assert torch.equal(a, b)


@pytest.mark.parametrize("kk,n,d", [(1, 8, 1), (4, 100, 2), (16, 128, 9),
                                    (4, 129, 2), (16, 256, 1), (4, 512, 2)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fused_mix_quadratics_smallk_bit_equal(cuda, kk, n, d, dtype):
    """K6 on both of K5's cores (a block per matrix up to n = 128, a
    cluster per matrix beyond) gives its twin's numbers bit for bit."""
    args, _ = _mix_case(kk, n, d, dtype, cuda, seed=kk * n + d)
    jitter = 1e-3 if dtype == torch.float32 else 1e-8
    before = chol_smallk.fused_mix_quadratics_smallk.launches
    got = chol_smallk.fused_mix_quadratics_smallk(**args, jitter=jitter)
    torch.cuda.synchronize()
    assert chol_smallk.fused_mix_quadratics_smallk.launches == before + 1
    assert _equal_quads(got, chol_smallk.fused_mix_quadratics_smallk_plain(
        **args, jitter=jitter))


@pytest.mark.parametrize("n", [8, 100, 129, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fused_mix_quadratics_smallk_takes_k5_layout(cuda, n, dtype):
    for kk in (1, 4, 16):
        assert (chol_smallk.smallk_layout("fused_mix_quadratics_smallk", n,
                                          kk, dtype)
                == chol_smallk.smallk_layout("chol_quadratics_smallk", n, kk,
                                             dtype))


@pytest.mark.parametrize("n", [30, 150])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fused_mix_quadratics_smallk_nan_bit_equal(cuda, n, dtype):
    """An indefinite batch on either core: NaN on the odd members alone,
    every output equal to the twin's."""
    args, _ = _mix_case(8, n, 2, dtype, cuda, seed=9, indefinite=True)
    got = chol_smallk.fused_mix_quadratics_smallk(**args, jitter=1e-2)
    nan = ~torch.isfinite(got["logdet"])
    assert torch.equal(nan.cpu(), torch.arange(8) % 2 == 1)
    assert _equal_quads(got, chol_smallk.fused_mix_quadratics_smallk_plain(
        **args, jitter=1e-2))


# ---------------------------------------------------------------------------
# K9 (chol_nll, the per-matrix left-looking kernel) and K8
# (fused_mix_quadratics, the fused mixture-Gram kernel)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,n,dtype", [
    (128, 100, torch.float32),     # the MAP cloud
    (4, 33, torch.float64),
    (1, 128, torch.float64),       # 133 KB of shared memory after the opt-in
    (32, 14, torch.float32),
    (5, 1, torch.float64),
    (3, 9, torch.float32),         # a last panel of one column
    (2, 17, torch.float64),        # a panel of one row below the top rows
    (7, 127, torch.float32),       # a last panel of seven columns
])
def test_chol_nll_equals_plain(cuda, b, n, dtype):
    g, y = _se_grams(b, n, seed=b + n)
    g, y = (torch.tensor(a, dtype=dtype, device=cuda) for a in (g, y))
    jitter = 1e-3 if dtype == torch.float32 else 1e-6
    before = chol_nll.chol_nll.launches
    got = chol_nll.chol_nll(g, y, jitter=jitter)
    torch.cuda.synchronize()
    assert chol_nll.chol_nll.launches == before + 1
    _bit_equal(got, chol_nll.chol_nll_plain(g, y, jitter=jitter))
    iu = torch.triu_indices(n, n, 1, device=cuda)
    junk = g.clone()
    junk[:, iu[0], iu[1]] = float("nan")
    again = chol_nll.chol_nll(junk, y, jitter=jitter)
    for k in got:
        assert torch.equal(again[k], got[k]), k
    with pytest.raises(TypeError):
        chol_nll.chol_nll(g, y.cpu())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_chol_nll_nan_on_the_same_members(cuda, dtype):
    r = np.random.default_rng(4)
    v = r.normal(size=(16, 40, 20))
    low = v @ np.swapaxes(v, 1, 2) / 40
    shift = np.where(np.arange(16) % 2 == 1, -1e-2, 1e-2)
    g = torch.tensor(low + shift[:, None, None] * np.eye(40), dtype=dtype,
                     device=cuda)
    y = torch.tensor(r.normal(size=40), dtype=dtype, device=cuda)
    got = chol_nll.chol_nll(g, y)
    nan = ~torch.isfinite(got["logdet"])
    assert torch.equal(nan.cpu(), torch.arange(16) % 2 == 1)
    _bit_equal(got, chol_nll.chol_nll_plain(g, y))


@pytest.mark.parametrize("b,n,d,dtype,per_lane", [
    (1728, 14, 2, torch.float64, True),    # an EB row
    (128, 100, 2, torch.float32, False),   # the MAP cloud's shape
    (5, 128, 16, torch.float64, True),     # the limits: 71 KB of workspace
    (1, 26, 9, torch.float32, True),
])
def test_fused_mix_quadratics_equals_plain(cuda, b, n, d, dtype, per_lane):
    r = np.random.default_rng(b + n + d)
    x = r.uniform(size=(n, d))
    r1 = np.exp(r.normal(size=(b, d)))
    r2 = (1.0 + np.exp(r.normal(size=(b, 1)))) * r1

    def t(a):
        return torch.tensor(np.asarray(a), dtype=dtype, device=cuda)

    args = dict(x=t(x), y=t(np.sin(5 * x[:, 0])), r1=t(r1), r2=t(r2),
                p=t(r.uniform(0.05, 0.95, size=b)))
    if per_lane:
        args.update(scale=t(r.uniform(0.5, 2.0, b)),
                    shift=t(r.uniform(0.0, 3.0, b)))
    else:
        args.update(scale=1.3, shift=0.2)
    jitter = 1e-3 if dtype == torch.float32 else 1e-8
    before = gram_chol.fused_mix_quadratics.launches
    got = gram_chol.fused_mix_quadratics(**args, jitter=jitter)
    torch.cuda.synchronize()
    assert gram_chol.fused_mix_quadratics.launches == before + 1
    _quads_equal(got, gram_chol.fused_mix_quadratics_plain(**args,
                                                            jitter=jitter),
                 _tol(dtype))
    with pytest.raises(TypeError):
        gram_chol.fused_mix_quadratics(**dict(args, y=args["y"].cpu()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fused_mix_quadratics_nan_on_the_same_lanes(cuda, dtype):
    args, _ = _mix_case(8, 30, 2, dtype, cuda, seed=9, indefinite=True)
    got = gram_chol.fused_mix_quadratics(**args, scale=2.0, jitter=1e-2)
    nan = ~torch.isfinite(got["logdet"])
    assert torch.equal(nan.cpu(), torch.arange(8) % 2 == 1)
    _quads_equal(got, gram_chol.fused_mix_quadratics_plain(
        **args, scale=2.0, jitter=1e-2), _tol(dtype))


def _k8_case(b, n, d, dtype, cuda, seed):
    """K8 inputs with scale and shift per lane."""
    args, r = _mix_case(b, n, d, dtype, cuda, seed)
    args.update(scale=torch.tensor(r.uniform(0.5, 2.0, b), dtype=dtype,
                                   device=cuda),
                shift=torch.tensor(r.uniform(0.0, 3.0, b), dtype=dtype,
                                   device=cuda))
    return args


@pytest.mark.parametrize("b,n,d,dtype", [
    (1728, 14, 2, torch.float64),    # an EB row: a warp per lane
    (128, 100, 2, torch.float32),    # the MAP cloud: 512 threads per lane
])
def test_fused_mix_quadratics_bit_equal(cuda, b, n, d, dtype):
    args = _k8_case(b, n, d, dtype, cuda, seed=b + n)
    jitter = 1e-3 if dtype == torch.float32 else 1e-8
    before = gram_chol.fused_mix_quadratics.launches
    got = gram_chol.fused_mix_quadratics(**args, jitter=jitter)
    torch.cuda.synchronize()
    assert gram_chol.fused_mix_quadratics.launches == before + 1
    assert _equal_quads(got, gram_chol.fused_mix_quadratics_plain(
        **args, jitter=jitter))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fused_mix_quadratics_nan_bit_equal(cuda, dtype):
    """An indefinite batch with per-lane scale and shift: NaN on the odd
    lanes alone, every output equal to the twin's."""
    args, r = _mix_case(8, 30, 2, dtype, cuda, seed=9, indefinite=True)
    args.update(scale=torch.tensor(r.uniform(0.5, 2.0, 8), dtype=dtype,
                                   device=cuda), shift=0.1)
    got = gram_chol.fused_mix_quadratics(**args, jitter=1e-2)
    nan = ~torch.isfinite(got["logdet"])
    assert torch.equal(nan.cpu(), torch.arange(8) % 2 == 1)
    assert _equal_quads(got, gram_chol.fused_mix_quadratics_plain(
        **args, jitter=1e-2))


# ---------------------------------------------------------------------------
# whiten=True and the design search: the card against the CPU
# ---------------------------------------------------------------------------

def _whiten_fit(device):
    from ccgp_tpu_torch.models.combined_gp import (
        MCMCConfig, fit_combined_gp, predict_combined_gp)

    r = np.random.default_rng(0)
    x = r.uniform(size=(16, 2))
    y = np.sin(5 * x[:, 0]) + np.cos(3 * x[:, 1])
    u = np.linspace(0, 1, 5)
    grid = np.stack(np.meshgrid(u, u), -1).reshape(-1, 2)
    t = lambda a: torch.tensor(a, dtype=torch.float64, device=device)  # noqa: E731
    spec = MixtureSpec(kernels.sqexp_family(), kernels.sqexp_family(), dim=2,
                       rough="tied", anisotropic=True)
    kf, kp = rng.split(rng.PRNGKey(2, device=device), 2)
    fit = fit_combined_gp(spec, t(x), t(y), kf, mcmc=MCMCConfig(
        start=(1.0, 1.0, 0.0, 0.0), n_max=400, samp_size=120,
        net_samp_size=120, speculative=4), theta1_prior=LogNormal(-1, 1),
        theta2_prior=InverseGamma(3, 4), jitter=1e-6, mle_method="grid",
        whiten=True, device=device)
    return fit, predict_combined_gp(spec, fit, t(x), t(grid), kp,
                                    device=device)


def test_whiten_fit_gpu_equals_cpu(cuda):
    """whiten=True at a small f64 size: the same chain on the card as on
    the CPU, no fused rounds kernel and no stash, draws and predictions
    within 1e-7."""
    before = chol_smallk.fused_mix_mh_rounds.launches
    fg, pg = _whiten_fit(cuda)
    torch.cuda.synchronize()
    assert chol_smallk.fused_mix_mh_rounds.launches == before
    fc, pc = _whiten_fit("cpu")
    assert fg.mcmc.factors is None
    for a in ("n_recorded", "n_proposals", "n_rounds", "converged"):
        assert getattr(fg.mcmc, a) == getattr(fc.mcmc, a), a
    assert _rel(fg.zs, fc.zs) <= 1e-7
    for f in ("mean", "lower", "upper"):
        assert _rel(getattr(pg, f), getattr(pc, f)) <= 1e-7


def test_me_design_gpu_equals_cpu(cuda):
    """The first-batch ME search at a small size (6 points, 3 starts,
    maxiter 40), f64: the same starts, the design within 1e-6 and the score
    within 1e-9 (BFGS's stopping point)."""
    from ccgp_tpu_torch.design import me_design
    from ccgp_tpu_torch.design.optimize import _starts
    from ccgp_tpu_torch.models.combination import MixParams

    spec = MixtureSpec(kernels.sqexp_family(), kernels.sqexp_family(), dim=2)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        t = lambda v: torch.tensor(v, dtype=torch.float64, device=dev)  # noqa: E731
        key = rng.PRNGKey(0, device=dev)
        out[dev.type] = (_starts(key, 6, 2, 3, (-1.0, 1.0), torch.float64),
                         me_design(spec, MixParams(p=t(0.5), theta1=t(1.0),
                                                   theta2=t(4.0)),
                                   6, 2, key, n_starts=3, maxiter=40))
    (sg, rg), (sc, rc) = out["cuda"], out["cpu"]
    assert torch.equal(sg.cpu(), sc)
    assert _rel(rg.design, rc.design) <= 1e-6
    assert _rel(rg.score, rc.score) <= 1e-9


@pytest.fixture(scope="module")
def case_data(tmp_path_factory):
    """The rebuilt ground-vibrations data and the heat stand-ins under one
    root, the port's loaders pointed at it."""
    import chip_smoke
    from ccgp_tpu_torch.eval import datasets

    root = tmp_path_factory.mktemp("case_data")
    chip_smoke.gv_data_root(root, samples=(1,))
    chip_smoke.standin_data_root(root)
    before = datasets._DEFAULT_ROOTS
    datasets._DEFAULT_ROOTS = (str(root),)
    yield chip_smoke
    datasets._DEFAULT_ROOTS = before


@pytest.mark.parametrize("rr,seed", [(20, 1), (120, 2)])
def test_rounds_kernel_bit_equal_at_gv_shape(cuda, case_data, rr, seed):
    """K1 at the ground-vibrations study's shape (K = 4, n = 50, d = 9,
    f64, the isotropic SE x SE model with its priors, stash on) bit for bit
    against its twin, as chip_smoke.py's phase 19f holds it."""
    args = case_data._gv_rounds_args(rr, [0.5, 1.5, 0.0], seed)
    before = chol_smallk.fused_mix_mh_rounds.launches
    got = chol_smallk.fused_mix_mh_rounds(**args)
    torch.cuda.synchronize()
    assert chol_smallk.fused_mix_mh_rounds.launches == before + 1
    ref = chol_smallk.fused_mix_mh_rounds_plain(**args)
    assert int(ref["acc"].sum()) >= 1
    for k in ("acc", "consumed"):
        assert torch.equal(got[k], ref[k]), k
    for k in ("rec", "stash"):
        a, b = got[k].cpu(), ref[k].cpu()
        assert torch.equal(torch.isnan(a), torch.isnan(b)), k
        assert torch.equal(_bits(a.nan_to_num(0.0) + 0.0),
                           _bits(b.nan_to_num(0.0) + 0.0)), k


@pytest.mark.parametrize("row", [0, 311, 623])
def test_lanes_bit_equal_at_heat_eb_shape(cuda, case_data, row):
    """K3 and K4 at the heat exchanger's EB scan shape (B = 1000 Halton
    nodes, n = 64, f64, a stand-in grid row's covariances sigma2_t R_mix +
    tau^2 J) bit for bit against their twins, one launch each."""
    covs, y = case_data._heat_eb_row(row)
    for kern, plain in ((chol_lanes.chol_quadratics_lanes,
                         chol_lanes.chol_quadratics_lanes_plain),
                        (chol_lanes.chol_factors_lanes,
                         chol_lanes.chol_factors_lanes_plain)):
        before = kern.launches
        got = kern(covs, y)
        torch.cuda.synchronize()
        assert kern.launches == before + 1
        _bit_equal(got, plain(covs, y))


# ---------------------------------------------------------------------------
# the sweep and the parallel surface: K2's lanes launch, the lane driver,
# HMC, the dry run and entry()
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("lanes,rr,kk,dim", [(1, 7, 1, 3), (3, 120, 1, 3),
                                             (100, 120, 1, 3), (5, 129, 4, 4),
                                             (300, 20, 16, 9)])
def test_chunk_draws_lanes_kernel_bit_equal(cuda, lanes, rr, kk, dim, dtype):
    """One launch for all lanes, bit-equal to the plain version on the
    card and to L single `chunk_draws` launches (the same body, the same
    thread order per lane)."""
    keys = rng.split(rng.PRNGKey(77, device=cuda), lanes)
    before = rng.chunk_draws_lanes.launches
    got = rng.chunk_draws_lanes(keys, rr, kk, dim, dtype)
    torch.cuda.synchronize()
    assert rng.chunk_draws_lanes.launches == before + 1
    ref = rng.chunk_draws_lanes_plain(keys, rr, kk, dim, dtype)
    single = [rng.chunk_draws(keys[i], rr, kk, dim, dtype)
              for i in range(lanes)]
    assert torch.equal(got[0], ref[0])
    for i in (1, 2):
        assert torch.equal(_bits(got[i]), _bits(ref[i]))
        assert torch.equal(_bits(got[i]),
                           _bits(torch.stack([s[i] for s in single])))


def _lanes_case(device):
    from ccgp_tpu_torch.models.likelihood import make_logpost_lanes

    g = np.random.default_rng(1)
    xs = torch.tensor(g.uniform(size=(3, 14, 2)), device=device)
    ys = torch.sin(5 * xs[..., 0]) + torch.cos(3 * xs[..., 1])
    s2 = torch.tensor([0.5, 0.7, 1.1], dtype=torch.float64, device=device)
    spec = MixtureSpec(kernels.sqexp_family(), kernels.sqexp_family(), dim=2)
    lp = make_logpost_lanes(spec, xs, ys, s2,
                            theta1_prior=InverseGamma(3, 2),
                            theta2_prior=InverseGamma(5, 16), jitter=1e-5)
    keys = rng.split(rng.PRNGKey(0, device=device), 3)
    starts = torch.tensor([[1.0, 1.0, 0.0]] * 3, dtype=torch.float64,
                          device=device)
    return lp, starts, keys


def test_metropolis_lanes_gpu_equals_cpu(cuda):
    """The lane driver on the card against the CPU: the same chains
    (equal counters, draws within 1e-8: the card's erfinv parts from the
    CPU's by ulps), K2's lanes launch once per 120 rounds."""
    from ccgp_tpu_torch.infer.metropolis import metropolis_lanes

    before = rng.chunk_draws_lanes.launches
    rg = metropolis_lanes(*_lanes_case(cuda), n_max=300, samp_size=100)
    launched = rng.chunk_draws_lanes.launches - before
    rc = metropolis_lanes(*_lanes_case("cpu"), n_max=300, samp_size=100)
    assert launched == -(-int(rg.n_rounds.max()) // 120)
    for f in ("n_recorded", "n_proposals", "n_accepted"):
        np.testing.assert_array_equal(getattr(rg, f), getattr(rc, f))
    assert _rel(rg.samples, rc.samples) <= 1e-8


def test_sweep_gpu_equals_cpu(cuda, case_data):
    """`sim_2d_sweep.run` at 3 designs, n_max 300, on the card and the
    CPU (stand-in Train_Designs): equal chains, summaries within 1e-8, K2's
    lanes launch and K4 launched."""
    from ccgp_tpu_torch.experiments import sim_2d_sweep
    from ccgp_tpu_torch.models.combined_gp import MCMCConfig

    cfg = sim_2d_sweep.Config(n_designs=3, n_new_axis=5, mcmc=MCMCConfig(
        start=(1.0, 1.0, 0.0), n_max=300, samp_size=100, net_samp_size=80))
    out = {}
    for dev in (cuda, "cpu"):
        st = {}
        k0, k4 = rng.chunk_draws_lanes.launches, \
            chol_lanes.chol_factors_lanes.launches
        res = sim_2d_sweep.run(cfg, key=rng.PRNGKey(0, device=dev),
                               dtype=torch.float64, device=dev, stages=st)
        out[str(dev)] = (res, st["chains"],
                         rng.chunk_draws_lanes.launches - k0,
                         chol_lanes.chol_factors_lanes.launches - k4)
    (g, gc, g2, g4), (c, cc, c2, c4) = out["cuda"], out["cpu"]
    assert g2 >= 1 and g4 == 3 and c2 == c4 == 0
    np.testing.assert_array_equal(gc.n_proposals, cc.n_proposals)
    np.testing.assert_array_equal(g.chain_ok, c.chain_ok)
    for f in ("rmspe", "coverage", "quant"):
        np.testing.assert_allclose(getattr(g, f), getattr(c, f), rtol=1e-8)


def test_hmc_gpu_equals_cpu(cuda):
    """HMC on the card against the CPU, f64, a GP posterior with its
    Laplace covariance as mass, over a short run (10 warmup, 40 draws):
    within 1e-8 (the chains part later, as across packages)."""
    from ccgp_tpu_torch.infer.hmc import hmc
    from ccgp_tpu_torch.infer.laplace import laplace
    from ccgp_tpu_torch.models.likelihood import make_logpost

    def run(device):
        g = np.random.default_rng(0)
        x = torch.tensor(g.uniform(size=(10, 2)), device=device)
        y = torch.sin(5 * x[:, 0]) + torch.cos(3 * x[:, 1])
        spec = MixtureSpec(kernels.sqexp_family(), kernels.sqexp_family(),
                           dim=2)
        lp = make_logpost(spec, x, y, 0.5, theta1_prior=InverseGamma(3, 2),
                          theta2_prior=InverseGamma(5, 16), jitter=1e-6)
        start = torch.tensor([0.5, 1.0, 0.0], dtype=torch.float64,
                             device=device)
        fit = laplace(lambda z: lp(z).val, start)
        return hmc(lambda z: lp(z).val, fit.mode.detach(),
                   rng.PRNGKey(3, device=device), n_samples=40, n_warmup=10,
                   mass_cov=fit.cov)

    g, c = run(cuda), run("cpu")
    assert g.samples.device.type == "cuda"
    assert _rel(g.samples, c.samples) <= 1e-8
    assert int(g.n_divergent) == int(c.n_divergent)


def test_dryrun_multichip_on_a_repeated_card(cuda):
    from ccgp_tpu_torch.graft_entry import dryrun_multichip

    par = dryrun_multichip(4)
    assert max(par.values()) < 1e-4


def test_entry_forward_gpu_equals_cpu(cuda):
    from ccgp_tpu_torch.graft_entry import _flagship, entry

    fg, ag = entry()
    assert ag[0].device.type == "cuda"
    f64g, a64g = _flagship(torch.float64, cuda)
    f64c, a64c = _flagship(torch.float64, "cpu")
    for g, c in zip(f64g(*a64g), f64c(*a64c)):
        assert _rel(g, c) <= 1e-10
    for g in fg(*ag):
        assert torch.all(torch.isfinite(g))


# ---------------------------------------------------------------------------
# the last options: K2 at 2^24 draws a round, chains over the card and the
# CPU at once, the inv_matmul moments, the one-design sweep
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_chunk_draws_kernel_bit_equal_at_2_24_draws_per_round(cuda, dtype):
    """K dim = 2^24 (rr = 1), where a segment's draws are indexed in 64
    bits: the single launch and a two-lane launch bit-equal to their
    twins."""
    kk = dim = 1 << 12
    key = rng.PRNGKey(24, device=cuda)
    got = rng.chunk_draws(key, 1, kk, dim, dtype)
    ref = rng.chunk_draws_plain(key, 1, kk, dim, dtype)
    assert torch.equal(got[0], ref[0])
    for g, r in zip(got[1:], ref[1:]):
        assert torch.equal(_bits(g), _bits(r))
    del ref
    keys = rng.split(key, 2)
    lanes = rng.chunk_draws_lanes(keys, 1, kk, dim, dtype)
    for i in range(2):
        single = rng.chunk_draws(keys[i], 1, kk, dim, dtype)
        assert torch.equal(lanes[0][i], single[0])
        for j in (1, 2):
            assert torch.equal(_bits(lanes[j][i]), _bits(single[j]))


def test_multi_chain_metropolis_on_the_card_and_the_cpu(cuda):
    """The mesh ["cuda:0", "cpu"]: the card's shard equals its chains on
    cuda:0 alone and the CPU's shard its chains on the CPU alone, bit for
    bit; the card's shard draws through K2's lanes launch."""
    from ccgp_tpu_torch.models.likelihood import make_logpost
    from ccgp_tpu_torch.parallel import make_mesh, multi_chain_metropolis

    g = np.random.default_rng(0)
    x = torch.tensor(g.uniform(size=(10, 2)), device=cuda)
    y = torch.sin(5 * x[:, 0]) + torch.cos(3 * x[:, 1])
    spec = MixtureSpec(kernels.sqexp_family(), kernels.sqexp_family(), dim=2)
    lp = make_logpost(spec, x, y, 0.5, theta1_prior=InverseGamma(3, 2),
                      theta2_prior=InverseGamma(5, 16), jitter=1e-6)
    starts = torch.tensor([[1.0, 1.0, 0.0]] * 4, dtype=torch.float64,
                          device=cuda)
    keys = rng.split(rng.PRNGKey(3, device=cuda), 4)
    run = dict(n_max=200, samp_size=100, alpha_geweke=0.9)
    before = rng.chunk_draws_lanes.launches
    both = multi_chain_metropolis(lp, starts, keys,
                                  make_mesh(devices=["cuda:0", "cpu"]), **run)
    assert rng.chunk_draws_lanes.launches > before
    alone = (multi_chain_metropolis(lp, starts[:2], keys[:2],
                                    make_mesh(devices=["cuda:0"]), **run),
             multi_chain_metropolis(lp.to("cpu"), starts[2:].cpu(),
                                    keys[2:].cpu(),
                                    make_mesh(devices=["cpu"]), **run))
    for sl, ref in ((slice(0, 2), alone[0]), (slice(2, 4), alone[1])):
        for f in ("samples", "betas", "logposts"):
            assert torch.equal(getattr(both, f)[sl].cpu(),
                               getattr(ref, f).cpu())
        for f in ("n_recorded", "n_proposals", "n_accepted", "pvalue"):
            np.testing.assert_array_equal(getattr(both, f)[sl],
                                          getattr(ref, f))


@pytest.mark.parametrize("jitter", [1e-4, 1e-6])
def test_predictive_moments_inv_matmul_on_the_card(cuda, jitter):
    """`solve_mode="inv_matmul"` on the card against "trsm" within JAX's
    own tolerances (1e-8 on means, 1e-12 on variances), and against the
    CPU's inv_matmul within 1e-10 at jitter 1e-4; at JAX's test's 1e-6 the
    factors of the two devices part by conditioning-amplified roundoff
    (1.1e-9 on the means on an H100, where JAX's two modes part
    by 1.2e-9), so there within JAX's tolerances."""
    from ccgp_tpu_torch.predict.factors import build_factors
    from ccgp_tpu_torch.predict.posterior import predictive_moments

    g = np.random.default_rng(0)
    spec = MixtureSpec(kernels.sqexp_family(), kernels.sqexp_family(), dim=2)
    arrays = (g.uniform(size=(18, 2)), g.normal(size=18),
              g.uniform(size=(11, 2)), 0.3 * g.normal(size=(9, 3)),
              0.1 * g.normal(size=9))
    out = {}
    for dev in (cuda, "cpu"):
        x, y, xt, zs, betas = (torch.tensor(a, device=dev) for a in arrays)
        cache = build_factors(spec, x, y, zs, betas, jitter=jitter)
        out[str(dev)] = [predictive_moments(spec, cache, x, xt, 0.8,
                                            solve_mode=m)
                         for m in ("trsm", "inv_matmul")]
    (gt, gi), (_, ci) = out["cuda"], out["cpu"]
    assert float(torch.max(torch.abs(gt[0] - gi[0]))) <= 1e-8
    assert float(torch.max(torch.abs(gt[1] - gi[1]))) <= 1e-12
    if jitter == 1e-4:
        for a, b in zip(gi, ci):
            assert _rel(a, b) <= 1e-10
    else:
        assert float(torch.max(torch.abs(gi[0].cpu() - ci[0]))) <= 1e-8
        assert float(torch.max(torch.abs(gi[1].cpu() - ci[1]))) <= 1e-12


def test_sharded_design_sweep_one_design_on_a_repeated_card(cuda):
    """JAX's contract, a fit of one design, on cuda:0 x 2: the designs one
    by one, stacked and gathered."""
    from ccgp_tpu_torch.models.likelihood import make_logpost
    from ccgp_tpu_torch.parallel import make_mesh, sharded_design_sweep

    spec = MixtureSpec(kernels.sqexp_family(), kernels.sqexp_family(), dim=2)
    designs = torch.tensor(np.random.default_rng(1).uniform(size=(5, 9, 2)),
                           device=cuda)
    keys = rng.split(rng.PRNGKey(0, device=cuda), 5)

    def fit_one(d, k):
        lp = make_logpost(spec, d, torch.sin(5.0 * d[:, 0]), 0.5,
                          theta1_prior=InverseGamma(3, 2),
                          theta2_prior=InverseGamma(5, 16), jitter=1e-5)
        return lp(0.1 * rng.normal(k, (3,), d.dtype)).val

    got = sharded_design_sweep(fit_one, designs, keys,
                               make_mesh(devices=["cuda:0"] * 2))
    assert got.shape == (5,) and got.device.type == "cuda"
    assert torch.equal(got, torch.stack([fit_one(d, k)
                                         for d, k in zip(designs, keys)]))


# ---------------------------------------------------------------------------
# the tracer on the profiler's clock
# ---------------------------------------------------------------------------

def _trace_fit(device):
    from ccgp_tpu_torch.models.combined_gp import (
        MCMCConfig, fit_combined_gp, predict_combined_gp)

    r = np.random.default_rng(0)
    x = r.uniform(size=(20, 2))
    y = np.sin(5 * x[:, 0]) + np.cos(3 * x[:, 1])
    u = np.linspace(0, 1, 6)
    grid = np.stack(np.meshgrid(u, u), -1).reshape(-1, 2)
    t = lambda a: torch.tensor(a, dtype=torch.float64, device=device)  # noqa: E731
    spec = MixtureSpec(kernels.sqexp_family(), kernels.sqexp_family(), dim=2,
                       rough="tied", anisotropic=True)
    kf, kp = rng.split(rng.PRNGKey(1, device=device), 2)
    fit = fit_combined_gp(spec, t(x), t(y), kf, mcmc=MCMCConfig(
        start=(1.0, 1.0, 0.0, 0.0), n_max=400, samp_size=120,
        net_samp_size=120, speculative=4), theta1_prior=LogNormal(-1, 1),
        theta2_prior=InverseGamma(3, 4), jitter=1e-6, device=device)
    return fit, predict_combined_gp(spec, fit, t(x), t(grid), kp,
                                    device=device)


def test_trace_spans_on_the_profilers_clock(cuda):
    """A fit and its predict on the card under torch.profiler at trace
    level 2: every span path of their records appears as a `span:` range,
    and the timeline entries, moved to the profiler's Unix clock by
    `unix_offset_ns`, agree with their ranges. A span stamps its start
    after its record_function has entered and its end before it exits, so
    on one clock every entry lies inside its range: each start no more
    than 5 us before its range's, each end no more than 5 us after. The
    median start and end sit within 25 us (the record_function's own enter
    and exit, ~10 us on an H100 machine). A clock offset or a drift over
    the fit of ~8 us would put entries outside their ranges. How far
    inside an entry sits is the profiler's own bookkeeping, not the clock:
    on the card 1-7% of ~750 entries a run sit 50-115 us inside, all on
    the inner side, with the profiler recording CPU activity alone too."""
    import gc
    import statistics

    from torch.profiler import ProfilerActivity, profile

    from ccgp_tpu_torch.utils import trace

    _trace_fit(cuda)                     # kernels loaded, caches warm
    torch.cuda.synchronize()
    trace.set_level(2)
    trace.clear()
    gc.collect()
    gc.disable()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(3):           # the profiler's first ranges
                with torch.profiler.record_function("warm-up"):
                    torch.cuda.synchronize()
            _trace_fit(cuda)
            torch.cuda.synchronize()
        offset = trace.unix_offset_ns()
        recs, timeline = trace.requests(), trace.timeline()
    finally:
        gc.enable()
        trace.set_level(1)
        trace.clear()
    assert [r["name"] for r in recs] == ["fit", "predict"]
    f = recs[0]
    assert f["counts"]["sampler/chunk/readback"]["readbacks"] == \
        f["spans"]["sampler/chunk"][0]
    assert {"plugin/bfgs/readback", "laplace/bfgs/readback",
            "sampler/geweke/readback"} <= set(f["spans"])
    base = prof.profiler.kineto_results.trace_start_ns()
    ranges = {}
    for e in prof.events():
        if (e.name.startswith("span:")
                and e.device_type == torch.autograd.DeviceType.CPU):
            ranges.setdefault(e.name[5:], []).append(
                (base + 1000 * e.time_range.start,
                 base + 1000 * e.time_range.end))
    labels = {"fit", "predict"} | set(f["spans"]) | set(recs[1]["spans"])
    assert labels <= set(ranges), labels - set(ranges)
    entries = {}
    for e in timeline:
        entries.setdefault(e["path"], []).append(
            (e["start_ns"] + offset, e["end_ns"] + offset))
    assert set(entries) == labels
    starts, ends, labels_of = [], [], []
    for label, ents in entries.items():
        got = sorted(ranges[label])
        assert len(got) == len(ents), label
        for (s, t), (rs, rt) in zip(sorted(ents), got):
            starts.append(s - rs)
            ends.append(t - rt)
            labels_of.append(label)
    assert abs(statistics.median(starts)) <= 25_000
    assert abs(statistics.median(ends)) <= 25_000
    outside = [(a, b, label) for a, b, label in zip(starts, ends, labels_of)
               if a < -5_000 or b > 5_000]
    assert not outside, outside[:10]

"""The port's counter-based threefry RNG (`ccgp_tpu_torch.ops.rng`) against
`jax.random` (jax_threefry_partitionable, the jax 0.9 default) and the
Pallas split-chain kernel in interpret mode; `permutation` and the Latin
hypercube designs built on it (`ccgp_tpu_torch.design.lhs`).

Keys, bits, permutations and designs: integer (bit) equality. Uniforms on [0, 1): exact equality (the
same mantissa construction). Normals: <= 1e-12 absolute (erfinv is computed by
torch and by XLA with different approximations).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccgp_tpu.design import lhs as jlhs
from ccgp_tpu.ops.pallas_rng import threefry_split_chain as jax_chain
from ccgp_tpu_torch.design import lhs
from ccgp_tpu_torch.ops import rng

SEEDS = [0, 7, 123456789, 2**40 + 5]


def as_i64(a):
    return np.asarray(a).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey_and_split(seed):
    kj = jax.random.PRNGKey(seed)
    kt = rng.PRNGKey(seed, device="cpu")
    np.testing.assert_array_equal(kt.numpy(), as_i64(kj))
    for num in (2, 3, 5):
        np.testing.assert_array_equal(rng.split(kt, num).numpy(),
                                      as_i64(jax.random.split(kj, num)))


@pytest.mark.parametrize("seed", SEEDS)
def test_random_bits(seed):
    kj, kt = jax.random.PRNGKey(seed), rng.PRNGKey(seed, device="cpu")
    np.testing.assert_array_equal(
        rng.random_bits(kt, 32, (3, 5)).numpy(),
        as_i64(jax.random.bits(kj, (3, 5), jnp.uint32)))
    np.testing.assert_array_equal(
        rng.random_bits(kt, 64, (7,)).numpy(),
        np.asarray(jax.random.bits(kj, (7,), jnp.uint64)).view(np.int64))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_and_normal(seed, dtype):
    kj, kt = jax.random.PRNGKey(seed), rng.PRNGKey(seed, device="cpu")
    tdt = getattr(torch, dtype)
    uj = jax.random.uniform(kj, (4, 6), dtype=dtype)
    np.testing.assert_array_equal(rng.uniform(kt, (4, 6), tdt).numpy(),
                                  np.asarray(uj))
    # a scaled range: XLA contracts the scale-and-shift into one fused
    # multiply-add on the CPU, so the two agree to one ulp
    uj = jax.random.uniform(kj, (9,), dtype=dtype, minval=-1.5, maxval=2.0)
    np.testing.assert_allclose(
        rng.uniform(kt, (9,), tdt, -1.5, 2.0).numpy(), np.asarray(uj),
        rtol=0, atol=2.0 * np.finfo(dtype).eps * 2.0)
    nj = np.asarray(jax.random.normal(kj, (4, 4), dtype=dtype))
    nt = rng.normal(kt, (4, 4), tdt).numpy()
    tol = 1e-12 if dtype == "float64" else 1e-6
    np.testing.assert_allclose(nt, nj, rtol=0, atol=tol)


def test_batched_keys_match_vmap():
    """A batch of keys generates what vmap over the keys generates: the
    chunk RNG of the Metropolis driver."""
    ks = jax.random.split(jax.random.PRNGKey(3), 6)
    kt = torch.from_numpy(as_i64(ks))
    nj = jax.vmap(lambda k: jax.random.normal(k, (4, 4), jnp.float64))(ks)
    np.testing.assert_allclose(rng.normal(kt, (4, 4), torch.float64).numpy(),
                               np.asarray(nj), rtol=0, atol=1e-12)
    uj = jax.vmap(lambda k: jnp.log(jax.random.uniform(k, (4,),
                                                       dtype=jnp.float64)))(ks)
    np.testing.assert_array_equal(
        torch.log(rng.uniform(kt, (4,), torch.float64)).numpy(),
        np.asarray(uj))


def scan_reference(key, rr):
    def step(k, _):
        k, k1, k2 = jax.random.split(k, 3)
        return k, (k1, k2)

    key, (k1s, k2s) = jax.lax.scan(step, key, None, length=rr)
    return key, k1s, k2s


@pytest.mark.parametrize("rr", [1, 7, 20, 24, 25, 120])
@pytest.mark.parametrize("seed", [0, 7, 123456789])
def test_split_chain_matches_jax(rr, seed):
    """The wrapper on a CPU key (its plain version) against the scan of
    jax.random.split and the Pallas kernel in interpret mode."""
    key = jax.random.PRNGKey(seed)
    new_t, k1_t, k2_t = rng.threefry_split_chain(
        rng.PRNGKey(seed, device="cpu"), rr)
    ref = scan_reference(key, rr)
    pal = jax_chain(key, rr, interpret=True)
    for got, r, p in zip((new_t, k1_t, k2_t), ref, pal):
        np.testing.assert_array_equal(got.numpy(), as_i64(r))
        np.testing.assert_array_equal(got.numpy(), as_i64(p))


def test_split_chain_chains_across_calls():
    key = rng.PRNGKey(42, device="cpu")
    k = key
    k1s = []
    for _ in range(2):
        k, a, _ = rng.threefry_split_chain(k, 20)
        k1s.append(a)
    ref_key, ref_k1s, _ = scan_reference(jax.random.PRNGKey(42), 40)
    np.testing.assert_array_equal(torch.cat(k1s).numpy(), as_i64(ref_k1s))
    np.testing.assert_array_equal(k.numpy(), as_i64(ref_key))


def test_split_chain_rejects_bad_inputs():
    with pytest.raises(ValueError):
        rng.threefry_split_chain(torch.zeros(4, dtype=torch.int64), 5)
    with pytest.raises(ValueError):
        rng.threefry_split_chain(torch.zeros(2, dtype=torch.int32), 5)
    with pytest.raises(ValueError):
        rng.threefry_split_chain(rng.PRNGKey(0, device="cpu"), 0)
    # a tensor on another device is refused, never silently computed
    with pytest.raises(ValueError):
        rng.threefry_split_chain(rng.PRNGKey(0, device="cpu").to("meta"), 3)


def test_cpu_keys_never_launch_the_kernel():
    before = rng.threefry_split_chain.launches
    rng.threefry_split_chain(rng.PRNGKey(1, device="cpu"), 20)
    assert rng.threefry_split_chain.launches == before


@pytest.mark.parametrize("n", [1, 8, 14, 505, 70000])   # 70000: two rounds
@pytest.mark.parametrize("seed", [0, 123456789])
def test_permutation_of_a_range(seed, n):
    got = rng.permutation(rng.PRNGKey(seed, device="cpu"), n)
    ref = jax.random.permutation(jax.random.PRNGKey(seed), n)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), as_i64(ref))


def test_permutation_of_a_tensor():
    base = (np.arange(505) + 0.5) / 505
    got = rng.permutation(rng.PRNGKey(5, device="cpu"), torch.tensor(base))
    ref = jax.random.permutation(jax.random.PRNGKey(5), jnp.asarray(base))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    with pytest.raises(ValueError):
        rng.permutation(rng.PRNGKey(5, device="cpu"), torch.zeros(2, 2))


@pytest.mark.parametrize("n,d", [(8, 1), (14, 2), (30, 5)])
def test_random_and_maximin_lhs(n, d):
    kj, kt = jax.random.PRNGKey(n + d), rng.PRNGKey(n + d, device="cpu")
    np.testing.assert_array_equal(lhs.random_lhs(kt, n, d).numpy(),
                                  np.asarray(jlhs.random_lhs(kj, n, d)))
    np.testing.assert_array_equal(
        lhs.maximin_lhs(kt, n, d, n_candidates=8).numpy(),
        np.asarray(jlhs.maximin_lhs(kj, n, d, n_candidates=8)))
    f32 = lhs.random_lhs(kt, n, d, dtype=torch.float32)
    np.testing.assert_array_equal(
        f32.numpy(), np.asarray(jlhs.random_lhs(kj, n, d, jnp.float32)))

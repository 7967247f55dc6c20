"""Counter-based threefry-2x32 RNG, bit-compatible with `jax.random`
(port of `ccgp_tpu/ops/pallas_rng.py` plus the parts of `jax.random` the
sampler and predict use).

Keys are int64 tensors whose last axis holds two uint32 words (k0, k1);
uint32 arithmetic is emulated in int64 and masked after every add and
left shift. The layouts are those of jax 0.9 with
`jax_threefry_partitionable=True` (its default):

  PRNGKey(seed)          (seed >> 32, seed & 0xFFFFFFFF)
  split(key, num)        child i = threefry(key, x0=0, x1=i)
  fold_in(key, data)     threefry(key, x0=0, x1=data)
  random_bits(key, 32)   bits1 ^ bits2 over the flat iota of the shape
  random_bits(key, 64)   (bits1 << 32) | bits2
  uniform / normal       mantissa fill, then sqrt(2) * erfinv
  permutation(key, x)    ceil(3 ln(size) / ln(2**32 - 1)) rounds, each a
                         split and a stable sort by 32 random bits

`threefry_split_chain` runs rr sequential `key, k1, k2 = split(key, 3)`
steps. `chunk_draws` runs the same steps and makes each round's draws from
them, `normal(k1, (K, dim))` and `log(uniform(k2, (K,)))`: the whole random
stream of the Metropolis drivers, a chunk (or one round) per call. On a
CUDA tensor each launches its kernel in `csrc/threefry_split_chain.cu`; on
a CPU tensor it runs the plain version below.
"""
from __future__ import annotations

import math

import torch

from ccgp_tpu_torch.ops import _build
from ccgp_tpu_torch.utils.device import resolve

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
# key-schedule injections after each 4-round group: (ks index for x0,
# ks index for x1, round-group counter added to x1)
_INJ = ((1, 2, 1), (2, 0, 2), (0, 1, 3), (1, 2, 4), (2, 0, 5))
_PARITY = 0x1BD11BDA


def threefry2x32(k0, k1, x0, x1):
    """The 20 threefry-2x32 rounds plus key schedule, elementwise on
    broadcastable int64 tensors holding uint32 values."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for g, (a, b, c) in enumerate(_INJ):
        for r in _ROT[g % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) & _M32) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[a]) & _M32
        x1 = (x1 + ks[b] + c) & _M32
    return x0, x1


def PRNGKey(seed: int, device="cuda") -> torch.Tensor:
    """jax.random.PRNGKey(seed) as an int64 (2,) tensor, on the GPU unless
    device="cpu" is asked for (see `utils.device`)."""
    seed = int(seed) & ((1 << 64) - 1)
    return torch.tensor([seed >> 32, seed & _M32], dtype=torch.int64,
                        device=resolve(device))


def _counts(shape, device):
    """The flat uint64 iota over `shape` as (high words, low words), JAX's
    `iota_2x32_shape`: threefry's counter is 64 bits wide (JAX refuses
    only arrays of more than 2**64 elements)."""
    iota = torch.arange(math.prod(shape), dtype=torch.int64,
                        device=device).reshape(shape)
    return iota >> 32, iota & _M32


def _hash(key: torch.Tensor, shape):
    """(bits1, bits2) of shape key.shape[:-1] + shape."""
    lead = key.shape[:-1]
    pad = (1,) * len(shape)
    k0 = key[..., 0].reshape(lead + pad)
    k1 = key[..., 1].reshape(lead + pad)
    x0, x1 = _counts(shape, key.device)
    return threefry2x32(k0, k1, x0, x1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """jax.random.split: key (..., 2) -> (..., num, 2)."""
    b1, b2 = _hash(key, (num,))
    return torch.stack([b1, b2], dim=-1)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """jax.random.fold_in: key (..., 2) and a uint32 `data` -> (..., 2).
    JAX seeds threefry with `threefry_seed(data)` = (0, data) and hashes
    it under the key."""
    data = int(data)
    if not 0 <= data <= _M32:
        raise ValueError(f"fold_in takes a uint32, got {data}")
    x1 = torch.full(key.shape[:-1], data, dtype=torch.int64,
                    device=key.device)
    b1, b2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(x1), x1)
    return torch.stack([b1, b2], dim=-1)


def random_bits(key: torch.Tensor, bit_width: int, shape) -> torch.Tensor:
    """Uniform bits of width 32 or 64 as int64 (64-bit words may be
    negative: the int64 holds the uint64 bit pattern)."""
    shape = tuple(int(s) for s in shape)
    b1, b2 = _hash(key, shape)
    if bit_width == 32:
        return b1 ^ b2
    if bit_width == 64:
        return (b1 << 32) | b2
    raise ValueError(f"bit_width must be 32 or 64, got {bit_width}")


def _unit_floats(key: torch.Tensor, shape, dtype) -> torch.Tensor:
    """Floats in [0, 1): the random mantissa under exponent 0, minus 1."""
    if dtype == torch.float32:
        bits = random_bits(key, 32, shape)
        fb = ((bits >> 9) | 0x3F800000).to(torch.int32)
        return fb.view(torch.float32) - 1.0
    if dtype == torch.float64:
        b1, b2 = _hash(key, tuple(int(s) for s in shape))
        fb = (b1 << 20) | (b2 >> 12) | 0x3FF0000000000000
        return fb.view(torch.float64) - 1.0
    raise TypeError(f"uniform supports float32 and float64, got {dtype}")


def uniform(key: torch.Tensor, shape=(), dtype=torch.float64,
            minval=0.0, maxval=1.0) -> torch.Tensor:
    """jax.random.uniform: key (..., 2) -> (..., *shape)."""
    dev = key.device
    lo = torch.tensor(minval, dtype=dtype, device=dev)
    hi = torch.tensor(maxval, dtype=dtype, device=dev)
    floats = _unit_floats(key, shape, dtype)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def normal(key: torch.Tensor, shape=(), dtype=torch.float64) -> torch.Tensor:
    """jax.random.normal: sqrt(2) * erfinv(u), u uniform on (-1, 1)."""
    lo = math.nextafter(-1.0, 0.0) if dtype == torch.float64 else float(
        torch.nextafter(torch.tensor(-1.0, dtype=dtype),
                        torch.tensor(0.0, dtype=dtype)))
    u = uniform(key, shape, dtype, lo, 1.0)
    sqrt2 = torch.tensor(math.sqrt(2.0), dtype=dtype, device=key.device)
    return sqrt2 * torch.special.erfinv(u)


def permutation(key: torch.Tensor, x) -> torch.Tensor:
    """jax.random.permutation: x an int n (a shuffled arange(n), int64) or a
    1-D tensor (its entries shuffled). JAX 0.9's sort-based `_shuffle`:
    each round splits the key and sorts stably by `random_bits(subkey,
    32)`, the uint32 words held in int64."""
    if isinstance(x, torch.Tensor) and x.ndim:
        if x.ndim != 1:
            raise ValueError("permutation shuffles an int or a 1-D tensor")
        x = x.to(key.device)
    else:
        x = torch.arange(int(x), dtype=torch.int64, device=key.device)
    size = x.shape[0]
    rounds = math.ceil(3 * math.log(max(1, size)) / math.log(_M32))
    for _ in range(rounds):
        key, subkey = split(key)
        order = torch.sort(random_bits(subkey, 32, (size,)), stable=True)[1]
        x = x[order]
    return x


# ---------------------------------------------------------------------------
# the per-chunk key chain (replaces the Pallas kernel in pallas_rng.py)
# ---------------------------------------------------------------------------

def _check_key(key: torch.Tensor) -> None:
    if key.shape != (2,) or key.dtype != torch.int64:
        raise ValueError("threefry_split_chain needs an int64 (2,) key")


def split_chain_supported(key) -> bool:
    """True when `threefry_split_chain` and `chunk_draws` reproduce a scan
    of `split(key, 3)` bit for bit: a (2,) int64 tensor whose words are
    uint32 values. The port has one split layout, JAX's partitionable one,
    which is what JAX's own check also asks of its configuration."""
    return (isinstance(key, torch.Tensor) and key.dtype == torch.int64
            and tuple(key.shape) == (2,)
            and bool(torch.all((key >= 0) & (key <= _M32))))


def threefry_split_chain_plain(key: torch.Tensor, rr: int):
    """rr sequential `key, k1, k2 = split(key, 3)` steps in plain PyTorch.
    Returns (new_key (2,), k1s (rr, 2), k2s (rr, 2))."""
    k1s, k2s = [], []
    for _ in range(rr):
        ch = split(key, 3)
        key = ch[0]
        k1s.append(ch[1])
        k2s.append(ch[2])
    return key, torch.stack(k1s), torch.stack(k2s)


def threefry_split_chain(key: torch.Tensor, rr: int):
    """rr sequential splits as ONE launch of `csrc/threefry_split_chain.cu`
    on a CUDA key; the plain version on a CPU key. Bit-identical either
    way (integer equality with `jax.random.split`)."""
    _check_key(key)
    rr = int(rr)
    if rr < 1:
        raise ValueError("rr must be >= 1")
    if key.device.type == "cpu":
        return threefry_split_chain_plain(key, rr)
    if key.device.type != "cuda":
        raise ValueError(f"unsupported device {key.device}")
    key = key.contiguous()
    new_key = torch.empty(2, dtype=torch.int64, device=key.device)
    k1s = torch.empty((rr, 2), dtype=torch.int64, device=key.device)
    k2s = torch.empty((rr, 2), dtype=torch.int64, device=key.device)
    lib = _build.library()
    _build.count(threefry_split_chain)
    _build.check(lib.ccgp_threefry_split_chain(
        _build.ptr(key), _build.ptr(new_key), _build.ptr(k1s),
        _build.ptr(k2s), rr, _build.stream(key.device)),
        "threefry_split_chain")
    return new_key, k1s, k2s


threefry_split_chain.launches = 0


# ---------------------------------------------------------------------------
# a chunk's keys and draws: the sampler's random stream in one launch
# ---------------------------------------------------------------------------

_DRAW_DTYPES = (torch.float32, torch.float64)
_INT_MAX = (1 << 31) - 1


def _check_sizes(K: int, dim: int) -> None:
    """The kernel takes K and dim as C ints; it indexes a key segment's
    draws in 64 bits, so K dim is bounded by memory alone."""
    if K > _INT_MAX or dim > _INT_MAX:
        raise ValueError(f"K and dim must be below 2**31, got {K} and {dim}")


def chunk_draws_plain(key: torch.Tensor, rr: int, K: int, dim: int,
                      dtype=torch.float64):
    """rr rounds of the Metropolis drivers' random stream in plain PyTorch:
    `key, k1, k2 = split(key, 3)` per round, then the round's proposal
    normals `normal(k1, (K, dim))` and log-uniforms `log(uniform(k2,
    (K,)))`. Returns (new_key (2,), eps (rr, K, dim), log_u (rr, K))."""
    key, k1s, k2s = threefry_split_chain_plain(key, rr)
    eps = normal(k1s, (K, dim), dtype)
    log_u = torch.log(uniform(k2s, (K,), dtype))
    return key, eps, log_u


def chunk_draws(key: torch.Tensor, rr: int, K: int, dim: int,
                dtype=torch.float64):
    """`chunk_draws_plain` as ONE launch of `csrc/threefry_split_chain.cu`
    on a CUDA key (bit-equal to the plain version on the card); the plain
    version on a CPU key."""
    _check_key(key)
    rr, K, dim = int(rr), int(K), int(dim)
    if rr < 1 or K < 1 or dim < 1:
        raise ValueError("rr, K and dim must be >= 1")
    _check_sizes(K, dim)
    if dtype not in _DRAW_DTYPES:
        raise TypeError(f"chunk_draws makes float32 or float64, got {dtype}")
    if key.device.type == "cpu":
        return chunk_draws_plain(key, rr, K, dim, dtype)
    if key.device.type != "cuda":
        raise ValueError(f"unsupported device {key.device}")
    key = key.contiguous()
    new_key = torch.empty(2, dtype=torch.int64, device=key.device)
    eps = torch.empty((rr, K, dim), dtype=dtype, device=key.device)
    log_u = torch.empty((rr, K), dtype=dtype, device=key.device)
    lib = _build.library()
    fn = (lib.ccgp_chunk_draws_f32 if dtype == torch.float32
          else lib.ccgp_chunk_draws_f64)
    _build.count(chunk_draws)
    _build.check(fn(_build.ptr(key), _build.ptr(new_key), _build.ptr(eps),
                    _build.ptr(log_u), rr, K, dim,
                    _build.stream(key.device)), "chunk_draws")
    return new_key, eps, log_u


chunk_draws.launches = 0


def _check_lanes(keys: torch.Tensor) -> None:
    if keys.ndim != 2 or keys.shape[1] != 2 or keys.dtype != torch.int64:
        raise ValueError("chunk_draws_lanes needs int64 (L, 2) keys")
    if keys.shape[0] < 1:
        raise ValueError("chunk_draws_lanes needs at least one lane")


def chunk_draws_lanes_plain(keys: torch.Tensor, rr: int, K: int, dim: int,
                            dtype=torch.float64):
    """`chunk_draws_plain` over L keys (L, 2): returns (new_keys (L, 2), eps
    (L, rr, K, dim), log_u (L, rr, K)). The key chains run side by side
    (integer arithmetic, exact); each lane's draws are made by the same
    calls, at the same shapes, as its own `chunk_draws_plain`, so lane l
    is bit-equal to `chunk_draws_plain(keys[l], ...)`."""
    rr = int(rr)
    k1s, k2s = [], []
    for _ in range(rr):
        ch = split(keys, 3)                    # (L, 3, 2)
        keys = ch[:, 0]
        k1s.append(ch[:, 1])
        k2s.append(ch[:, 2])
    k1s, k2s = torch.stack(k1s, 1), torch.stack(k2s, 1)   # (L, rr, 2)
    eps = torch.stack([normal(k1, (K, dim), dtype) for k1 in k1s])
    log_u = torch.stack([torch.log(uniform(k2, (K,), dtype)) for k2 in k2s])
    return keys, eps, log_u


def chunk_draws_lanes(keys: torch.Tensor, rr: int, K: int, dim: int,
                      dtype=torch.float64):
    """`chunk_draws_lanes_plain` as ONE launch of
    `csrc/threefry_split_chain.cu` for all L lanes on CUDA keys (a block
    per lane, bit-equal to L single `chunk_draws` launches); the plain
    version on CPU keys."""
    _check_lanes(keys)
    rr, K, dim = int(rr), int(K), int(dim)
    if rr < 1 or K < 1 or dim < 1:
        raise ValueError("rr, K and dim must be >= 1")
    _check_sizes(K, dim)
    if dtype not in _DRAW_DTYPES:
        raise TypeError(f"chunk_draws_lanes makes float32 or float64, got "
                        f"{dtype}")
    if keys.device.type == "cpu":
        return chunk_draws_lanes_plain(keys, rr, K, dim, dtype)
    if keys.device.type != "cuda":
        raise ValueError(f"unsupported device {keys.device}")
    keys = keys.contiguous()
    lanes = keys.shape[0]
    new_keys = torch.empty_like(keys)
    eps = torch.empty((lanes, rr, K, dim), dtype=dtype, device=keys.device)
    log_u = torch.empty((lanes, rr, K), dtype=dtype, device=keys.device)
    lib = _build.library()
    fn = (lib.ccgp_chunk_draws_lanes_f32 if dtype == torch.float32
          else lib.ccgp_chunk_draws_lanes_f64)
    _build.count(chunk_draws_lanes)
    _build.check(fn(_build.ptr(keys), _build.ptr(new_keys), _build.ptr(eps),
                    _build.ptr(log_u), lanes, rr, K, dim,
                    _build.stream(keys.device)), "chunk_draws_lanes")
    return new_keys, eps, log_u


chunk_draws_lanes.launches = 0

"""A frozen copy of the threefry-2x32 stream of `jax.random` in plain
PyTorch, for the benchmark's own keys and for the reference's normal
draws. It imports nothing of the measured package, so a change there
cannot move the yardstick.

Keys are int64 tensors whose last axis holds two uint32 words (k0, k1);
uint32 arithmetic is emulated in int64 and masked after every add and
left shift (`jax_threefry_partitionable=True` layouts):

  prng_key(seed)        (seed >> 32, seed & 0xFFFFFFFF)
  fold_in(key, data)    threefry(key, x0=0, x1=data)
  split(key, num)       child i = threefry(key, x0=0, x1=i)
  uniform(key, shape)   the mantissa fill of [0, 1)
  normal(key, shape)    sqrt(2) * erfinv(u), u on (-1, 1) by mantissa fill
  round_draws(key, R, K, dim)
                        the Metropolis chain's stream: per round
                        `key, k1, k2 = split(key, 3)`, K proposal normals
                        of k1 and K log-uniforms of k2
"""
from __future__ import annotations

import math

import torch

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_INJ = ((1, 2, 1), (2, 0, 2), (0, 1, 3), (1, 2, 4), (2, 0, 5))
_PARITY = 0x1BD11BDA


def threefry2x32(k0, k1, x0, x1):
    """The 20 rounds and key schedule, elementwise on int64 tensors."""
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


def prng_key(seed: int, device="cpu") -> torch.Tensor:
    seed = int(seed) & ((1 << 64) - 1)
    return torch.tensor([seed >> 32, seed & _M32], dtype=torch.int64,
                        device=device)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    data = int(data)
    if not 0 <= data <= _M32:
        raise ValueError(f"fold_in takes a uint32, got {data}")
    x1 = torch.full(key.shape[:-1], data, dtype=torch.int64,
                    device=key.device)
    b1, b2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(x1), x1)
    return torch.stack([b1, b2], dim=-1)


def _hash(key: torch.Tensor, shape):
    n = math.prod(shape)
    iota = torch.arange(n, dtype=torch.int64, device=key.device)
    iota = iota.reshape(shape)
    pad = (1,) * len(shape)
    k0 = key[..., 0].reshape(key.shape[:-1] + pad)
    k1 = key[..., 1].reshape(key.shape[:-1] + pad)
    return threefry2x32(k0, k1, iota >> 32, iota & _M32)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    b1, b2 = _hash(key, (num,))
    return torch.stack([b1, b2], dim=-1)


def _unit_floats(key: torch.Tensor, shape, dtype) -> torch.Tensor:
    """Floats in [0, 1): a random mantissa under exponent 0, minus 1."""
    shape = tuple(int(s) for s in shape)
    b1, b2 = _hash(key, shape)
    if dtype == torch.float32:
        fb = (((b1 ^ b2) >> 9) | 0x3F800000).to(torch.int32)
        return fb.view(torch.float32) - 1.0
    if dtype == torch.float64:
        fb = (b1 << 20) | (b2 >> 12) | 0x3FF0000000000000
        return fb.view(torch.float64) - 1.0
    raise TypeError(f"float32 and float64 only, got {dtype}")


def uniform(key: torch.Tensor, shape, dtype) -> torch.Tensor:
    """Uniforms on [0, 1) of `shape` in `dtype`, as `jax.random.uniform`."""
    return torch.clamp_min(_unit_floats(key, shape, dtype), 0.0)


def normal(key: torch.Tensor, shape, dtype) -> torch.Tensor:
    """Standard normals of `shape` in `dtype`, as `jax.random.normal`."""
    lo = torch.nextafter(torch.tensor(-1.0, dtype=dtype),
                         torch.tensor(0.0, dtype=dtype)).to(key.device)
    hi = torch.tensor(1.0, dtype=dtype, device=key.device)
    u = torch.maximum(lo, _unit_floats(key, shape, dtype) * (hi - lo) + lo)
    sqrt2 = torch.tensor(math.sqrt(2.0), dtype=dtype, device=key.device)
    return sqrt2 * torch.special.erfinv(u)


def round_keys(key: torch.Tensor, rounds: int) -> tuple:
    """The k1 and k2 keys (rounds, 2) of `rounds` sequential
    `key, k1, k2 = split(key, 3)` steps, on Python integers (the chain is
    sequential and a tensor call per step would cost more than the hash)."""
    k0, k1 = (int(v) for v in key.tolist())
    a, b = [], []
    for _ in range(int(rounds)):
        kids = [threefry2x32(k0, k1, 0, i) for i in range(3)]
        (k0, k1), ka, kb = kids
        a.append(ka)
        b.append(kb)
    return (torch.tensor(a, dtype=torch.int64, device=key.device),
            torch.tensor(b, dtype=torch.int64, device=key.device))


def round_draws(key: torch.Tensor, rounds: int, K: int, dim: int,
                dtype) -> tuple:
    """A Metropolis chain's stream for its first `rounds` rounds: proposal
    normals (rounds, K, dim) and log-uniforms (rounds, K) in `dtype`."""
    if rounds < 1:
        return (torch.zeros((0, K, dim), dtype=dtype, device=key.device),
                torch.zeros((0, K), dtype=dtype, device=key.device))
    k1s, k2s = round_keys(key, rounds)
    return (normal(k1s, (K, dim), dtype),
            torch.log(uniform(k2s, (K,), dtype)))

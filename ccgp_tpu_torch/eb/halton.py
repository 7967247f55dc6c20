"""Halton quasi-Monte Carlo sequences (port of `ccgp_tpu/eb/halton.py`;
the empirical-Bayes marginal-likelihood nodes of the reference's
`fOptions::runif.halton`). numpy only: the nodes are a host-side
precompute."""
from __future__ import annotations

import numpy as np

_PRIMES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47)


def _vdc(n: int, base: int, start: int = 1) -> np.ndarray:
    """Van der Corput sequence in `base` for indices start..start+n-1."""
    idx = np.arange(start, start + n, dtype=np.int64)
    out = np.zeros(n)
    f = 1.0
    while idx.max() > 0:
        f /= base
        out += f * (idx % base)
        idx //= base
    return out


def halton(n: int, d: int = 1, start: int = 1) -> np.ndarray:
    """(n, d) Halton points in (0, 1)^d; dimension j uses the j-th prime."""
    if d > len(_PRIMES):
        raise ValueError(f"halton supports up to {len(_PRIMES)} dimensions")
    return np.stack([_vdc(n, _PRIMES[j], start) for j in range(d)], axis=1)

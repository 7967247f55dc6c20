"""Peaks of one NVIDIA H100 SXM and the operation and byte counts the
per-layer metrics divide by. Floating-point operations are counted as
FLOPs (a multiply-add is two), from the cell's shapes and the request's
own counters: what these inputs need, not what an implementation runs
beyond that (such as K speculative candidates where the chain used
fewer).

Peaks (NVIDIA's data sheet, dense, at the full 700 W): HBM 3.35 TB/s;
67 TFLOP/s in float32 outside the tensor cores and 67 in float64 on
them (a factorization's and a solve's multiply-adds), elementwise work
(a Gram's distances and exp) at 67 in float32 and 34 in float64.
"""
from __future__ import annotations

HBM_BPS = 3.35e12
PEAK_OPS = {4: 67e12, 8: 67e12}
PEAK_VEC = {4: 67e12, 8: 34e12}


def bound_seconds(nbytes: float, *work) -> float:
    """The least time: bytes over the memory rate against the sum over
    `work`'s (operations, peak rate) pairs."""
    return max(nbytes / HBM_BPS, sum(ops / peak for ops, peak in work))


def gram_flops(n: int, m: int, d: int) -> float:
    """One SE-mixture correlation block of n x m points at d: per entry
    3d for the two scaled distances' differences, squares and sums, and
    6 for the two exponentials, the weights and the normalization."""
    return n * m * (3 * d + 6)


def chol_solve_flops(n: int, rhs: int) -> float:
    """A Cholesky factorization (n^3 / 3) and `rhs` forward solves."""
    return n ** 3 / 3 + rhs * n * n


def k1_bound_seconds(n, d, dim, elem, launches, proposals, rounds,
                     recorded) -> float:
    """The fused rounds kernel (`csrc/mh_rounds.cu`) for the rounds a
    chain ran: per proposal the lower triangle of one mixture Gram, its
    factorization and the solve of [y, 1]; bytes: x and y and the state
    read once per launch, each proposal's step and log-uniform, each
    round's record, and the stash row ((n + 2) x n) of every recorded
    draw written once."""
    nbytes = elem * (launches * (n * d + n + dim + 3)
                     + proposals * (dim + 1) + rounds * (dim + 4)
                     + recorded * (n + 2) * n)
    vec = proposals * gram_flops(n, n, d) * (n + 1) / (2 * n)
    fact = proposals * chol_solve_flops(n, 2)
    return bound_seconds(nbytes, (vec, PEAK_VEC[elem]),
                         (fact, PEAK_OPS[elem]))


def plugin_flops(n: int, d: int, method: str, starts: int) -> float:
    """The plug-in's needs: a grid of 32 and a zoom of 17 rates and the
    final fit ("grid"), or one evaluation per start and the final fit
    ("bfgs"): an isotropic Gram, its factorization and two solves each."""
    evals = (32 + 17 + 1) if method == "grid" else starts + 1
    return evals * (gram_flops(n, n, d) / 2 + chol_solve_flops(n, 2))


def chain_flops(n: int, d: int, proposals: int) -> float:
    """Every proposal's mixture Gram (lower triangle), factorization and
    solve of [y, 1]."""
    return proposals * (gram_flops(n, n, d) * (n + 1) / (2 * n)
                        + chol_solve_flops(n, 2))


def predict_flops(n: int, d: int, draws: int, t: int) -> float:
    """Per draw the (n, t) cross block, its triangular solve (n^2 per
    column) and the three reductions over n (mean, r'R^-1 r, 1'R^-1 r)."""
    return draws * (gram_flops(n, t, d) + n * n * t + 6 * n * t)

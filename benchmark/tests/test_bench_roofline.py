"""Operation and byte counts against hand counts at one shape."""
import pytest

from harness import roofline


def test_k1_bound_hand_count():
    # n = 4, d = 2, dim = 4, f32; 1 launch, 3 proposals, 2 rounds, 1 draw
    n, d, dim, e = 4, 2, 4, 4
    nbytes = e * (1 * (8 + 4 + 4 + 3) + 3 * 5 + 2 * 8 + 1 * 6 * 4)
    vec = 3 * (10 * 12)            # 10 lower-triangle entries, 3d + 6
    fact = 3 * (64 / 3 + 2 * 16)   # n^3 / 3 and two solves
    want = max(nbytes / 3.35e12, vec / 67e12 + fact / 67e12)
    got = roofline.k1_bound_seconds(n, d, dim, e, 1, 3, 2, 1)
    assert got == pytest.approx(want)


def test_f64_elementwise_peak():
    got = roofline.k1_bound_seconds(100, 9, 3, 8, 0, 1, 0, 0)
    want = 5050 * 33 / 34e12 + (1e6 / 3 + 2e4) / 67e12
    assert got == pytest.approx(want)


def test_predict_and_chain_flops():
    # 2 draws, n = 3, d = 2, t = 5: cross 3*5*12, solve 9*5, sums 6*3*5
    assert roofline.predict_flops(3, 2, 2, 5) == 2 * (180 + 45 + 90)
    assert roofline.chain_flops(3, 2, 4) == pytest.approx(
        4 * (6 * 12 + 9 + 18))
    assert roofline.plugin_flops(3, 2, "bfgs", 8) == pytest.approx(
        9 * (4.5 * 12 + 9 + 18))
    assert roofline.plugin_flops(3, 2, "grid", 8) == pytest.approx(
        50 * (4.5 * 12 + 9 + 18))

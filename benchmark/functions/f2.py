"""The 2-D test function of the paper's anisotropic example (the repo's
`f2`): y = ((a - 0.2)^2 - (b - 0.7)^2) exp(-5((a - 0.8)^2 + (b - 0.1)^2))
cos(10 (a - 0.5) b)."""
import numpy as np


def f(xy: np.ndarray) -> np.ndarray:
    a, b = xy[:, 0], xy[:, 1]
    return (((a - 0.2) ** 2 - (b - 0.7) ** 2)
            * np.exp(-5 * ((a - 0.8) ** 2 + (b - 0.1) ** 2))
            * np.cos(10 * (a - 0.5) * b))

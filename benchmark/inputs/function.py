"""Inputs of configurations with "data": "function": design i of seed s
is `n` points uniform on [0, 1]^dim from `default_rng([s, i])`, y the
configuration's test function (`functions/<function>.py`), and the new
points the `lattice`^dim grid."""
import numpy as np

from harness.spec import load_module


def lattice(cfg: dict) -> np.ndarray:
    u = np.linspace(0, 1, cfg["lattice"])
    return np.stack(np.meshgrid(*([u] * cfg["dim"])), -1).reshape(
        -1, cfg["dim"])


def design(cfg: dict, seed: int, i: int):
    """(x, y, new points) as float64 arrays."""
    x = np.random.default_rng([int(seed), int(i)]).uniform(
        size=(cfg["n"], cfg["dim"]))
    return x, load_module("functions", cfg["function"]).f(x), lattice(cfg)

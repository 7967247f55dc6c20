"""The correctness check's common part: the numbers' arithmetic, the
control's precision and the judgement of each number against its limit
(`limits/<workload>.json`). What a system's numbers are is in
`checks/<system>.py`, found by the configuration's "system"."""
from __future__ import annotations

import math

import torch

from reference.combined_gp import Precision


def control_precision(cfg: dict) -> Precision:
    """The nearest precision below the configuration's dtype: float32 for
    float64, TF32 products for float32 (which the program runs with TF32
    off)."""
    if cfg["dtype"] == "float64":
        return Precision(torch.float32)
    if cfg["dtype"] == "float32":
        return Precision(torch.float32, tf32=True)
    raise ValueError(f"no control for dtype {cfg['dtype']!r}")


def largest(t) -> float:
    """The largest entry; inf if any is not finite, 0 for none."""
    t = torch.as_tensor(t).double()
    if t.numel() == 0:
        return 0.0
    if not bool(torch.isfinite(t).all()):
        return math.inf
    return float(t.max())


def gap(a, b, scale) -> float:
    """max |a - b| / scale, elementwise against the reference b."""
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    if a.shape != b.shape:
        return math.inf
    b = b.double()
    return largest(torch.abs(a.double().to(b.device) - b)
                   / torch.as_tensor(scale).double().to(b.device))


def merge(into: dict, numbers: dict) -> None:
    for k, v in numbers.items():
        into[k] = max(into.get(k, 0.0), v)


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): every number at or under
    its limit; a number without a reading or a limit fails."""
    out, ok = {}, bool(numbers)
    for name, lim in limits.items():
        if name.startswith("_"):
            continue
        v = numbers.get(name)
        out[name] = {"value": v, "limit": lim["limit"]}
        if v is None or not v <= lim["limit"]:
            ok = False
    return ok, out

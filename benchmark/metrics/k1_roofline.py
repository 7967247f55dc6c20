"""K1, the fused rounds kernel (`ops.chol_smallk` -> `csrc/mh_rounds.cu`):
the least time for the rounds the profiled requests' chains ran
(`harness.roofline.k1_bound_seconds`) over K1's device time in the
profile, %."""
from harness import roofline
from harness.readers import elem

KERNEL = "mh_rounds_kernel<"


def read(tr):
    p = tr.profile
    if not p or not tr.profiled:
        return None
    secs = sum(v for k, v in p["ops"].items() if KERNEL in k)
    launches = p["launches"].get("k1", 0)
    if secs <= 0 or not launches:
        return None
    cfg = tr.cfg
    dim = cfg["dim"] + 2 if cfg["anisotropic"] else 3
    bound = roofline.k1_bound_seconds(
        cfg["n"], cfg["dim"], dim, elem(cfg), launches,
        sum(r["n_proposals"] for r in tr.profiled),
        sum(r["n_rounds"] for r in tr.profiled),
        sum(r["n_recorded"] for r in tr.profiled))
    return 100.0 * bound / secs

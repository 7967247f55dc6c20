"""CLI: run a reference case study by name on the GPU (port of
`ccgp_tpu/__main__.py`).

    python -m ccgp_tpu_torch <experiment> [--fast] [--seed N] [--cpu]
                             [--f64] [--speculative K] [--designs M]
                             [--mesh N]

Experiments: sim_1d, sim_1d_two_families, sim_2d_iso, sim_2d_aniso,
batch_me_design, ground_vibrations, heat_exchanger, sim_2d_iso_advanced
and sim_2d_sweep. The last five read the reference's files under the
data root, CCGP_DATA_ROOT (`Initial ME Design.txt`, the ground-vibrations
splits, the Qian sets and grid, the maximin design and grid, the
Train_Designs); `chip_smoke.gv_data_root` rebuilds the ground-vibrations
size-50 splits from the repo's tables, and `chip_smoke.standin_data_root`
writes stand-ins for the others. The study runs on the CUDA device
unless --cpu is given (without a GPU it fails rather than fall back);
--f64 runs it in float64 on either device. Prints the RMSPE, coverage and
calibration lines of the JAX CLI (for batch_me_design, those of its
21-point refit, then the second-batch design; for sim_2d_sweep the
per-design medians over its first M designs). --mesh N splits the
sweep's designs over N devices: N CUDA devices (fewer raise, naming the
count), or under --cpu the CPU N times over, as the JAX CLI forces N
virtual host devices.
"""
from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    from ccgp_tpu_torch.experiments import PORTED

    ap = argparse.ArgumentParser(prog="python -m ccgp_tpu_torch",
                                 description=__doc__)
    ap.add_argument("experiment",
                    help=f"one of {', '.join(PORTED)}")
    ap.add_argument("--fast", action="store_true",
                    help="small MCMC budget (smoke-test scale)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the CUDA device")
    ap.add_argument("--f64", action="store_true", help="float64")
    ap.add_argument("--speculative", type=int, default=0, metavar="K",
                    help="evaluate K speculative Metropolis proposals per "
                         "round as one batched factorization: the same "
                         "Markov kernel, fewer sequential rounds")
    ap.add_argument("--mesh", type=int, default=0, metavar="N",
                    help="split the sweep's design axis over an N-device "
                         "mesh (sim_2d_sweep only)")
    ap.add_argument("--designs", type=int, default=0,
                    help="number of Train_Designs to sweep (sim_2d_sweep "
                         "only)")
    args = ap.parse_args(argv)
    if args.experiment not in PORTED:
        print(f"{args.experiment} is not among the ported experiments "
              f"({', '.join(PORTED)}); ROADMAP.md (queue 1) says which are "
              "still to come", file=sys.stderr)
        return 2

    import torch

    from ccgp_tpu_torch import experiments as ex
    from ccgp_tpu_torch.models.combined_gp import MCMCConfig
    from ccgp_tpu_torch.ops import rng

    mod = getattr(ex, args.experiment)
    cfg = mod.Config()
    if args.experiment == "sim_2d_sweep":
        over = {}
        if args.mesh:
            if args.mesh > 1 and not args.cpu:
                from ccgp_tpu_torch.parallel import make_mesh

                make_mesh(args.mesh)   # raises with fewer CUDA devices
            over["mesh_devices"] = args.mesh
        if args.designs:
            over["n_designs"] = args.designs
        cfg = type(cfg)(**{**cfg.__dict__, **over})
    if args.fast:
        base = cfg.mcmc
        cfg = type(cfg)(**{**cfg.__dict__, "mcmc": MCMCConfig(
            start=base.start, n_max=1200, samp_size=300, net_samp_size=200,
            batch_size=base.batch_size, alpha_geweke=base.alpha_geweke,
            record=base.record)})
    if args.speculative > 1:
        cfg = type(cfg)(**{**cfg.__dict__, "mcmc": MCMCConfig(
            **{**cfg.mcmc.__dict__, "speculative": args.speculative})})
    device = "cpu" if args.cpu else "cuda"
    out = mod.run(cfg, key=rng.PRNGKey(args.seed, device=device),
                  dtype=torch.float64 if args.f64 else torch.float32,
                  device=device)
    if hasattr(out, "chain_ok"):
        import numpy as np

        m = len(out.rmspe)
        print(f"sweep over {m} designs (mesh={args.mesh or 1} device(s)):")
        print(f"  RMSPE median {np.median(out.rmspe):.4f}, "
              f"IQR [{np.quantile(out.rmspe, .25):.4f}, "
              f"{np.quantile(out.rmspe, .75):.4f}]")
        print(f"  coverage median {np.median(out.coverage):.3f} | "
              f"calibration mean {out.quant.mean():.3f} | "
              f"healthy chains {int(out.chain_ok.sum())}/{m}")
        return 0
    s = out.study.summary if hasattr(out, "study") else out.summary
    print("RMSPE:     ",
          " | ".join(f"{k} {v:.4f}" for k, v in s.rmspe.items()))
    if s.coverage:
        print("coverage:  ",
              " | ".join(f"{k} {v:.3f}" for k, v in s.coverage.items()))
    if s.average_quantile is not None:
        print(f"calibration quantile: {s.average_quantile:.3f} (ideal 0.5)")
    if hasattr(out, "d_second"):
        import numpy as np

        print("second-batch design:")
        print(np.round(np.asarray(out.d_second), 4))
    return 0


if __name__ == "__main__":
    sys.exit(main())

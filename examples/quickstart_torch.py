"""Quickstart on the PyTorch port: Bayesian optimization with D-BE
acquisition optimization.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

On the card the MAP fit runs the gram kernels (K3/K4) and every MSO round
the posterior kernels (K1/K2); on the CPU their plain versions.
"""
import argparse

import numpy as np

from repro_torch.bo.objectives import make_objective
from repro_torch.bo.sampler import GPSampler
from repro_torch.bo.space import BoxSpace
from repro_torch.core.mso import MsoOptions


def main(argv=None) -> GPSampler:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    D = 5
    obj = make_objective("rastrigin", D, seed=1)
    space = BoxSpace.cube(D, *obj.bounds)

    sampler = GPSampler(
        space,
        strategy="dbe",               # the paper's coroutine D-BE
        n_startup_trials=10,
        n_restarts=10,                # B=10 multi-start (paper setting)
        mso_options=MsoOptions(m=10, maxiter=200, pgtol=1e-2),
        seed=0,
        device=args.device,
    )
    best = sampler.optimize(obj, n_trials=40)
    print(f"best value: {best.y:.4f} at x = {np.round(best.x, 3)}")
    print(f"GP fits: {sampler.stats.n_gp_fits}, "
          f"acqf time: {sampler.stats.acqf_time:.1f}s, "
          f"median L-BFGS-B iters/trial: "
          f"{np.median(sampler.stats.acqf_iters):.1f}")
    return sampler


if __name__ == "__main__":
    main()

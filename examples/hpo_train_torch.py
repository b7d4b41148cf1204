"""End-to-end driver on the PyTorch port: BO (D-BE inside) tunes the
learning rate and weight decay of an LM training run.

    PYTHONPATH=src python examples/hpo_train_torch.py [--device cpu]

Twin of ``examples/hpo_train.py``.  On the card the sampler's MAP fit runs
the gram kernels (K3/K4) and its MSO rounds the posterior kernels (K1/K2),
and every trial trains a reduced LM whose attention is the flash kernel
K6 forward and K7 backward; on the CPU all of them are their plain
versions.  Reduced scale by default; --width/--layers/--steps scale it up.
"""
import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.bo.sampler import GPSampler
from repro_torch.bo.space import BoxSpace
from repro_torch.configs import get_config
from repro_torch.core.mso import MsoOptions
from repro_torch.data.synth import DataConfig, synth_batch
from repro_torch.models import lm
from repro_torch.train.optim import OptimConfig, init_opt_state
from repro_torch.train.step import make_train_step


def make_trial_fn(cfg, dcfg, steps, dev):
    """x = (log10 lr, log10 weight decay) → the final training loss (20.0
    if it is not finite), from the same seeded weights every trial."""
    def trial(x) -> float:
        log_lr, log_wd = float(x[0]), float(x[1])
        opt_cfg = OptimConfig(lr=10.0 ** log_lr,
                              weight_decay=10.0 ** log_wd,
                              warmup_steps=max(steps // 10, 1),
                              total_steps=steps)
        gen = torch.Generator(device=dev).manual_seed(0)
        params = lm.init_params(cfg, gen, stacked=True)
        opt_state = init_opt_state(params, opt_cfg)
        step = make_train_step(cfg, opt_cfg)
        loss = 20.0
        for i in range(steps):
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in synth_batch(cfg, dcfg, i).items()}
            params, opt_state, m = step(params, opt_state, batch)
            loss = float(m["loss"])
            if not np.isfinite(loss):
                return 20.0
        return loss
    return trial


def main(argv=None) -> GPSampler:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--trials", type=int, default=12)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--width", type=int, default=128)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config(args.arch).reduced().replace(
        dtype="float32", d_model=args.width, n_layers=args.layers,
        d_ff=2 * args.width)
    dcfg = DataConfig(global_batch=args.batch, seq_len=args.seq, seed=0)
    trial = make_trial_fn(cfg, dcfg, args.steps, dev)

    space = BoxSpace(np.array([-5.0, -4.0]), np.array([-1.0, -0.5]))
    sampler = GPSampler(space, strategy="dbe", seed=0, n_startup_trials=5,
                        n_restarts=6,
                        mso_options=MsoOptions(maxiter=100, pgtol=1e-2),
                        device=args.device)
    for _ in range(args.trials):
        t = sampler.ask()
        y = trial(t.x)
        sampler.tell(t.trial_id, y)
        print(f"trial {t.trial_id}: log_lr={t.x[0]:+.2f} "
              f"log_wd={t.x[1]:+.2f} -> final loss {y:.4f}", flush=True)
    best = sampler.best()
    print(f"\nbest: lr=10^{best.x[0]:.2f} wd=10^{best.x[1]:.2f} "
          f"loss={best.y:.4f}")
    return sampler


if __name__ == "__main__":
    main()

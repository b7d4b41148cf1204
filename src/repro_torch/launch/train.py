"""Training launcher: init, checkpoint/restart, preemption handling.

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \\
      --reduced --device cpu --steps 50 --batch 8 --seq 64 \\
      --ckpt-dir /tmp/ck --ckpt-every 20

Counterpart of ``repro/launch/train.py`` on one device: runs on the card
unless ``--device cpu`` is given (and fails without one).  The parameters
are drawn on the device from ``--seed`` and held stacked (the reference's
tree: one leaf per reference leaf); every step is
``train/step.py::train_step`` on ``data/synth.py``'s batch for that step,
the parameters and moments updated in place.

Fault-tolerance semantics, as the reference's:
  * SIGTERM/SIGUSR1 → checkpoint (written before exit) + clean exit;
  * a restart with the same ``--ckpt-dir`` resumes from the latest step
    (a batch is a function of its step, so the data resumes too);
  * other checkpoints are written on a background thread while training
    goes on; the run waits for the last one before it returns.
``--mesh`` other than ``none`` is not ported (ROADMAP queue A item 9b).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.ckpt.manager import CheckpointManager, install_sigterm_handler
from repro_torch.configs import get_config
from repro_torch.data.synth import DataConfig, synth_batch
from repro_torch.launch.shapes import init_fn_for
from repro_torch.train.optim import OptimConfig, init_opt_state
from repro_torch.train.step import make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--weight-decay", type=float, default=0.1)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--grad-compression", default="none",
                    choices=("none", "bf16", "int8_ef"))
    ap.add_argument("--dtype", default=None)
    ap.add_argument("--mesh", default="none",
                    choices=("none", "smoke", "single", "multi"))
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    if args.mesh != "none":
        raise NotImplementedError(
            f"--mesh {args.mesh}: training across several cards is not "
            f"ported yet: ROADMAP queue A item 9b")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.dtype:
        cfg = cfg.replace(dtype=args.dtype)
    dev = resolve_device(args.device)

    opt_cfg = OptimConfig(lr=args.lr, weight_decay=args.weight_decay,
                          total_steps=args.steps,
                          warmup_steps=max(args.steps // 20, 1),
                          grad_compression=args.grad_compression)
    dcfg = DataConfig(global_batch=args.batch, seq_len=args.seq,
                      seed=args.seed)

    flag = install_sigterm_handler()
    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = init_fn_for(cfg)(cfg, gen, stacked=True)
    opt_state = init_opt_state(params, opt_cfg)
    start_step = 0
    if mgr is not None and mgr.latest_step() is not None:
        start_step = mgr.latest_step()
        state = mgr.restore(start_step, {"params": params, "opt": opt_state})
        params, opt_state = state["params"], state["opt"]
        print(f"[train] resumed from step {start_step}")

    step_fn = make_train_step(cfg, opt_cfg, grad_accum=args.grad_accum)

    t_start = time.time()
    for step in range(start_step, args.steps):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in synth_batch(cfg, dcfg, step).items()}
        params, opt_state, metrics = step_fn(params, opt_state, batch)

        if (step + 1) % args.log_every == 0 or step == start_step:
            loss = float(metrics["loss"])
            gn = float(metrics["grad_norm"])
            tput = dcfg.global_batch * dcfg.seq_len * \
                (step + 1 - start_step) / max(time.time() - t_start, 1e-9)
            print(f"[train] step={step + 1} loss={loss:.4f} "
                  f"gnorm={gn:.3f} tok/s={tput:,.0f}", flush=True)

        should_ckpt = mgr is not None and (
            (step + 1) % args.ckpt_every == 0 or flag.triggered
            or step + 1 == args.steps)
        if should_ckpt:
            mgr.save(step + 1, {"params": params, "opt": opt_state},
                     block=flag.triggered)
        if flag.triggered:
            print(f"[train] preempted at step {step + 1}; "
                  "checkpoint written, exiting")
            break
    if mgr is not None:
        mgr.wait()
    return params


if __name__ == "__main__":
    main()

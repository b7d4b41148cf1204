"""Training launcher: init, checkpoint/restart, preemption handling.

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \\
      --reduced --device cpu --steps 50 --batch 8 --seq 64 \\
      --ckpt-dir /tmp/ck --ckpt-every 20

Across a mesh, one process a rank under ``torchrun`` (``env://``
rendezvous: ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``), e.g. four ranks
on the (2, 2) smoke mesh over two cards, or on the CPU:

  torchrun --nproc-per-node 4 -m repro_torch.launch.train \
      --arch llama3.2-3b --reduced --mesh smoke --device cpu --steps 4
  (or --arch recurrentgemma-9b --reduced: the hybrid family)

Counterpart of ``repro/launch/train.py``: runs on the card unless
``--device cpu`` is given (and fails without one).  The parameters
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

``--mesh smoke|single|multi`` (``launch/mesh.py``: (2, 2) over ("data",
"model"), the reference's (16, 16) and (2, 16, 16)) runs the dense and
hybrid families' train step (recurrentgemma-9b: the RG-LRU over "lru",
attention by head dim where kv_heads do not divide "model")
tensor- and data-parallel with ZeRO-1
(``train/step.py``): the backend follows from the layout (NCCL with one
rank a card, gloo where ranks share one, and on the CPU) and is logged;
every rank draws the global parameters from the seed and keeps its
slice, so every mesh starts from the same parameters; each rank builds
the same global batch and takes its rows; only rank 0 prints;
checkpoints hold global arrays (``ckpt/manager.py``), so a run resumes
on another mesh or on none.
"""
from __future__ import annotations

import argparse
import time

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.ckpt.manager import CheckpointManager, install_sigterm_handler
from repro_torch.configs import get_config
from repro_torch.data.synth import DataConfig, synth_batch
from repro_torch.distributed import collectives as C
from repro_torch.distributed.sharding import local_shardings, shard_tree
from repro_torch.launch.mesh import (collective_backend, make_production_mesh,
                                     make_smoke_mesh, use_mesh)
from repro_torch.launch.shapes import init_fn_for
from repro_torch.models.lm import param_axes
from repro_torch.train.optim import (OptimConfig, init_opt_state,
                                     state_shardings)
from repro_torch.train.step import make_train_step


def init_mesh(kind: str, device=None):
    """The process group from ``torchrun``'s environment (the backend
    from the layout, :func:`~repro_torch.launch.mesh.collective_backend`)
    and the ``kind`` mesh over it."""
    backend = collective_backend(device)
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method="env://")
    if kind == "smoke":
        return make_smoke_mesh(device=device)
    return make_production_mesh(multi_pod=(kind == "multi"), device=device)


def preempted(flag, mesh) -> bool:
    """The preemption flag; on a mesh, set if any rank's is (one max
    over the mesh), so every rank checkpoints and stops at the same
    step."""
    if mesh is None:
        return flag.triggered
    t = torch.tensor([float(flag.triggered)], device=mesh.device)
    for a in mesh.axis_names:
        t = C.all_reduce(t, a, op="max", mesh=mesh)
    return bool(t.item())


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

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.dtype:
        cfg = cfg.replace(dtype=args.dtype)
    mesh = None if args.mesh == "none" else init_mesh(args.mesh,
                                                      args.device)
    try:
        with use_mesh(mesh):
            return _run(args, cfg, mesh)
    finally:
        if mesh is not None:
            dist.destroy_process_group()


def _run(args, cfg, mesh):
    dev = resolve_device(args.device) if mesh is None else mesh.device
    say = (print if mesh is None or mesh.rank == 0 else
           (lambda *a, **k: None))
    if mesh is not None:
        say(f"[train] mesh {dict(mesh.sizes)} backend={mesh.backend} "
            f"device={dev.type}", flush=True)

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
    axes = shardings = None
    if mesh is not None:
        axes = param_axes(cfg)
        params = shard_tree(params, axes, mesh)      # the global draw, sliced
        opt_state = init_opt_state(params, opt_cfg, axes)
        shardings = {"params": local_shardings(params, axes, mesh),
                     "opt": state_shardings(params, axes, mesh, opt_cfg)}
    else:
        opt_state = init_opt_state(params, opt_cfg)
    start_step = 0
    if mgr is not None and mgr.latest_step() is not None:
        start_step = mgr.latest_step()
        state = mgr.restore(start_step, {"params": params, "opt": opt_state},
                            shardings=shardings)
        params, opt_state = state["params"], state["opt"]
        say(f"[train] resumed from step {start_step}")

    step_fn = make_train_step(cfg, opt_cfg, grad_accum=args.grad_accum)

    t_start = time.time()
    for step in range(start_step, args.steps):
        batch = {k: torch.from_numpy(v) if mesh is not None
                 else torch.from_numpy(v).to(dev)
                 for k, v in synth_batch(cfg, dcfg, step).items()}
        params, opt_state, metrics = step_fn(params, opt_state, batch)

        if (step + 1) % args.log_every == 0 or step == start_step:
            loss = float(metrics["loss"])
            gn = float(metrics["grad_norm"])
            tput = dcfg.global_batch * dcfg.seq_len * \
                (step + 1 - start_step) / max(time.time() - t_start, 1e-9)
            say(f"[train] step={step + 1} loss={loss:.4f} "
                f"gnorm={gn:.3f} tok/s={tput:,.0f}", flush=True)

        stop = preempted(flag, mesh)
        should_ckpt = mgr is not None and (
            (step + 1) % args.ckpt_every == 0 or stop
            or step + 1 == args.steps)
        if should_ckpt:
            mgr.save(step + 1, {"params": params, "opt": opt_state},
                     block=stop, shardings=shardings)
        if stop:
            say(f"[train] preempted at step {step + 1}; "
                "checkpoint written, exiting")
            break
    if mgr is not None:
        mgr.wait()
    return params


if __name__ == "__main__":
    main()

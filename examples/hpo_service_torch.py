"""Multi-tenant HPO through the BO service on the PyTorch port: several
model-zoo training configurations share one fleet behind ``BOService``.

    PYTHONPATH=src python examples/hpo_service_torch.py [--device cpu]

Twin of ``examples/hpo_service.py``.  Each tenant is one architecture
sweep: it owns a study, asks through the service's asyncio facade, trains
a reduced LM for a few steps at the suggested (log lr, log weight decay)
and tells the final loss back, at its own pace, while the service
multiplexes every ask onto the fleet under deficit-round-robin fairness.
On the card the fleet's programs run K1–K4 and every trial's attention
K6/K7; on the CPU their plain versions.
"""
import argparse
import asyncio
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from hpo_train_torch import make_trial_fn          # noqa: E402
from repro_torch import resolve_device             # noqa: E402
from repro_torch.bo.sampler import FleetSampler    # noqa: E402
from repro_torch.bo.space import BoxSpace          # noqa: E402
from repro_torch.configs import get_config         # noqa: E402
from repro_torch.core.mso import MsoOptions        # noqa: E402
from repro_torch.data.synth import DataConfig      # noqa: E402
from repro_torch.serve.bo_service import BOService, TenantConfig  # noqa: E402

SPACE = BoxSpace(np.array([-5.0, -4.0]), np.array([-1.0, -0.5]))


async def tenant_task(svc, name, study, trial_fn, n_trials):
    """One architecture sweep: ask → train → tell, at its own pace."""
    for _ in range(n_trials):
        t = await svc.ask(name, study)
        # training is synchronous compute; yield around it so the
        # service and the other tenants keep running between trials
        y = await asyncio.get_event_loop().run_in_executor(
            None, trial_fn, t.x)
        await svc.tell(name, study, t.trial_id, y)
        print(f"[{name}] trial {t.trial_id}: "
              f"log_lr={t.x[0]:+.2f} log_wd={t.x[1]:+.2f} "
              f"-> loss {y:.4f}", flush=True)
    best = svc.fs.samplers[study].best()
    print(f"[{name}] best: lr=10^{best.x[0]:.2f} "
          f"wd=10^{best.x[1]:.2f} loss={best.y:.4f}", flush=True)


async def serve(args):
    dev = resolve_device(args.device)
    zoo = [
        # (tenant, arch, weight, width, layers, steps)
        ("small-fast", "llama3.2-3b", 1.0, 64, 2, args.steps),
        ("base", "llama3.2-3b", 2.0, args.width, args.layers, args.steps),
    ]
    fs = FleetSampler([SPACE] * len(zoo), seed=0, n_startup_trials=4,
                      n_restarts=6, pad_multiple=8, slots=4,
                      refit_interval=2, device=args.device,
                      mso_options=MsoOptions(maxiter=100, pgtol=1e-2))
    svc = BOService(fs, [
        TenantConfig(name, weight=w, studies=(i,))
        for i, (name, _a, w, *_rest) in enumerate(zoo)])
    server = asyncio.create_task(svc.run())

    def trial_fn(arch, width, layers, steps):
        cfg = get_config(arch).reduced().replace(
            dtype="float32", d_model=width, n_layers=layers,
            d_ff=2 * width)
        dcfg = DataConfig(global_batch=args.batch, seq_len=args.seq, seed=0)
        return make_trial_fn(cfg, dcfg, steps, dev)

    await asyncio.gather(*[
        tenant_task(svc, name, i, trial_fn(arch, width, layers, steps),
                    args.trials)
        for i, (name, arch, _w, width, layers, steps) in enumerate(zoo)])
    svc.stop()
    await server
    snap = svc.stats_snapshot()
    print(f"\nservice: {snap['svc_completed']} asks served, "
          f"p99={snap['svc_p99_s']}, rung={snap['svc_rung']}, "
          f"fleet compiles={snap['n_fleet_compiles']}")
    return svc


def main(argv=None) -> BOService:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trials", type=int, default=8)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--width", type=int, default=128)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    return asyncio.run(serve(args))


if __name__ == "__main__":
    main()

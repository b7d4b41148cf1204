"""Serving launcher: spin up the continuous-batching engine on an arch.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b \\
      [--reduced] [--device cpu] --requests 12 --prompt-len 8 --max-new 16

Serves the dense, moe (qwen3-moe-30b-a3b, dbrx-132b), vlm (chameleon-34b's
backbone) and hybrid (recurrentgemma-9b) families; ssm and encdec wait
for ROADMAP A12.

Counterpart of ``repro/launch/serve.py``.  Runs on the card unless
``--device cpu`` is given (and fails without one).  Weights are random,
drawn on the device from ``--seed``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.models import lm
from repro_torch.serve.engine import Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.family in ("encdec", "ssm"):
        raise SystemExit(f"{cfg.family} serving waits for ROADMAP A12")
    dev = resolve_device(args.device)

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = lm.init_params(cfg, gen)
    eng = ServeEngine(params, cfg, slots=args.slots, max_len=args.max_len)

    rng = np.random.default_rng(args.seed)
    for uid in range(args.requests):
        eng.submit(Request(
            uid=uid,
            prompt=rng.integers(0, cfg.vocab_size,
                                args.prompt_len).astype(np.int32),
            max_new_tokens=args.max_new))

    t0 = time.time()
    done = eng.run_until_drained()
    wall = time.time() - t0
    print(f"[serve] {cfg.name} on {dev}: {len(done)} requests, "
          f"{eng.stats['tokens']} tokens, {eng.stats['steps']} steps, "
          f"{wall:.1f}s ({eng.stats['tokens'] / max(wall, 1e-9):.1f} tok/s), "
          f"compiles {eng.stats['compiles']}, "
          f"flash launches {eng.stats['flash_launches']}, "
          f"cache {eng.stats['cache_bytes'] / 1e6:.1f} MB")
    for r in done[:4]:
        print(f"  uid={r.uid} out={r.out_tokens}")
    return eng


if __name__ == "__main__":
    main()

"""Batched serving with continuous batching on a reduced llama config, on
the PyTorch port.

    PYTHONPATH=src python examples/serve_batched_torch.py [--device cpu]

On the card every decode step runs the flash-attention kernel (K6) once a
layer; on the CPU its plain version.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.models import lm
from repro_torch.serve.engine import Request, ServeEngine


def main(argv=None) -> ServeEngine:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    # the reference also sets attn_chunk=16; the port's ModelConfig has no
    # attn_chunk (its attention takes the whole cache through K6)
    cfg = get_config("llama3.2-3b").reduced().replace(dtype="float32")
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    eng = ServeEngine(params, cfg, slots=4, max_len=128)

    rng = np.random.default_rng(0)
    for uid in range(10):
        eng.submit(Request(
            uid=uid,
            prompt=rng.integers(0, cfg.vocab_size,
                                4 + uid % 5).astype(np.int32),
            max_new_tokens=12))
    t0 = time.perf_counter()
    done = eng.run_until_drained()
    wall = time.perf_counter() - t0
    print(f"served {len(done)} requests / {eng.stats['tokens']} tokens "
          f"in {eng.stats['steps']} steps ({wall:.2f}s on {dev}; "
          f"programs {eng.stats['compiles']}, "
          f"flash launches {eng.stats['flash_launches']})")
    for r in done[:3]:
        print(f"  uid={r.uid}: {r.out_tokens}")
    return eng


if __name__ == "__main__":
    main()

"""Dry run on one card: does each (arch × shape) cell fit in the card's
memory, and what bounds its step.

Counterpart of ``repro/launch/dryrun.py``.  The reference lowers and
compiles every cell for a TPU mesh and reads XLA's memory and cost
analyses; the port builds each cell's step on the meta device
(``launch/shapes.py``) and counts it (``launch/hlo_cost.py``): nothing
is allocated and no card is needed.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-3b \\
      --shape train_4k [--set remat=dots] [--set grad_accum=8] \\
      [--out results/dryrun_torch]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --sweep

Each cell writes one JSON with the reference's keys where they mean the
same thing; ``memory`` (the parameters and optimizer state in the dtypes
the train step holds them, the decode cache, and the peak working set
of the step, with its gradients and the bytes saved for the backward
named apart) takes the place of XLA's ``memory_analysis``, and
``count_s`` of ``lower_s`` and ``compile_s``.  A hybrid or ssm train or
prefill cell is read off a quadratic (``hlo_cost``), which gives no
peak: its working set, ``live_bytes_per_device`` and ``fits_hbm`` are
null.  ``flops_per_device`` and ``bytes_per_device`` are the counters'
totals (attention on its plain path: the parity yardstick against the
reference's ``hlo_cost.analyze``); ``t_compute`` and ``t_memory`` take
those totals with the plain attention's products and bytes replaced by
the operations and bytes K6 and K7 need.  The reference's dbrx-132b
default (fsdp) places parameters on a mesh and has no counterpart: that
record says ``fits_hbm: false``.  The sweep is resumable: existing JSONs
are skipped.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Optional

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch.hlo_cost import count_cell
from repro_torch.launch.mesh import (HBM_BW, HBM_BYTES, PEAK_FLOPS_BF16,
                                     make_production_mesh)
from repro_torch.launch.shapes import (SHAPES, build_cell, cell_supported,
                                       default_grad_accum)
from repro_torch.models import lm
from repro_torch.train.optim import OptimConfig, tree_leaves

OPT_KEYS = ("grad_compression", "zero1", "shard_grads")
# the parts of ``memory`` that add up to ``live_bytes_per_device``
LIVE_KEYS = ("param_bytes", "opt_bytes", "cache_bytes", "work_bytes")


def _leaf_bytes(tree, itemsize: Optional[int] = None) -> int:
    return sum(t.numel() * (itemsize or t.element_size())
               for t in tree_leaves(tree))


def memory(shape, args, opt_cfg: OptimConfig, grad_accum: int,
           counts: dict) -> dict:
    """Bytes a cell's step holds: the parameters in their dtypes; for
    train the AdamW moments (and int8_ef residuals) in float32; for
    decode the cache; and ``work_bytes``, the peak of what the step
    allocates alive at once (``hlo_cost``; None where the cell is read
    off a quadratic).  ``live_bytes_per_device`` is the sum of these
    four.  Two parts of the working set are also given: the gradients
    in the parameters' dtypes (as autograd gives them) with, under
    microbatches, the accumulator (float32; bfloat16 under bf16
    compression), and the bytes saved for one microbatch's backward."""
    params = args[0]
    out = dict(param_bytes=_leaf_bytes(params), opt_bytes=0, cache_bytes=0,
               work_bytes=counts["work_bytes"], grad_bytes=0,
               saved_bytes=counts["saved_bytes"])
    if shape.kind == "train":
        state = args[1]
        out["opt_bytes"] = sum(_leaf_bytes(t) for t in
                               (state.mu, state.nu, state.ef))
        out["grad_bytes"] = _leaf_bytes(params)
        if grad_accum > 1:
            out["grad_bytes"] += _leaf_bytes(
                params, 2 if opt_cfg.grad_compression == "bf16" else 4)
    elif shape.kind == "decode":
        out["cache_bytes"] = lm.cache_bytes(args[2])
    return out


def run_cell(arch: str, shape_name: str,
             overrides: Optional[dict] = None) -> dict:
    """Build and count one cell on meta; return its record."""
    merged = dict(overrides or {})
    grad_accum = merged.pop("grad_accum", None)
    opt_kw = {k: merged.pop(k) for k in OPT_KEYS if k in merged}
    cfg = get_config(arch)
    if merged:
        cfg = cfg.replace(**merged)
    shape = SHAPES[shape_name]
    ok, why = cell_supported(cfg, shape)
    rec = {"arch": arch, "shape": shape_name, "mesh": "single",
           "family": cfg.family, "status": "skipped", "skip_reason": why}
    if ok:
        rec.update(cell_record(cfg, shape, opt_cfg=OptimConfig(**opt_kw),
                               grad_accum=grad_accum))
    return rec


def cell_record(cfg, shape, *, opt_cfg: Optional[OptimConfig] = None,
                grad_accum: Optional[int] = None) -> dict:
    """The counts, memory and roofline terms of one supported cell (any
    ``ShapeCell``, ``cfg`` as given)."""
    opt_cfg = opt_cfg or OptimConfig()
    if shape.kind == "train" and grad_accum is None:
        grad_accum = default_grad_accum(shape)
    t0 = time.perf_counter()
    built = build_cell(cfg, shape, opt_cfg=opt_cfg, grad_accum=grad_accum)
    counts = count_cell(cfg, shape, opt_cfg=opt_cfg, grad_accum=grad_accum,
                        built=built)
    args = built[1]
    mem = memory(shape, args, opt_cfg, counts["grad_accum"], counts)
    count_s = time.perf_counter() - t0
    live = (None if mem["work_bytes"] is None else
            sum(mem[k] for k in LIVE_KEYS))
    att = counts["attention"]
    kernel_flops = counts["flops"] - att["plain_flops"] + att["kernel_flops"]
    kernel_bytes = counts["bytes"] - att["plain_bytes"] + att["kernel_bytes"]
    rec = {
        "status": "ok",
        "n_chips": 1,
        "remat": cfg.remat,
        "grad_accum": counts["grad_accum"],
        # the sequence lengths counted (hybrid and ssm train and prefill
        # cells: three, read off their quadratic; hlo_cost.count_cell)
        "counted_at": counts["counted_at"],
        "count_s": round(count_s, 2),
        "memory": mem,
        "live_bytes_per_device": live,
        "fits_hbm": None if live is None else bool(live <= HBM_BYTES),
        "flops_per_device": float(counts["flops"]),
        "bytes_per_device": float(counts["bytes"]),
        "collectives": counts["collectives"],
        "collective_bytes_per_device": 0,
        # attention: what the plain path did (counted above) and what K6
        # and K7 need, with their calls
        "attention_plain_flops": float(att["plain_flops"]),
        "attention_kernel_flops": float(att["kernel_flops"]),
        "attention_plain_bytes": float(att["plain_bytes"]),
        "attention_kernel_bytes": float(att["kernel_bytes"]),
        "k6_calls": att["k6_calls"],
        "k7_calls": att["k7_calls"],
        "flops_with_kernels": float(kernel_flops),
        "bytes_with_kernels": float(kernel_bytes),
        "t_compute": kernel_flops / PEAK_FLOPS_BF16,
        "t_memory": kernel_bytes / HBM_BW,
        "t_collective": 0.0,
    }
    terms = {"compute": rec["t_compute"], "memory": rec["t_memory"],
             "collective": rec["t_collective"]}
    rec["bottleneck"] = max(terms, key=terms.get)
    return rec


def _overrides(pairs) -> dict:
    out = {}
    for kv in pairs:
        k, v = kv.split("=", 1)
        try:
            v = json.loads(v)
        except json.JSONDecodeError:
            pass
        out[k] = v
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="single", choices=("single", "multi"))
    ap.add_argument("--sweep", action="store_true",
                    help="run every remaining (arch × shape)")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--set", action="append", default=[],
                    help="cfg override key=value (e.g. remat=dots)")
    args = ap.parse_args(argv)
    if args.mesh != "single":
        make_production_mesh()                 # raises: item 9b
    overrides = _overrides(args.set)
    os.makedirs(args.out, exist_ok=True)

    def one(arch, shape_name):
        tag = f"{arch.replace('.', '_')}__{shape_name}__single"
        path = os.path.join(args.out, tag + ".json")
        if os.path.exists(path) and args.sweep:
            print(f"[skip existing] {tag}")
            return
        print(f"[dryrun] {tag} ...", flush=True)
        try:
            rec = run_cell(arch, shape_name, overrides or None)
        except Exception as e:
            rec = {"arch": arch, "shape": shape_name, "mesh": "single",
                   "status": "error", "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-4000:]}
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        extra = ""
        if rec["status"] == "ok":
            live = rec["live_bytes_per_device"]
            gb = "n/a" if live is None else f"{live / 1e9:.2f}GB"
            extra = (f" count={rec['count_s']}s live={gb} "
                     f"fits={rec['fits_hbm']} bottleneck={rec['bottleneck']}")
        print(f"[done] {tag}: {rec['status']}{extra}", flush=True)

    if args.sweep:
        for arch in ARCH_IDS:
            for shape_name in SHAPES:
                one(arch, shape_name)
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required without --sweep")
        one(args.arch, args.shape)


if __name__ == "__main__":
    main()

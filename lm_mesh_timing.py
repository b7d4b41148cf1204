"""Where the seconds of ``chip_smoke.py::phase_lm_mesh`` go, on one card.

    python3 lm_mesh_timing.py

Spawns (a)'s four ranks and (b)'s two as worlds of their own (gloo: the
ranks share the card; the phase runs both in one world) and times, in
each rank, what the phase's totals hide: how long a rank takes
from its spawn to its first line of work, one gloo all-reduce (of the
reduced model's activation in (a), of llama3.2-3b's (B=4, S=512, d=3072,
bf16: 12.6 MB) in (b)), and the work itself run three times, so the
first run's one-off cost shows beside the steady ones: (a) the reduced
llama's whole small path (train steps, decode, the MoE, the elastic
save); (b) at full width on (1, 2) a forward alone, then
``compute_grads`` and ``apply_updates`` apart.  Prints one JSON line a
world, with the card's name and power limit, and exits 2 without CUDA.

    python3 lm_mesh_timing.py --faults

Reads instead what (b)'s checks see of a faulty layout: on (1, 2), the
first step's loss and gradient norm against the unsharded port's
(``chip_smoke.py::lm_mesh_full_rank``), once as the port is and once
with each of Megatron's *f* or *g* made the identity in one layer
function (patched in the ranks, not in the code): the readings
``chip_smoke.LM_MESH_TOL``'s ``full_loss`` and ``full_grad_norm`` must
lie between.
"""
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def allreduce_s(mesh, x, n=3):
    """Seconds of ``n`` all-reduces of ``x`` over "model", one by one."""
    import torch
    import torch.distributed as dist
    out = []
    for _ in range(n):
        t = time.time()
        dist.all_reduce(x, group=mesh.groups["model"])
        torch.cuda.synchronize()
        out.append(time.time() - t)
    return out


def small_rank(rank, t_spawn, c, params_np, batches, moe_np, ckpt):
    """(a): the reduced llama's small path on (2, 2), three times."""
    t0 = time.time()
    import torch
    import chip_smoke as cs
    from repro_torch.launch.mesh import make_smoke_mesh, use_mesh
    marks = {"spawn_to_work_s": t0 - t_spawn}
    mesh = make_smoke_mesh((2, 2))
    marks["mesh_s"] = time.time() - t0
    marks["allreduce_s"] = allreduce_s(mesh, torch.ones(
        4, 16, 128, device=mesh.device))
    marks["small_path_s"] = []
    with use_mesh(mesh):
        for _ in range(3):
            t = time.time()
            cs.lm_mesh_small(mesh, c, params_np, batches, moe_np, ckpt)
            marks["small_path_s"].append(time.time() - t)
    return marks


def full_rank(rank, t_spawn):
    """(b): llama3.2-3b at full width on (1, 2), three forward passes
    and three steps' halves apart."""
    t0 = time.time()
    import gc
    import torch
    import chip_smoke as cs
    from repro_torch.distributed.sharding import shard_tree
    from repro_torch.launch.mesh import make_smoke_mesh, use_mesh
    from repro_torch.models import lm
    from repro_torch.train import optim
    from repro_torch.train.step import compute_grads
    f = cs.LM_MESH_FULL
    marks = {"spawn_to_work_s": t0 - t_spawn}
    mesh = make_smoke_mesh((1, 2))
    cfg = cs.lm_mesh_full_cfg(f)
    marks["allreduce_s"] = allreduce_s(mesh, torch.ones(
        f["batch"], f["seq"], cfg.d_model, device=mesh.device,
        dtype=torch.bfloat16))
    batches, full = cs.lm_mesh_full_inputs(cfg, f, mesh.device)
    batch = batches[0]
    axes = lm.param_axes(cfg)
    oc = cs.lm_mesh_opt(f, 3)
    for key in ("forward_s", "grads_s", "update_s"):
        marks[key] = []
    with use_mesh(mesh):
        params = shard_tree(full, axes, mesh)
        del full
        gc.collect()
        torch.cuda.empty_cache()
        state = optim.init_opt_state(params, oc, axes)
        for _ in range(3):
            t = time.time()
            with torch.no_grad():
                lm.lm_loss(params, cfg, {k: v.to(mesh.device)
                                         for k, v in batch.items()})
            torch.cuda.synchronize()
            marks["forward_s"].append(time.time() - t)
        for _ in range(3):
            t = time.time()
            _, grads = compute_grads(params, cfg, batch)
            torch.cuda.synchronize()
            marks["grads_s"].append(time.time() - t)
            t = time.time()
            optim.apply_updates(params, grads, state, oc, axes)
            torch.cuda.synchronize()
            marks["update_s"].append(time.time() - t)
            del grads
    return marks


# the faults --faults reads: (layer function, collective made the identity)
FAULTS = {"sound": None,
          "mlp without g": ("apply_mlp", "reduce_from"),
          "mlp without f": ("apply_mlp", "copy_to"),
          "attention without f": ("apply_attention", "copy_to")}


def fault_rank(rank):
    """(b)'s first step on (1, 2) as the port is and under each fault:
    rank 0's loss gap (absolute) and gradient-norm gap (relative) to the
    unsharded port's."""
    import types
    from unittest import mock
    import chip_smoke as cs
    from repro_torch.distributed import collectives as C
    from repro_torch.models import layers
    f = dict(cs.LM_MESH_FULL, warm=1, timed=0)
    out = {}
    for name, fault in FAULTS.items():
        with contextlib.ExitStack() as stack:
            if fault is not None:
                fn, op = fault
                faulty = types.SimpleNamespace(**dict(
                    vars(C), **{op: lambda x, axis="model", mesh=None: x}))
                inner = getattr(layers, fn)

                def wrapped(*a, _inner=inner, _faulty=faulty, **k):
                    with mock.patch.object(layers, "C", _faulty):
                        return _inner(*a, **k)
                stack.enter_context(mock.patch.object(layers, fn, wrapped))
            o = cs.lm_mesh_full_rank(rank, (1, 2), f, cs.LM_MESH, None)
        out[name] = dict(
            loss=o["losses"][0], unsharded_loss=o.get("unsharded_loss"),
            grad_norm=o["grad_norms"][0],
            unsharded_grad_norm=o.get("unsharded_grad_norm"))
        if rank == 0:
            out[name].update(
                loss_gap=abs(o["losses"][0] - o["unsharded_loss"]),
                grad_norm_gap=abs(o["grad_norms"][0]
                                  - o["unsharded_grad_norm"])
                / o["unsharded_grad_norm"])
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("lm_mesh_timing.py: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.distributed.world import run_world
    cs.phase_build()
    name = card()
    if "--faults" in sys.argv[1:]:
        t = time.time()
        ranks = run_world(fault_rank, 2, (), timeout=cs.LM_MESH_TIMEOUT)
        print(json.dumps({"faults": ranks[0], "limits": {
            k: cs.LM_MESH_TOL[k] for k in ("full_loss", "full_grad_norm")},
            "world_s": time.time() - t, "card": name}), flush=True)
        return 0
    c = cs.LM_MESH
    params_np, batches, moe_np = cs.lm_mesh_inputs(c)
    with tempfile.TemporaryDirectory() as ckpt:
        t = time.time()
        ranks = run_world(small_rank, 4, (time.time(), c, params_np,
                                          batches, moe_np, ckpt),
                          timeout=cs.LM_MESH_TIMEOUT)
        print(json.dumps({"world": "a (2, 2)", "world_s": time.time() - t,
                          "ranks": ranks, "card": name}), flush=True)
    t = time.time()
    ranks = run_world(full_rank, 2, (time.time(),),
                      timeout=cs.LM_MESH_TIMEOUT)
    print(json.dumps({"world": "b (1, 2)", "world_s": time.time() - t,
                      "ranks": ranks, "card": name}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

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

    python3 lm_mesh_timing.py --gap [--steps N]

Takes part (c)'s decode gap apart (``chip_smoke.py::phase_lm_mesh``:
recurrentgemma-9b at full width and depth, bf16, 8 slots, on (1, 2) over
gloo, ``chip_smoke.lm_mesh_hybrid_tokens``' first N steps, default 8).
The unsharded card decode runs first, in bf16 and then on the same
weights cast to float32; then a world of two decodes on the mesh, as the
port is and with one stage at a time sent over a float32 wire (the
RG-LRU's ``scatter_to`` of its gate products, *g* (``reduce_from``)
after the row-parallel products, the k/q/out ``gather_from`` of the
head-dim path, then all three): the ranks wrap those functions of
``repro_torch.distributed.collectives`` (a bf16 input upcast, the
collective run, the result rounded once), and the package keeps no
switch for it; last the mesh in float32.  Each reading is the gap after
every layer unit (max |Δ| of the residual stream over its max |x| in the
reference, the worst step) and the logits' gap (max |Δ| over max
|logit|, as the phase reads it), against the unsharded decode in the
same dtype, plus the bf16 card decode against its float32 twin.  Prints
one JSON line with the card's name and power limit.
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


# --gap's stages: the collectives a float32 wire replaces
GAP_WIRES = {"sound": (),
             "scatter_to f32": ("scatter_to",),
             "reduce_from f32": ("reduce_from",),
             "gather_from f32": ("gather_from",),
             "all three f32": ("scatter_to", "reduce_from", "gather_from")}


def f32_wire(fn):
    """``fn`` (a collective) run on a bf16 input upcast to float32, its
    result rounded to bf16 once."""
    import torch

    def wired(x, *a, **k):
        if x.dtype != torch.bfloat16:
            return fn(x, *a, **k)
        return fn(x.float(), *a, **k).to(torch.bfloat16)
    return wired


def to_f32(tree):
    """The tree with every tensor in float32, a leaf at a time (each bf16
    leaf freed as its copy is made)."""
    if isinstance(tree, dict):
        for key in list(tree):
            tree[key] = to_f32(tree[key])
        return tree
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_f32(v) for v in tree)
    return tree.float()


def recorded_decode(params, cfg, h, device, steps):
    """(logits (steps, B, V), residual stream after every layer unit
    (steps, units, B, D)) of ``steps`` steps of (c)'s decode."""
    from unittest import mock
    import numpy as np
    import chip_smoke as cs
    from repro_torch.models import lm
    units = []
    inner = lm._rg_apply

    def record(*a, **k):
        x = inner(*a, **k)
        units.append(x[:, 0].float().cpu().numpy())
        return x
    toks, pos = cs.lm_mesh_hybrid_tokens(h, cfg.vocab_size)
    with mock.patch.object(lm, "_rg_apply", record):
        logits, _ = cs.hybrid_decode(params, cfg, toks, pos, h["max_len"],
                                     device, steps=steps)
    return logits, np.stack(units).reshape(steps, -1, *units[0].shape)


def gap(got, ref):
    """(per layer unit: the worst step's max |Δ| over max |x|; the
    logits' max |Δ| over max |logit|)."""
    import numpy as np
    lg, xs = got
    lr, xr = ref
    per = (np.abs(xs - xr).max(axis=(2, 3))
           / np.abs(xr).max(axis=(2, 3))).max(axis=0)
    return ([float(x) for x in per],
            float(np.abs(lg - lr).max() / np.abs(lr).max()))


def gap_rank(rank, steps, tmp):
    """(c)'s decode on (1, 2) for every wire of GAP_WIRES, then in
    float32; rank 0 saves its recordings in ``tmp`` (too large to send
    back) and returns their files."""
    import gc
    from unittest import mock
    import numpy as np
    import torch
    import chip_smoke as cs
    from repro_torch.distributed import collectives as C
    from repro_torch.launch.mesh import make_smoke_mesh, use_mesh
    from repro_torch.models import lm
    h = cs.LM_MESH_HYBRID
    mesh = make_smoke_mesh(h["shape"])
    out = {}
    with use_mesh(mesh):
        cfg = cs.lm_mesh_hybrid_cfg(h)
        params = cs.shard_dropping(lm.init_params(
            cfg, torch.Generator(device=mesh.device).manual_seed(0),
            stacked=True), lm.param_axes(cfg), mesh)
        gc.collect()
        torch.cuda.empty_cache()
        for name, wires in GAP_WIRES.items():
            with contextlib.ExitStack() as stack:
                for w in wires:
                    stack.enter_context(mock.patch.object(
                        C, w, f32_wire(getattr(C, w))))
                out[name] = recorded_decode(params, cfg, h, mesh.device,
                                            steps)
            cs.rank_log(rank, f"gap: {name} decoded")
        params = to_f32(params)
        gc.collect()
        torch.cuda.empty_cache()
        out["f32 mesh"] = recorded_decode(
            params, cfg.replace(dtype="float32"), h, mesh.device, steps)
    if rank != 0:
        return None
    files = {}
    for i, (name, (logits, units)) in enumerate(out.items()):
        files[name] = os.path.join(tmp, f"gap{i}.npz")
        np.savez(files[name], logits=logits, units=units)
    return files


def gap_main(name: str, dev) -> int:
    """--gap: the unsharded references in this process on ``dev``, then
    the world."""
    import gc
    import numpy as np
    import torch
    import chip_smoke as cs
    from repro_torch.distributed.world import run_world
    from repro_torch.models import lm
    argv = sys.argv[1:]
    steps = int(argv[argv.index("--steps") + 1]) if "--steps" in argv else 8
    h = cs.LM_MESH_HYBRID
    t = time.time()
    cfg = cs.lm_mesh_hybrid_cfg(h)
    full = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                          stacked=True)
    ref = {"bf16": recorded_decode(full, cfg, h, dev, steps)}
    full = to_f32(full)
    ref["f32"] = recorded_decode(full, cfg.replace(dtype="float32"), h, dev,
                                 steps)
    del full
    gc.collect()
    torch.cuda.empty_cache()
    unsharded_s = time.time() - t
    t = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        files = run_world(gap_rank, 2, (steps, tmp),
                          timeout=cs.LM_MESH_TIMEOUT)[0]
        mesh = {}
        for key, f in files.items():
            with np.load(f) as z:
                mesh[key] = (z["logits"], z["units"])
    rows = {}
    for key, got in mesh.items():
        units, logits = gap(got, ref["f32" if key == "f32 mesh" else "bf16"])
        rows[key] = dict(logits_gap=logits, unit_gap=units)
    units, logits = gap(ref["bf16"], ref["f32"])
    rows["unsharded bf16 vs f32"] = dict(logits_gap=logits, unit_gap=units)
    units, logits = gap(mesh["sound"], ref["f32"])
    rows["sound vs unsharded f32"] = dict(logits_gap=logits, unit_gap=units)
    print(json.dumps({"gap": rows, "steps": steps,
                      "unsharded_s": unsharded_s, "world_s": time.time() - t,
                      "card": name}), flush=True)
    return 0


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("lm_mesh_timing.py: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.distributed.world import run_world
    cs.phase_build()
    name = card()
    if "--gap" in sys.argv[1:]:
        return gap_main(name, torch.device("cuda"))
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

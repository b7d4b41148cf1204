"""What each rank of a gloo CPU world runs for ``test_torch_lm_mesh.py``
and ``test_torch_hybrid_mesh.py``.

The workers import torch and the port only (never JAX), so a spawned
rank starts fast; each returns numpy arrays (rank 0's, or every rank's
where the test compares ranks) and the test process holds them against
the JAX package and the unsharded port.
"""
import contextlib
import io
import os
import time
import weakref

import numpy as np
import torch

from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.distributed import collectives
from repro_torch.distributed.sharding import (NamedSharding, gather_tree,
                                              local_shardings, shard_tree)
from repro_torch.launch import train as T
from repro_torch.launch.mesh import make_smoke_mesh, use_mesh
from repro_torch.models import lm
from repro_torch.models import moe as MOE
from repro_torch.train import optim
from repro_torch.train import step as STEP

BATCH_AXES = {"tokens": ("batch", None), "targets": ("batch", None)}
MOE_AXES = {"router": ("embed", None), "w_up": ("experts", "embed", None),
            "w_gate": ("experts", "embed", None),
            "w_down": ("experts", None, "embed")}
STEPS_OPT = dict(lr=3e-4, weight_decay=0.1, warmup_steps=1, total_steps=3)
DECODE_STEPS = 4


@contextlib.contextmanager
def fake_world(rank, size):
    """This process as rank ``rank`` of a world of ``size`` on torch's
    fake backend, whose collectives do nothing: a mesh's layout and each
    rank's own part, without spawning."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def llama_cfg(**kw):
    """The reduced llama3.2-3b in float32 at 2 layers, with 12 heads on 4
    kv_heads (the full model's G = 3), which divide the model axes of
    ``test_torch_lm_mesh.py`` (the reduced config's one kv head would take
    the head-dim path, ``dense_kv2_cfg``'s)."""
    return get_config("llama3.2-3b").reduced().replace(
        dtype="float32", n_heads=12, n_kv_heads=4, n_layers=2, **kw)


def hybrid_cfg(**kw):
    """The reduced recurrentgemma-9b in float32: one (rec, rec, attn)
    triple, 4 heads on 1 kv_head, hd 32, lru 128, window 64."""
    return get_config("recurrentgemma-9b").reduced().replace(
        dtype="float32", **kw)


def dense_kv2_cfg(**kw):
    """The llama of ``llama_cfg`` on 2 kv_heads, which divide no model
    axis of 4: its attention splits by head dim there."""
    return llama_cfg(**kw).replace(n_kv_heads=2)


def moe_cfg(**kw):
    return get_config("dbrx-132b").reduced().replace(
        dtype="float32", moe_capacity_factor=100.0, **kw)


def np_tree(t):
    if isinstance(t, dict):
        return {k: np_tree(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return type(t)(np_tree(v) for v in t)
    return t.detach().cpu().numpy().copy()


def value_and_grads(params, cfg, batch):
    """(loss, the gradients of ``params``' leaves) of ``lm.lm_loss``."""
    leaves = optim.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = lm.lm_loss(params, cfg, batch)
    grads = dict(zip(map(id, leaves), torch.autograd.grad(loss, leaves)))
    return loss.detach(), optim.tree_map(lambda p: grads[id(p)], params)


def gathered_state(state, params, axes, mesh, oc):
    sh = optim.state_shardings(params, axes, mesh, oc)
    return {k: np_tree(gather_tree(getattr(state, k), getattr(sh, k)))
            for k in ("mu", "nu")}


def train_steps(mesh, cfg, params_np, batch_np, steps, **opt):
    """``steps`` train steps at grad_accum 2 from ``params_np`` on the
    mesh: the gathered parameters, moments and metrics after each."""
    oc = optim.OptimConfig(**STEPS_OPT, **opt)
    axes = lm.param_axes(cfg)
    params = lm_params_from_numpy(params_np, stacked=True, mesh=mesh, cfg=cfg)
    state = optim.init_opt_state(params, oc, axes)
    step = STEP.make_train_step(cfg, oc, 2)
    out = []
    for b in batch_np[:steps]:
        params, state, m = step(params, state, {
            k: torch.from_numpy(v) for k, v in b.items()})
        out.append(dict(params=np_tree(gather_tree(params, axes, mesh)),
                        **gathered_state(state, params, axes, mesh, oc),
                        grad_norm=float(m["grad_norm"]),
                        loss=float(m["loss"])))
    return out, params, state, oc


def decode(mesh, cfg, params, tokens_np):
    """DECODE_STEPS decode steps of this rank's rows: the logits, gathered
    over "data", a step each."""
    cache = lm.init_cache(cfg, tokens_np.shape[0], 16)
    local = shard_tree({"t": torch.from_numpy(tokens_np)},
                       {"t": ("batch", None)}, mesh)["t"]
    out = []
    with torch.no_grad():
        for i in range(DECODE_STEPS):
            logits, cache = lm.decode_step(params, cfg, local[:, i:i + 1],
                                           cache, i)
            out.append(collectives.all_gather(logits, "data").numpy())
    return np.stack(out)


def spy_dtypes(mesh, cfg, params_np, batch_np):
    """One train step under each compression: the dtypes handed to the
    "data" collectives of the gradient reduction, and of the
    accumulator."""
    seen = {}
    real = (collectives.all_reduce, collectives.reduce_scatter,
            STEP.constrain_grads_zero1, STEP.accumulator)
    inside = []

    def wrap(fn):
        def spy(x, axis, *a, **k):
            if inside and axis == "data":
                seen.setdefault(mode, {}).setdefault("wire", set()).add(
                    str(x.dtype))
            return fn(x, axis, *a, **k)
        return spy

    def reduce(*a, **k):
        inside.append(1)
        try:
            return real[2](*a, **k)
        finally:
            inside.pop()

    def acc(*a, **k):
        out = real[3](*a, **k)
        seen.setdefault(mode, {}).setdefault("acc", set()).update(
            str(x.dtype) for x in optim.tree_leaves(out))
        return out

    collectives.all_reduce, collectives.reduce_scatter = map(wrap, real[:2])
    STEP.constrain_grads_zero1, STEP.accumulator = reduce, acc
    try:
        for mode in ("none", "bf16"):
            train_steps(mesh, cfg, params_np, batch_np, 1,
                        grad_compression=mode)
    finally:
        (collectives.all_reduce, collectives.reduce_scatter,
         STEP.constrain_grads_zero1, STEP.accumulator) = real
    return {m: {k: sorted(v) for k, v in d.items()} for m, d in seen.items()}


def raises(fn, *args):
    try:
        fn(*args)
    except Exception as e:          # the test checks type and message
        return type(e).__name__, str(e)
    return None


def mesh_world(rank, shape, params_np, batch_np, extra):
    """Every check of one mesh shape (``extra`` names the shape's own):
    loss and reduced gradients on batch 0's rows, 2 train steps with
    ``shard_grads`` True and False, the decode, and as asked the MoE, the
    elastic save and resume, the compression spy and what is not ported
    (the families that still raise on a mesh)."""
    cfg = llama_cfg()
    mesh = make_smoke_mesh(shape, device="cpu")
    out = {}
    with use_mesh(mesh):
        axes = lm.param_axes(cfg)
        params = lm_params_from_numpy(params_np, stacked=True, mesh=mesh,
                                      cfg=cfg)
        b0 = {k: torch.from_numpy(v) for k, v in batch_np[0].items()}
        loss, grads = value_and_grads(params, cfg,
                                      shard_tree(b0, BATCH_AXES, mesh))
        out["loss"] = float(loss)
        out["grads"] = np_tree(gather_tree(optim.reduce_grads(grads), axes,
                                           mesh))
        for sg in (True, False):
            out[f"steps_{sg}"] = train_steps(mesh, cfg, params_np, batch_np,
                                             2, shard_grads=sg)[0]
        out["decode"] = decode(mesh, cfg, params, batch_np[0]["tokens"])
        if "moe" in extra:
            mcfg = moe_cfg()
            p, x = extra["moe"]
            y, aux = MOE.apply_moe(
                shard_tree({k: torch.from_numpy(v) for k, v in p.items()},
                           MOE_AXES, mesh), mcfg,
                shard_tree({"x": torch.from_numpy(x)},
                           {"x": ("batch", None, None)}, mesh)["x"],
                mesh=mesh)
            out["moe"] = (collectives.all_gather(y, "data").numpy(),
                          float(aux))
            out["moe_raise"] = raises(MOE.apply_moe, p, moe_cfg(
                n_experts=6), torch.zeros(1, 1, mcfg.d_model), mesh)
        if "ckpt" in extra:
            out.update(elastic_save(mesh, cfg, params_np, batch_np,
                                    extra["ckpt"]))
        if "spy" in extra:
            out["steps_int8_ef"] = train_steps(
                mesh, cfg, params_np, batch_np, 1,
                grad_compression="int8_ef")[0]
            out["spy"] = spy_dtypes(mesh, cfg, params_np, batch_np)
            out["not_ported"] = not_ported(b0)
    return out if rank == 0 else None


def not_ported(batch):
    """What still raises on a mesh: the ssm, moe and encdec families'
    entry points, each (type, message)."""
    from repro_torch.models import whisper as WH
    out = {arch: raises(lm.lm_loss, None, get_config(arch).reduced(), batch)
           for arch in ("xlstm-1.3b", "qwen3-moe-30b-a3b")}
    out["whisper-base"] = raises(WH.encode, None,
                                 get_config("whisper-base").reduced(), None)
    return out


def shardings(mesh, params, axes, oc):
    return {"params": local_shardings(params, axes, mesh),
            "opt": optim.state_shardings(params, axes, mesh, oc)}


@contextlib.contextmanager
def gathered_at_once():
    """A list that ends holding [the most global tensors gathered by
    ``NamedSharding.gather`` alive at once, how many were gathered]
    during the block (a leaf whose gather is itself is not counted)."""
    inner, live, peak = NamedSharding.gather, [0], [0, 0]

    def gather(self, x):
        y = inner(self, x)
        if y is not x:
            live[0] += 1
            peak[0], peak[1] = max(peak[0], live[0]), peak[1] + 1
            weakref.finalize(y, lambda: live.__setitem__(0, live[0] - 1))
        return y
    NamedSharding.gather = gather
    try:
        yield peak
    finally:
        NamedSharding.gather = inner


def elastic_save(mesh, cfg, params_np, batch_np, directory):
    """Step 1, a save on this mesh, step 2; then the save restored on the
    same mesh and step 2 again: both step 2s' local shards (they must be
    bitwise equal) and the saved state, gathered."""
    steps, params, state, oc = train_steps(mesh, cfg, params_np, batch_np, 1)
    axes = lm.param_axes(cfg)
    sh = shardings(mesh, params, axes, oc)
    mgr = CheckpointManager(directory)
    with gathered_at_once() as peak:
        mgr.save(1, {"params": params, "opt": state}, shardings=sh)
    step = STEP.make_train_step(cfg, oc, 2)
    b1 = {k: torch.from_numpy(v) for k, v in batch_np[1].items()}
    straight = step(params, state, b1)
    fresh, fstate = (lm_params_from_numpy(params_np, stacked=True, mesh=mesh,
                                          cfg=cfg),
                     optim.init_opt_state(params, oc, axes))
    got = mgr.restore(1, {"params": fresh, "opt": fstate}, shardings=sh)
    resumed = step(got["params"], got["opt"], b1)
    local = [np_tree((p, s.mu, s.nu, m["grad_norm"], m["loss"]))
             for p, s, m in (straight, resumed)]
    return {"saved": dict(params=steps[0]["params"],
                          mu=steps[0]["mu"], nu=steps[0]["nu"]),
            "save_gathered_at_once": peak,
            "resume_bitwise": all(
                np.array_equal(a, b) for a, b in zip(
                    optim.tree_leaves(local[0]), optim.tree_leaves(local[1])))}


def restore_world(rank, shape, directory, cfg=None, mesh=None):
    """The step-1 checkpoint restored on this mesh (made here unless
    given, with ``cfg``: default the llama), gathered."""
    cfg = llama_cfg() if cfg is None else cfg
    mesh = make_smoke_mesh(shape, device="cpu") if mesh is None else mesh
    with use_mesh(mesh):
        axes = lm.param_axes(cfg)
        oc = optim.OptimConfig(**STEPS_OPT)
        gen = torch.Generator().manual_seed(1)
        params = shard_tree(lm.init_params(cfg, gen, stacked=True), axes,
                            mesh)
        state = optim.init_opt_state(params, oc, axes)
        got = CheckpointManager(directory).restore(
            1, {"params": params, "opt": state},
            shardings=shardings(mesh, params, axes, oc))
        out = dict(params=np_tree(gather_tree(got["params"], axes, mesh)),
                   **gathered_state(got["opt"], got["params"], axes, mesh,
                                    oc), step=int(got["opt"].step))
    return out if rank == 0 else None


def launcher_world(rank, runs, drop):
    """``launch/train.main`` once a run, each on its own rendezvous port
    (the launcher ends its process group when it returns), the file
    ``drop`` removed after the first (rank 0 removes it, the others wait
    until it is gone): every rank's final local shards and rank 0's
    output."""
    out = []
    for i, (argv, port) in enumerate(runs):
        if i == 1:
            if rank == 0:
                os.remove(drop)
            while os.path.exists(drop):
                time.sleep(0.01)
        os.environ["MASTER_PORT"] = str(port)
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            params = T.main(argv)
        out.append((np_tree(optim.tree_leaves(params)), text.getvalue()))
    return out


# ------------------------------------------------------------ the hybrid
def schedule_decode(mesh, cfg, params, tokens_np, positions_np, max_len):
    """Decode steps of this rank's rows at the given positions (one
    (B,) row a step; −1 is an idle row): every step's logits, gathered
    over "data"."""
    cache = lm.init_cache(cfg, tokens_np.shape[0], max_len)
    local = shard_tree({"t": torch.from_numpy(tokens_np),
                        "p": torch.from_numpy(positions_np)},
                       {"t": ("batch", None), "p": (None, "batch")}, mesh)
    out = []
    with torch.no_grad():
        for i in range(positions_np.shape[0]):
            logits, cache = lm.decode_step(params, cfg,
                                           local["t"][:, i:i + 1], cache,
                                           local["p"][i].contiguous())
            out.append(collectives.all_gather(logits, "data").numpy())
    return np.stack(out), cache


def rope_on_a_slice(p, cfg, k, tables):
    """A test double of ``layers._whole_k`` that rotates this rank's
    head-dim slice with tables of the slice's width and then gathers: the
    fault the head-dim path must not have."""
    from repro_torch.models import layers as L
    t = L.rope_tables(tables_positions[0], k.shape[-1], cfg.rope_theta,
                      cfg.rope_fraction)
    return collectives.gather_from(L.apply_rope(k, t), "model",
                                   dim=-1).contiguous()


tables_positions = [None]


def decode_with_rope_on_a_slice(mesh, cfg, params, tokens_np, positions_np,
                                max_len):
    """:func:`schedule_decode` with ``rope_on_a_slice`` in place of the
    layer's gather-then-rotate."""
    from repro_torch.models import layers as L
    whole, tables = L._whole_k, L.rope_tables

    def spy(positions, *a, **k):
        tables_positions[0] = positions
        return tables(positions, *a, **k)
    L._whole_k, L.rope_tables = rope_on_a_slice, spy
    try:
        return schedule_decode(mesh, cfg, params, tokens_np, positions_np,
                               max_len)[0]
    finally:
        L._whole_k, L.rope_tables = whole, tables


def hybrid_world(rank, shape, inputs, ckpt_dir):
    """Every check of one mesh shape for the hybrid family (and, on a
    model axis of 4, the dense head-dim path): loss and reduced gradients
    on batch 0, 2 train steps (grad_accum 2, ZeRO-1), the decode schedule
    with its cache's local shapes, and on (2, 2) an elastic save after
    step 1, on (1, 4) that save restored, the dense kv_heads = 2 checks and
    the decode with RoPE on a slice."""
    cfg = hybrid_cfg()
    mesh = make_smoke_mesh(shape, device="cpu")
    out = {}
    with use_mesh(mesh):
        out.update(hybrid_checks(mesh, cfg, inputs["hybrid"]))
        if shape == (2, 2):
            steps, params, state, oc = train_steps(
                mesh, cfg, inputs["hybrid"]["params"],
                inputs["hybrid"]["batches"], 1)
            axes = lm.param_axes(cfg)
            CheckpointManager(ckpt_dir).save(1, {"params": params,
                                                 "opt": state},
                                             shardings=shardings(
                                                 mesh, params, axes, oc))
            out["saved"] = {k: steps[0][k] for k in ("params", "mu", "nu")}
        else:
            out["restored"] = restore_world(rank, shape, ckpt_dir,
                                            cfg=cfg, mesh=mesh)
            dense = inputs["dense"]
            dcfg = dense_kv2_cfg()
            params = lm_params_from_numpy(dense["params"], stacked=True,
                                          mesh=mesh, cfg=dcfg)
            b0 = {k: torch.from_numpy(v) for k, v in
                  dense["batches"][0].items()}
            loss, grads = value_and_grads(params, dcfg,
                                          shard_tree(b0, BATCH_AXES, mesh))
            out["dense"] = {
                "loss": float(loss),
                "grads": np_tree(gather_tree(optim.reduce_grads(grads),
                                             lm.param_axes(dcfg), mesh)),
                "decode": schedule_decode(mesh, dcfg, params, *dense[
                    "decode"])[0]}
            h = inputs["hybrid"]
            params = lm_params_from_numpy(h["params"], stacked=True,
                                          mesh=mesh, cfg=cfg)
            out["rope_on_a_slice"] = decode_with_rope_on_a_slice(
                mesh, cfg, params, *h["decode"])
    return out if rank == 0 else None


def hybrid_checks(mesh, cfg, h):
    """The hybrid's loss, gradients, train steps, decode and cache
    shapes on ``mesh``."""
    axes = lm.param_axes(cfg)
    params = lm_params_from_numpy(h["params"], stacked=True, mesh=mesh,
                                  cfg=cfg)
    b0 = {k: torch.from_numpy(v) for k, v in h["batches"][0].items()}
    loss, grads = value_and_grads(params, cfg,
                                  shard_tree(b0, BATCH_AXES, mesh))
    out = {"loss": float(loss),
           "grads": np_tree(gather_tree(optim.reduce_grads(grads), axes,
                                        mesh)),
           "steps": train_steps(mesh, cfg, h["params"], h["batches"], 2)[0]}
    params = lm_params_from_numpy(h["params"], stacked=True, mesh=mesh,
                                  cfg=cfg)
    out["decode"], cache = schedule_decode(mesh, cfg, params, *h["decode"])
    out["cache_shapes"] = optim.tree_map(lambda t: tuple(t.shape), cache)
    return out

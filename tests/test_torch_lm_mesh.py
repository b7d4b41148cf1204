"""The LM across a ("data", "model") mesh over ``torch.distributed``: the
port's tensor- and data-parallel train step and decode, the vocab-sharded
loss, ZeRO-1/2, expert parallelism and elastic checkpoints, on gloo CPU
worlds of 2, 4 and 8 ranks (``distributed/world.py::run_world``; the
ranks run ``lm_mesh_ranks.py``, which imports no JAX).

The model is the reduced llama3.2-3b in float32 at 2 layers with 12 heads
on 4 kv_heads (the full model's G = 3; the head-dim path that kv_heads
dividing no model axis take is ``test_torch_hybrid_mesh.py``'s), its
parameters JAX's, carried across.  Each mesh shape's world is
spawned once and runs every check of that shape; the JAX side and the
unsharded port run here.

Tolerances (per leaf, relative: ‖got − want‖ / ‖want‖ over the leaf's
entries): the loss within 1e-5 of JAX's unsharded ``lm_loss``; the
gradients, reduced over "data" and gathered, within 1e-5 of the
unsharded port's; after one and two train steps (grad_accum 2,
``shard_grads`` True and False) the gathered parameters and moments
within 1e-5 and the grad norm within 1e-6 of the unsharded port's.  The
sharded sums round otherwise than one device's: the gradients differ by
about 1.6e-6 (relative), so the first moment, (1 − b1)·g, cannot be held
closer; a parameter moves by lr·m̂/(√n̂ + eps), which near |g| ≈ eps
turns those last bits into up to ~4% of lr.  Decode logits within 1e-5
(absolute) of the unsharded decode.  The MoE within 1e-5 of the port's
local path and 1e-4 of JAX's (the reference's own bound).  A save on
(2, 4) restores on (4, 2) and on no mesh with identical values, and a
resume on the same mesh continues bitwise.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import lm_mesh_ranks as R  # noqa: E402
from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.distributed.sharding import boxed_axes, unbox  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro.models import whisper as jwh  # noqa: E402
from repro_torch.ckpt.manager import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.distributed.world import free_port, run_world  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.launch.shapes import SHAPES, build_cell  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.train import optim  # noqa: E402
from repro_torch.train.step import make_train_step  # noqa: E402

SHAPES_MESH = ((1, 2), (2, 1), (2, 2), (2, 4))
B, S = 4, 16
TIMEOUT = 240


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def assert_rel(got, want, tol, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            assert_rel(got[k], want[k], tol, f"{path}/{k}")
        return
    assert np.shape(got) == np.shape(want), path
    assert rel(got, want) <= tol, (path, rel(got, want))


@pytest.fixture(scope="module")
def ref():
    """JAX's parameters and loss, the batches, and the unsharded port's
    loss, gradients, two train steps and decode."""
    jcfg = jax_get_config("llama3.2-3b").reduced().replace(
        dtype="float32", n_heads=12, n_kv_heads=4, n_layers=2, attn_chunk=8)
    cfg = R.llama_cfg()
    jparams = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    pn = jax.tree.map(np.asarray, unbox(jparams))
    rng = np.random.default_rng(0)
    batches = [{k: rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
                for k in ("tokens", "targets")} for _ in range(2)]
    jloss = float(jlm.lm_loss(jparams, jcfg, {
        k: jnp.asarray(v) for k, v in batches[0].items()}))
    params = lm_params_from_numpy(pn, device="cpu", stacked=True)
    loss, grads = R.value_and_grads(params, cfg, {
        k: torch.from_numpy(v) for k, v in batches[0].items()})
    out = dict(pn=pn, batches=batches, jloss=jloss, loss=float(loss),
               grads=R.np_tree(grads))
    for key, opt in (("steps_True", dict(shard_grads=True)),
                     ("steps_False", dict(shard_grads=False)),
                     ("steps_int8_ef", dict(grad_compression="int8_ef"))):
        oc = optim.OptimConfig(**R.STEPS_OPT, **opt)
        p = lm_params_from_numpy(pn, device="cpu", stacked=True)
        st = optim.init_opt_state(p, oc)
        step, rows = make_train_step(cfg, oc, 2), []
        for b in batches[:1 if key == "steps_int8_ef" else 2]:
            p, st, m = step(p, st, {k: torch.from_numpy(v)
                                    for k, v in b.items()})
            rows.append(dict(params=R.np_tree(p), mu=R.np_tree(st.mu),
                             nu=R.np_tree(st.nu),
                             grad_norm=float(m["grad_norm"]),
                             loss=float(m["loss"])))
        out[key] = rows
    cache = lm.init_cache(cfg, B, 16, device="cpu")
    logits = []
    with torch.no_grad():
        for i in range(R.DECODE_STEPS):
            lg, cache = lm.decode_step(params, cfg, torch.from_numpy(
                batches[0]["tokens"][:, i:i + 1]), cache, i)
            logits.append(lg.numpy())
    out["decode"] = np.stack(logits)
    # the MoE: JAX's reduced dbrx-132b expert weights and one input
    mj = jax_get_config("dbrx-132b").reduced().replace(
        dtype="float32", moe_capacity_factor=100.0)
    jp = JMOE.init_moe(jax.random.PRNGKey(3), mj, jnp.float32)
    mp = jax.tree.map(np.asarray, unbox(jp))
    x = rng.standard_normal((B, 8, mj.d_model)).astype(np.float32)
    jy, _ = JMOE.apply_moe(jp, mj, jnp.asarray(x))
    tp = {k: torch.from_numpy(v.copy()) for k, v in mp.items()}
    y, _ = MOE.apply_moe(tp, R.moe_cfg(), torch.from_numpy(x))
    # the aux loss on a mesh is that of the rank's own rows (data rank 0:
    # the first half), averaged over "model", as the reference's
    _, aux = MOE.apply_moe(tp, R.moe_cfg(), torch.from_numpy(x[:B // 2]))
    out["moe"] = dict(p=mp, x=x, jax_y=np.asarray(jy), y=y.numpy(),
                      aux=float(aux))
    return out


@pytest.fixture(scope="module")
def worlds(ref, tmp_path_factory):
    """One spawned world a mesh shape, run on first use."""
    cache = {}
    ckpt = str(tmp_path_factory.mktemp("elastic"))

    def get(shape):
        if shape not in cache:
            extra = {}
            if shape == (2, 4):
                extra = {"moe": (ref["moe"]["p"], ref["moe"]["x"]),
                         "ckpt": ckpt}
            if shape == (2, 2):
                extra = {"spy": True}
            cache[shape] = run_world(R.mesh_world, shape[0] * shape[1], (
                shape, ref["pn"], ref["batches"], extra), timeout=TIMEOUT)[0]
        return cache[shape]
    get.ckpt = ckpt
    return get


# ------------------------------------------------------- axes, no spawn
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_axes_equal_the_references_boxed_axes(arch):
    jcfg = jax_get_config(arch).reduced()
    init = jwh.init_params if jcfg.family == "encdec" else jlm.init_params
    shapes = jax.eval_shape(lambda k: init(k, jcfg), jax.random.PRNGKey(0))
    want = jax.tree.map(tuple, boxed_axes(shapes),
                        is_leaf=lambda x: isinstance(x, tuple))
    cfg = get_config(arch).reduced()
    assert lm.param_axes(cfg) == want
    # the per-layer form: one copy a layer, the stacking axis dropped
    flat = lm.param_axes(cfg, stacked=False)
    key = {"encdec": "dec", "ssm": "groups", "hybrid": "triples"}.get(
        cfg.family, "blocks")
    assert isinstance(flat[key], list) and len(flat[key]) > 0


@pytest.mark.parametrize("arch", ("llama3.2-3b", "qwen3-moe-30b-a3b"))
def test_param_pspecs_equal_the_references_on_the_production_meshes(arch):
    """``param_pspecs`` of the full config's Boxed tree (meta tensors and
    ``param_axes``) on (16, 16) and (2, 16, 16) equals the reference's
    on the same layouts (both read only a mesh's names and sizes)."""
    from types import SimpleNamespace
    from repro.distributed.sharding import param_pspecs as jax_pspecs
    from repro_torch.distributed.sharding import (box, boxed_axes,
                                                  param_pspecs, param_shardings,
                                                  unbox, zip_map)
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    jtree = jax.eval_shape(lambda k: jlm.init_params(k, jcfg),
                           jax.random.PRNGKey(0))
    meta = lm.init_params(cfg, torch.Generator().manual_seed(0),
                          stacked=True, device="meta")
    tree = zip_map(lambda x, ax: box(x, *ax), meta, lm.param_axes(cfg))
    assert boxed_axes(tree) == lm.param_axes(cfg) and unbox(tree) == meta
    for shape, names in (((16, 16), ("data", "model")),
                         ((2, 16, 16), ("pod", "data", "model"))):
        jmesh = SimpleNamespace(axis_names=names, devices=np.empty(shape))
        mesh = SimpleNamespace(axis_names=names,
                               sizes=dict(zip(names, shape)))
        want = jax.tree.map(tuple, jax_pspecs(jtree, jmesh),
                            is_leaf=lambda x: isinstance(
                                x, jax.sharding.PartitionSpec))
        assert param_pspecs(tree, mesh) == want
        same = zip_map(lambda sh, w: sh.spec == w,
                       param_shardings(tree, mesh), want)
        assert all(optim.tree_leaves(same))


def test_meshes_need_a_world_and_the_production_layouts():
    """No process group: the meshes raise, never falling back; with a
    fake world of 256 (512) ranks the production mesh lays them out
    row-major over (16, 16) ((2, 16, 16)), one group a row and column."""
    with pytest.raises(RuntimeError, match="initialized process group"):
        M.make_smoke_mesh(device="cpu")
    with pytest.raises(ValueError, match="has None"):
        M.make_production_mesh()
    assert M.collective_backend("cpu") == "gloo"
    for multi, world, rank, coords in (
            (False, 256, 37, {"data": 2, "model": 5}),
            (True, 512, 300, {"pod": 1, "data": 2, "model": 12})):
        with R.fake_world(rank, world):
            with pytest.raises(ValueError, match=f"has {world}"):
                M.make_production_mesh(multi_pod=not multi, device="cpu")
            m = M.make_production_mesh(multi_pod=multi, device="cpu")
            assert m.coords == coords and m.size == world
            assert m.members["model"] == tuple(
                range(rank - coords["model"], rank - coords["model"] + 16))
            assert m.members["data"] == tuple(
                rank - 16 * coords["data"] + 16 * i for i in range(16))
            with M.use_mesh(m):
                assert lm.mesh_for(R.llama_cfg().replace(
                    n_heads=32, n_kv_heads=16, d_ff=512)) is m
            with pytest.raises(ValueError, match="needs 4 ranks"):
                M.make_smoke_mesh((2, 2), device="cpu")


def test_the_ambient_mesh_is_seen_from_every_thread():
    """Autograd runs a CUDA graph's backward, and remat's recompute of a
    layer, on a device thread of its own: the mesh use_mesh installs must
    be the ambient mesh there too (with a per-thread one the recompute
    dropped its collectives and every gradient under a layer came out
    wrong on the card), and it is restored on exit."""
    import threading
    from repro_torch.distributed.sharding import get_abstract_mesh
    seen = []
    mesh = object()
    with M.use_mesh(mesh):
        t = threading.Thread(target=lambda: seen.append(get_abstract_mesh()))
        t.start()
        t.join()
        with M.use_mesh(None):
            assert get_abstract_mesh() is None
        assert get_abstract_mesh() is mesh
    assert seen == [mesh] and get_abstract_mesh() is None


def test_no_collective_without_a_mesh(monkeypatch):
    """Off a mesh the layers, the loss, the step and the optimizer issue
    nothing (every collective of torch.distributed raises here)."""
    import torch.distributed as dist

    def boom(*a, **k):
        raise AssertionError("a collective without a mesh")
    for name in ("all_reduce", "all_gather", "all_gather_into_tensor",
                 "reduce_scatter_tensor", "broadcast", "barrier"):
        monkeypatch.setattr(dist, name, boom)
    cfg = R.llama_cfg()
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            stacked=True)
    oc = optim.OptimConfig(**R.STEPS_OPT)
    batch = {k: torch.zeros(4, 8, dtype=torch.int32)
             for k in ("tokens", "targets")}
    _, _, m = make_train_step(cfg, oc, 2)(params, optim.init_opt_state(
        params, oc), batch)
    assert np.isfinite(float(m["loss"]))
    g = {"w": torch.ones(2)}
    assert optim.constrain_grads_zero1(g) is g


# ----------------------------------------------------------- the worlds
@pytest.mark.parametrize("shape", SHAPES_MESH)
def test_loss_matches_jax_unsharded(shape, worlds, ref):
    got = worlds(shape)["loss"]
    assert abs(got - ref["jloss"]) <= 1e-5 * abs(ref["jloss"])


@pytest.mark.parametrize("shape", SHAPES_MESH)
def test_gradients_match_the_unsharded_port(shape, worlds, ref):
    assert_rel(worlds(shape)["grads"], ref["grads"], 1e-5)


@pytest.mark.parametrize("shard_grads", (True, False))
@pytest.mark.parametrize("shape", SHAPES_MESH)
def test_train_steps_match_the_unsharded_port(shape, shard_grads, worlds,
                                              ref):
    got, want = worlds(shape)[f"steps_{shard_grads}"], ref[
        f"steps_{shard_grads}"]
    for g, w in zip(got, want):
        for key in ("params", "mu", "nu"):
            assert_rel(g[key], w[key], 1e-5, key)
        assert abs(g["grad_norm"] - w["grad_norm"]) <= 1e-6 * w["grad_norm"]
        assert abs(g["loss"] - w["loss"]) <= 1e-5 * w["loss"]


@pytest.mark.parametrize("shape", SHAPES_MESH)
def test_decode_matches_the_unsharded_port(shape, worlds, ref):
    got = worlds(shape)["decode"]
    assert got.shape == ref["decode"].shape
    assert np.abs(got - ref["decode"]).max() <= 1e-5


def test_expert_parallel_moe(worlds, ref):
    """apply_moe on (2, 4): 2 of dbrx's 8 experts a rank, capacity factor
    100 (no drops); E = 6 on 4 model ranks raises the reference's
    ValueError."""
    y, aux = worlds((2, 4))["moe"]
    m = ref["moe"]
    assert np.abs(y - m["y"]).max() <= 1e-5 * np.abs(m["y"]).max()
    assert np.abs(y - m["jax_y"]).max() <= 1e-4
    assert abs(aux - m["aux"]) <= 1e-6
    kind, msg = worlds((2, 4))["moe_raise"]
    assert kind == "ValueError" and "n_experts=6 not divisible by model=4" \
        in msg


def test_elastic_restore_on_another_mesh_and_on_none(worlds):
    """A checkpoint written on (2, 4) restores on (4, 2), and on no mesh,
    with identical values; on (2, 4) a resume continues bitwise."""
    w = worlds((2, 4))
    assert w["resume_bitwise"]
    saved = w["saved"]
    other = run_world(R.restore_world, 8, ((4, 2), worlds.ckpt),
                      timeout=TIMEOUT)[0]
    assert other["step"] == 1
    cfg = R.llama_cfg()
    params = lm.init_params(cfg, torch.Generator().manual_seed(2),
                            stacked=True)
    oc = optim.OptimConfig(**R.STEPS_OPT)
    none = CheckpointManager(worlds.ckpt).restore(1, {
        "params": params, "opt": optim.init_opt_state(params, oc)})
    for got in (other, dict(params=R.np_tree(none["params"]),
                            mu=R.np_tree(none["opt"].mu),
                            nu=R.np_tree(none["opt"].nu))):
        for key in ("params", "mu", "nu"):
            for a, b in zip(optim.tree_leaves(got[key]),
                            optim.tree_leaves(saved[key])):
                assert np.array_equal(a, b), key


def test_a_mesh_save_gathers_one_leaf_at_a_time(worlds):
    """An elastic save on (2, 4) holds at most one leaf's global tensor
    beyond the shards: each is copied to the host (rank 0) or dropped
    before the next is gathered."""
    peak, gathered = worlds((2, 4))["save_gathered_at_once"]
    assert gathered > 1 and peak == 1


def test_int8_ef_compression_scales_each_leaf_by_its_whole_max(worlds,
                                                              ref):
    """One step under ``grad_compression="int8_ef"`` on (2, 2): each ZeRO
    slice is quantized with its whole leaf's scale (a max over the
    slices), so the step follows the unsharded one.  A gradient entry
    whose last bits differ can round to a neighbouring int8 step (1/127
    of the leaf's max), so the first moment is held within 2 steps of its
    leaf's largest entry and the parameters within 2·lr, as
    ``test_torch_train.py`` holds JAX's."""
    got = worlds((2, 2))["steps_int8_ef"][0]
    want = ref["steps_int8_ef"][0]
    for g, w in zip(optim.tree_leaves(got["mu"]),
                    optim.tree_leaves(want["mu"])):
        assert np.abs(g - w).max() <= 2 / 127 * np.abs(w).max()
    for g, w in zip(optim.tree_leaves(got["params"]),
                    optim.tree_leaves(want["params"])):
        assert np.abs(g - w).max() <= 2 * R.STEPS_OPT["lr"]
    assert abs(got["grad_norm"] - want["grad_norm"]) <= \
        1e-5 * want["grad_norm"]


def test_bf16_compression_keeps_the_wire_and_the_accumulator_bf16(worlds):
    """The tensors handed to the "data" collectives of the gradient
    reduction, and the accumulator: bf16 under grad_compression="bf16",
    float32 under "none" on the float32 model (the counterpart of the
    reference's HLO check)."""
    spy = worlds((2, 2))["spy"]
    assert spy["bf16"] == {"wire": ["torch.bfloat16"],
                           "acc": ["torch.bfloat16"]}
    assert spy["none"] == {"wire": ["torch.float32"],
                           "acc": ["torch.float32"]}


def test_what_is_not_ported_raises_naming_9b(worlds, tmp_path):
    """On a mesh the ssm, moe and encdec families' entry points, the
    dry run's cells and ``dryrun --mesh`` still raise, naming ROADMAP
    item 9b (kv_heads that do not divide "model" now run: the head-dim
    path, ``test_torch_hybrid_mesh.py``)."""
    got = worlds((2, 2))["not_ported"]
    assert set(got) == {"xlstm-1.3b", "qwen3-moe-30b-a3b", "whisper-base"}
    for arch, (kind, msg) in got.items():
        assert kind == "NotImplementedError" and "9b" in msg, (arch, msg)
    cfg = get_config("llama3.2-3b").reduced()
    with pytest.raises(NotImplementedError, match="9b"):
        build_cell(cfg, SHAPES["train_4k"], mesh=object())
    with pytest.raises(NotImplementedError, match="9b"):
        dryrun.main(["--sweep", "--mesh", "multi", "--out", str(tmp_path)])


def test_launcher_on_the_smoke_mesh_checkpoints_and_resumes(tmp_path):
    """``launch/train.py --mesh smoke`` on 4 gloo CPU ranks (deepseek-7b
    reduced: its 4 kv_heads divide the model axis): 3 steps with
    checkpoints at 2 and 3; the step-3 file removed, a rerun resumes from
    step 2 to 3, every rank's shards bitwise the first run's; only rank 0
    prints, and names the backend."""
    d = str(tmp_path / "ck")
    argv = ["--arch", "deepseek-7b", "--reduced", "--mesh", "smoke",
            "--device", "cpu", "--dtype", "float32", "--batch", "4",
            "--seq", "16", "--log-every", "1", "--steps", "3",
            "--ckpt-dir", d, "--ckpt-every", "2"]
    out = run_world(R.launcher_world, 4, (
        [(argv, free_port()), (argv, free_port())],
        os.path.join(d, "ckpt_0000000003.npz")), backend=None,
        timeout=TIMEOUT)
    for rank, (first, resumed) in enumerate(out):
        for a, b in zip(first[0], resumed[0]):
            assert np.array_equal(a, b)
        if rank:
            assert first[1] == resumed[1] == ""
    first, resumed = out[0][0][1], out[0][1][1]
    assert "backend=gloo" in first and "step=3" in first
    assert "resumed from step 2" in resumed and "step=3" in resumed
    assert CheckpointManager(d).all_steps() == [2, 3]

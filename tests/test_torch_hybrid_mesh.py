"""recurrentgemma-9b (the hybrid family) across a ("data", "model") mesh,
and the head-dim-sharded attention where kv_heads do not divide "model",
on gloo CPU worlds of 4 ranks (``distributed/world.py::run_world``; the
ranks run ``lm_mesh_ranks.py::hybrid_world``, which imports no JAX).

The model is the reduced recurrentgemma-9b in float32: one (rec, rec,
attn) triple, 4 heads on 1 kv_head (which divides no model axis, so the
attention splits by head dim: hd 32 → 16 or 8 a rank), lru 128, window
64; its parameters JAX's, carried across.  One world a mesh shape, (2, 2)
and (1, 4), each spawned once; (2, 2) runs first, since (1, 4) restores
its checkpoint.  The JAX side and the unsharded port run here.

Tolerances, those of ``test_torch_lm_mesh.py`` for the dense family (per
leaf, relative: ‖got − want‖ / ‖want‖): the loss within 1e-5 of JAX's
unsharded ``lm_loss``; the gradients, reduced over "data" and gathered,
within 1e-5 of the unsharded port's; after one and two train steps
(grad_accum 2, ZeRO-1) the gathered parameters and moments within 1e-5,
the grad norm within 1e-6 and the loss within 1e-5 of the unsharded
port's.  The decode (72 steps of a schedule with idle rows and a late
start, so the 64-slot ring wraps) within 1e-5 (absolute) of the
unsharded port's logits and within 1e-5 of JAX's ``decode_step`` (max
|Δ| over max |logit|, ``test_torch_lm.py``'s bound): idle rows included,
whose recurrent states advance on their tokens (C17).  A save on (2, 2)
restores on (1, 4) and on no mesh with identical values.  The dense
family's head-dim path (the llama of ``test_torch_lm_mesh.py`` on 2
kv_heads, on (1, 4)) is held to the same bounds against the unsharded
port.  K8 + K9's plain versions, the scores summed over head-dim slices,
equal whole-head-dim attention within 1e-5 in float32 and 2e-2 in bf16.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import lm_mesh_ranks as R  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.distributed.sharding import unbox  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.ckpt.manager import CheckpointManager  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.distributed.sharding import pspec  # noqa: E402
from repro_torch.distributed.world import run_world  # noqa: E402
from repro_torch.kernels.flash import kernel as K  # noqa: E402
from repro_torch.kernels.flash.ref import (flash_attention_fwd_ref,  # noqa: E402
                                           flash_decode_pv_ref,
                                           flash_decode_scores_ref)
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.train import optim  # noqa: E402
from repro_torch.train.step import make_train_step  # noqa: E402

SHAPES = ((2, 2), (1, 4))
B, S = 4, 16
DECODE, MAX_LEN = 72, 80            # the ring holds min(80, 64) slots
DENSE_DECODE, DENSE_MAX_LEN = 8, 16
TIMEOUT = 240
TOL = dict(loss=1e-5, grads=1e-5, state=1e-5, grad_norm=1e-6, decode=1e-5,
           jax_decode=1e-5)


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


def schedule(b, n):
    """(n, b) positions: row 0 every step, row 1 idle every third step
    and otherwise at step // 2 (a position written twice), row 2 idle
    until step 5, row 3 every step."""
    pos = np.zeros((n, b), np.int32)
    for i in range(n):
        pos[i] = [i, -1 if i % 3 == 1 else i // 2, i if i >= 5 else -1, i]
    return pos


def port_decode(cfg, params, toks, pos, max_len):
    cache = lm.init_cache(cfg, toks.shape[0], max_len, device="cpu")
    out = []
    with torch.no_grad():
        for i in range(pos.shape[0]):
            lg, cache = lm.decode_step(params, cfg, torch.from_numpy(
                toks[:, i:i + 1]), cache, torch.from_numpy(pos[i]))
            out.append(lg.numpy())
    return np.stack(out), cache


def port_steps(cfg, pn, batches):
    oc = optim.OptimConfig(**R.STEPS_OPT)
    p = lm_params_from_numpy(pn, device="cpu", stacked=True)
    st = optim.init_opt_state(p, oc)
    step, rows = make_train_step(cfg, oc, 2), []
    for b in batches:
        p, st, m = step(p, st, {k: torch.from_numpy(v) for k, v in b.items()})
        rows.append(dict(params=R.np_tree(p), mu=R.np_tree(st.mu),
                         nu=R.np_tree(st.nu), grad_norm=float(m["grad_norm"]),
                         loss=float(m["loss"])))
    return rows


@pytest.fixture(scope="module")
def ref():
    """JAX's hybrid parameters, loss and decode; the batches and the
    schedule; the unsharded port's loss, gradients, train steps and
    decode, of the hybrid and of the dense llama on 2 kv_heads."""
    jcfg = jax_get_config("recurrentgemma-9b").reduced().replace(
        dtype="float32", attn_chunk=8)
    cfg = R.hybrid_cfg()
    jparams = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    pn = jax.tree.map(np.asarray, unbox(jparams))
    rng = np.random.default_rng(0)
    batches = [{k: rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
                for k in ("tokens", "targets")} for _ in range(2)]
    toks = rng.integers(0, cfg.vocab_size, (B, DECODE)).astype(np.int32)
    pos = schedule(B, DECODE)
    jloss = float(jlm.lm_loss(jparams, jcfg, {
        k: jnp.asarray(v) for k, v in batches[0].items()}))
    step = jax.jit(lambda t, c, i: jlm.decode_step(jparams, jcfg, t, c, i))
    jcache, jdec = jlm.init_cache(jcfg, B, MAX_LEN), []
    for i in range(DECODE):
        lg, jcache = step(jnp.asarray(toks[:, i:i + 1]), jcache,
                          jnp.asarray(pos[i]))
        jdec.append(np.asarray(lg))
    params = lm_params_from_numpy(pn, device="cpu", stacked=True)
    loss, grads = R.value_and_grads(params, cfg, {
        k: torch.from_numpy(v) for k, v in batches[0].items()})
    dec, cache = port_decode(cfg, params, toks, pos, MAX_LEN)
    hybrid = dict(params=pn, batches=batches, decode=(toks, pos, MAX_LEN))
    out = dict(jloss=jloss, jdecode=np.stack(jdec), loss=float(loss),
               grads=R.np_tree(grads), steps=port_steps(cfg, pn, batches),
               decode=dec, cache=cache)
    # the dense head-dim path: the llama on 2 kv_heads, the port's draws
    dcfg = R.dense_kv2_cfg()
    dn = R.np_tree(lm.init_params(dcfg, torch.Generator().manual_seed(1),
                                  stacked=True))
    dp = lm_params_from_numpy(dn, device="cpu", stacked=True)
    dloss, dgrads = R.value_and_grads(dp, dcfg, {
        k: torch.from_numpy(v) for k, v in batches[0].items()})
    dpos = schedule(B, DENSE_DECODE)
    dense = dict(params=dn, batches=batches,
                 decode=(toks[:, :DENSE_DECODE], dpos, DENSE_MAX_LEN))
    out["dense"] = dict(loss=float(dloss), grads=R.np_tree(dgrads),
                        decode=port_decode(dcfg, dp, toks, dpos,
                                           DENSE_MAX_LEN)[0])
    out["inputs"] = dict(hybrid=hybrid, dense=dense)
    return out


@pytest.fixture(scope="module")
def worlds(ref, tmp_path_factory):
    """The (2, 2) world, then the (1, 4) world, which restores (2, 2)'s
    checkpoint; each on first use."""
    cache = {}
    ckpt = str(tmp_path_factory.mktemp("hybrid_elastic"))

    def get(shape):
        for s in SHAPES[:SHAPES.index(shape) + 1]:
            if s not in cache:
                cache[s] = run_world(R.hybrid_world, 4, (
                    s, ref["inputs"], ckpt), timeout=TIMEOUT)[0]
        return cache[shape]
    get.ckpt = ckpt
    return get


# ----------------------------------------------------------- the worlds
@pytest.mark.parametrize("shape", SHAPES)
def test_loss_matches_jax_unsharded(shape, worlds, ref):
    got = worlds(shape)["loss"]
    assert abs(got - ref["jloss"]) <= TOL["loss"] * abs(ref["jloss"])
    assert abs(ref["loss"] - ref["jloss"]) <= TOL["loss"] * abs(ref["jloss"])


@pytest.mark.parametrize("shape", SHAPES)
def test_gradients_match_the_unsharded_port(shape, worlds, ref):
    assert_rel(worlds(shape)["grads"], ref["grads"], TOL["grads"])


@pytest.mark.parametrize("shape", SHAPES)
def test_train_steps_match_the_unsharded_port(shape, worlds, ref):
    for g, w in zip(worlds(shape)["steps"], ref["steps"]):
        for key in ("params", "mu", "nu"):
            assert_rel(g[key], w[key], TOL["state"], key)
        assert abs(g["grad_norm"] - w["grad_norm"]) <= \
            TOL["grad_norm"] * w["grad_norm"]
        assert abs(g["loss"] - w["loss"]) <= TOL["loss"] * w["loss"]


@pytest.mark.parametrize("shape", SHAPES)
def test_decode_past_the_window_matches_the_unsharded_port(shape, worlds,
                                                           ref):
    got = worlds(shape)["decode"]
    assert got.shape == ref["decode"].shape == (DECODE, B, 512)
    assert np.abs(got - ref["decode"]).max() <= TOL["decode"]


@pytest.mark.parametrize("shape", SHAPES)
def test_decode_matches_jax_with_idle_rows(shape, worlds, ref):
    """Every row's logits, idle rows' too (C9's mean of v, and C17: their
    recurrent states advance on their tokens, as JAX's do)."""
    got, want = worlds(shape)["decode"], ref["jdecode"]
    assert np.abs(got - want).max() <= TOL["jax_decode"] * np.abs(want).max()


CACHE_AXES = {"attn": {"k": (None, "batch", None, "kv_heads", "head"),
                       "v": (None, "batch", None, "kv_heads", "head"),
                       "pos": (None, "batch", None)},
              "rec": {"conv": (None, "batch", None, "lru"),
                      "h": (None, "batch", "lru")}}


@pytest.mark.parametrize("shape", SHAPES)
def test_cache_leaves_are_this_ranks_shard_of_the_pspec(shape, worlds, ref):
    """The decode cache's local leaves are the shards of the global
    cache's leaves under the reference's axes: ("batch", None, "kv_heads",
    "head") for the ring (one kv head: the head dim takes "model") and
    the "lru" axes for the recurrent states."""
    sizes = dict(zip(("data", "model"), shape))
    got = worlds(shape)["cache_shapes"]["triples"]
    for kind, leaves in ref["cache"]["triples"].items():
        axes = CACHE_AXES["attn" if kind == "attn" else "rec"]
        for name, full in leaves.items():
            spec = pspec(full.shape, axes[name], ("data", "model"), sizes)
            want = tuple(n // (sizes[e] if e else 1)
                         for n, e in zip(full.shape, spec))
            assert tuple(got[kind][name]) == want, (kind, name, spec)
    attn = got["attn"]["k"]
    assert attn[-2:] == (1, 32 // shape[1])


def test_elastic_save_on_2x2_restores_on_1x4_and_on_none(worlds):
    saved = worlds((2, 2))["saved"]
    other = worlds((1, 4))["restored"]
    assert other["step"] == 1
    cfg = R.hybrid_cfg()
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


@pytest.mark.parametrize("what", ("loss", "grads", "decode"))
def test_dense_head_dim_path_on_1x4(what, worlds, ref):
    """The llama on 2 kv_heads on a model axis of 4: q by heads (3 a
    rank), k/v and the cache by head dim (8 of 32 a rank), each rank's
    heads on the one KV head they read."""
    got, want = worlds((1, 4))["dense"][what], ref["dense"][what]
    if what == "loss":
        assert abs(got - want) <= TOL["loss"] * abs(want)
    elif what == "grads":
        assert_rel(got, want, TOL["grads"])
    else:
        assert np.abs(got - want).max() <= TOL["decode"]


def test_rope_on_a_head_dim_slice_is_caught(worlds, ref):
    """With ``layers._whole_k`` replaced by a double that rotates each
    rank's slice (pairs within the slice, as a port that rotated before
    gathering would) the decode check fails by far; the sound path
    passes it."""
    bad = worlds((1, 4))["rope_on_a_slice"]
    assert np.abs(worlds((1, 4))["decode"] - ref["decode"]).max() <= \
        TOL["decode"]
    assert np.abs(bad - ref["decode"]).max() > 100 * TOL["decode"]


# ------------------------------------------------- axes, no spawn
@pytest.mark.parametrize("shape", ((1, 2), (2, 2), (1, 4), (16, 16)))
def test_resolved_axes_read_a_local_shard_back_exactly(shape):
    """On a mesh ``lm.param_axes`` names no axis that the mesh does not
    give a leaf (one kv head: ``wk`` and ``wv`` split by head dim), so
    every local shard of recurrentgemma-9b's tree reads back its global
    shape (``global_shape``: ZeRO layouts, gathers, checkpoints), with
    the reference's partition specs unchanged."""
    from types import SimpleNamespace
    from repro_torch.distributed.sharding import (NamedSharding,
                                                  global_shape, zip_map)
    from repro_torch.configs import get_config
    names = ("data", "model")
    mesh = SimpleNamespace(axis_names=names, sizes=dict(zip(names, shape)),
                           coords=dict.fromkeys(names, 0))
    mesh.axis_size = lambda a: mesh.sizes.get(a, 1)
    cfg = get_config("recurrentgemma-9b")
    meta = lm.init_params(cfg, torch.Generator(), stacked=True,
                          device="meta")
    raw, got = lm.param_axes(cfg), lm.param_axes(cfg, mesh=mesh)
    assert got["triples"]["attn"]["attn"]["wk"] == (None, "embed", None,
                                                    "head")

    def one(x, axes):
        ax, resolved = axes
        spec = pspec(x.shape, ax, names, mesh.sizes)
        assert pspec(x.shape, resolved, names, mesh.sizes) == spec
        local = NamedSharding(mesh, spec).local_shape(x.shape)
        assert global_shape(local, resolved, mesh) == tuple(x.shape)
        return spec
    specs = zip_map(one, meta, pairs(raw, got))
    wk = specs["triples"]["attn"]["attn"]["wk"]
    assert wk == (None, None, None, "model" if shape[1] > 1 else None)


def pairs(a, b):
    """Two axes trees of one structure → one tree of (a, b) leaves."""
    if isinstance(a, dict):
        return {k: pairs(a[k], b[k]) for k in a}
    return (a, b)


# ------------------------------------------- K8 + K9's plain versions
def decode_inputs(rng, hd, dtype, b=4, length=24, nh=6, kh=2):
    """Sq = 1 over a cache with ragged positions, empty slots (−1), the
    trash slot L−1 (−1) and an idle last row (query at −1)."""
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(dtype) for shape in ((b, 1, nh, hd),
                                             (b, length, kh, hd),
                                             (b, length, kh, hd)))
    kv_pos = np.full((b, length), -1, np.int32)
    q_pos = np.full((b, 1), -1, np.int32)
    for r in range(b - 1):
        n = int(rng.integers(2, length - 1))
        kv_pos[r, :n] = rng.permutation(n) + 3 * r    # a ring's order
        q_pos[r, 0] = n - 1 + 3 * r
    return q, k, v, torch.from_numpy(q_pos), torch.from_numpy(kv_pos)


def split_attention(q, k, v, q_pos, kv_pos, window, m):
    """The head-dim path on m slices: partial scores summed, then K9 on
    each slice, concatenated."""
    hd = q.shape[-1]
    d = hd // m
    cut = [slice(i * d, (i + 1) * d) for i in range(m)]
    s = sum(K.flash_decode_scores(q[..., c].contiguous(),
                                  k[..., c].contiguous()) for c in cut)
    return torch.cat([K.flash_decode_pv(s, v[..., c].contiguous(), q_pos,
                                        kv_pos, causal=True,
                                        window=window or None,
                                        scale=hd ** -0.5) for c in cut], -1)


@pytest.mark.parametrize("window", (0, 7))
@pytest.mark.parametrize("hd", (32, 256))
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_split_decode_plain_versions_equal_whole_head_dim_attention(
        dtype, hd, window):
    tol = {"float32": 1e-5, "bfloat16": 2e-2}[dtype]
    rng = np.random.default_rng(hd + window)
    q, k, v, q_pos, kv_pos = decode_inputs(rng, hd, getattr(torch, dtype))
    K.reset_launch_counts()
    got = split_attention(q, k, v, q_pos, kv_pos, window, m=4)
    assert K.launch_counts() == dict.fromkeys(K.LAUNCHES, 0)   # CPU: plain
    assert got.dtype == v.dtype and got.shape == q.shape
    whole = flash_attention_fwd_ref(q, k, v, q_pos, kv_pos, causal=True,
                                    window=window or None)
    assert (got.float() - whole.float()).abs().max() <= tol
    xla = L.attention_xla(q, k, v, causal=True, window=window,
                          q_pos=q_pos, kv_pos=kv_pos)
    live = (q_pos[:, 0] >= 0).numpy()
    assert live.sum() == 3
    assert (got.float() - xla.float())[live].abs().max() <= tol
    assert not got[~live].any()          # an idle row sees no key: 0


def test_split_decode_plain_pv_masks_as_k6():
    """K9's plain version with a window and without causality equals K6's
    plain version on the whole head dim (m = 1)."""
    rng = np.random.default_rng(3)
    q, k, v, q_pos, kv_pos = decode_inputs(rng, 32, torch.float32)
    s = flash_decode_scores_ref(q, k)
    for causal, window in ((False, None), (False, 5), (True, -1)):
        got = flash_decode_pv_ref(s, v, q_pos, kv_pos, causal=causal,
                                  window=window, scale=32 ** -0.5)
        want = flash_attention_fwd_ref(q, k, v, q_pos, kv_pos,
                                       causal=causal, window=window)
        assert (got - want).abs().max() <= 1e-5, (causal, window)

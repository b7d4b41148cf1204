"""Parity of the port's training step with the JAX package's on the CPU:
``data/synth.py`` (bitwise), ``train/optim.py`` (``lr_schedule``,
``global_norm``, ``apply_updates`` under each ``grad_compression``) and
``train/step.py`` (three steps of the reduced llama3.2-3b in float32
against JAX's jitted step, with and without microbatches, under each
compression).  JAX's parameters and optimizer state are carried across
(``convert.lm_params_from_numpy(stacked=True)``,
``convert.opt_state_from_numpy``).

Tolerances: the loss within 1e-5 (relative) a step; ``lr`` within one
float32 ulp (both compute it in float32, the reference also under this
session's x64; a cosine may round to the neighbour); without compression,
parameters within 1e-5 of max(max|leaf|, 1) and moments within 1e-5 of
their leaf's largest entry.  Compression rounds each gradient entry to a
grid (bfloat16: 2⁻⁸ of the entry; int8: 1/127 of the leaf's largest), and
gradients that differ in their last float32 bits (the packages sum in
other orders) can round to neighbouring points: so the first moment is
held within 2 grid steps of the leaf's largest entry, the second within
4, and the parameters within 2·lr (an entry whose rounded gradient is 0
on one side moves one step less), with at most 1e-4 of the entries past
1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.data import synth as jsynth  # noqa: E402
from repro.distributed.sharding import Boxed, is_boxed, unbox  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.train import optim as jopt  # noqa: E402
from repro.train.step import make_train_step as jax_make_train_step  # noqa: E402,E501
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import (lm_params_from_numpy,  # noqa: E402
                                 opt_state_from_numpy)
from repro_torch.data import synth  # noqa: E402
from repro_torch.train import optim  # noqa: E402
from repro_torch.train.step import make_train_step  # noqa: E402

B, S = 4, 32


def np_tree(tree):
    return jax.tree.map(np.asarray, unbox(tree))


def jax_state_np(state):
    return (np.asarray(state.step), np_tree(state.mu), np_tree(state.nu),
            np_tree(state.ef) if state.ef != () else ())


def assert_close(got, want, tol, path="", floor=1.0):
    """Per leaf: max|got − want| ≤ tol · max(max|want|, floor)."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            assert_close(got[k], want[k], tol, f"{path}/{k}", floor)
        return
    g = got.detach().double().numpy()
    w = np.asarray(want, np.float64)
    assert g.shape == w.shape, path
    err = np.abs(g - w).max()
    assert err <= tol * max(np.abs(w).max(), floor), (path, err)


def share_past(got, want, tol):
    """The share of entries (all leaves) with |got − want| > tol ·
    max(max|leaf|, 1)."""
    gl = optim.tree_leaves(got)
    wl = jax.tree.leaves(want)
    bad = sum(int((np.abs(g.detach().double().numpy() - np.asarray(w))
                   > tol * max(np.abs(np.asarray(w)).max(), 1.0)).sum())
              for g, w in zip(gl, wl))
    return bad / sum(np.asarray(w).size for w in wl)


def llama(dtype="float32"):
    jcfg = jax_get_config("llama3.2-3b").reduced().replace(dtype=dtype,
                                                          attn_chunk=8)
    jparams = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    cfg = get_config("llama3.2-3b").reduced().replace(dtype=dtype)
    return (jcfg, jparams), (cfg, lm_params_from_numpy(
        np_tree(jparams), device="cpu", stacked=True))


# ----------------------------------------------------------------- data
@pytest.mark.parametrize("arch", ["llama3.2-3b", "whisper-base"])
def test_synth_batch_bitwise_jax(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for seed in (0, 3):
        dc = synth.DataConfig(global_batch=3, seq_len=40, seed=seed)
        jdc = jsynth.DataConfig(global_batch=3, seq_len=40, seed=seed)
        it = synth.batch_iterator(cfg, dc, start_step=1)
        for step in range(4):
            a = synth.synth_batch(cfg, dc, step)
            b = jsynth.synth_batch(jcfg, jdc, step)
            assert set(a) == set(b)
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
            if step:
                nxt = next(it)
                for k in a:
                    np.testing.assert_array_equal(nxt[k], a[k])
    if cfg.family == "encdec":
        assert a["frames"].shape == (3, 20, cfg.d_model)


# ------------------------------------------------------------ optimizer
@pytest.mark.parametrize("warmup,total", [(100, 10_000), (1, 8), (5, 5)])
def test_lr_schedule_matches_jax(warmup, total):
    cfg = optim.OptimConfig(warmup_steps=warmup, total_steps=total)
    jcfg = jopt.OptimConfig(warmup_steps=warmup, total_steps=total)
    for step in (0, 1, 2, warmup, warmup + 1, total // 2, total, total + 3):
        want = jopt.lr_schedule(jcfg, jnp.asarray(step, jnp.int32))
        assert want.dtype == jnp.float32
        got = optim.lr_schedule(cfg, step)
        assert abs(got - float(want)) <= 2.0 ** -23 * float(want)


def test_global_norm_matches_jax():
    rng = np.random.default_rng(1)
    tree = {"b": rng.standard_normal((7, 3)).astype(np.float32),
            "a": {"y": rng.standard_normal(11).astype(np.float32),
                  "x": rng.standard_normal((2, 2)).astype(np.float32)}}
    want = float(jopt.global_norm(jax.tree.map(jnp.asarray, tree)))
    got = optim.global_norm(jax.tree.map(torch.from_numpy, tree))
    assert got.dtype == torch.float32
    assert abs(float(got) - want) <= 1e-6 * want
    assert [t.shape for t in optim.tree_leaves(
        jax.tree.map(torch.from_numpy, tree))] == [
        x.shape for x in jax.tree.leaves(tree)]


@pytest.mark.parametrize("compression", ["none", "bf16", "int8_ef"])
def test_apply_updates_matches_jax(compression):
    """Two updates from JAX's init with the same random gradients (one
    with a clipped norm): parameters, moments, residuals, grad norm."""
    (jcfg, jparams), (cfg, params) = llama()
    kw = dict(lr=1e-2, weight_decay=0.1, warmup_steps=1, total_steps=4,
              grad_compression=compression)
    jc, pc = jopt.OptimConfig(**kw), optim.OptimConfig(**kw)
    jstate = jopt.init_opt_state(jparams, jc)
    state = opt_state_from_numpy(jax_state_np(jstate), device="cpu")
    rng = np.random.default_rng(2)
    for scale in (1e-3, 10.0):
        g_np = jax.tree.map(
            lambda b: (rng.standard_normal(b.value.shape) * scale).astype(
                np.float32), jparams, is_leaf=is_boxed)
        jgrads = jax.tree.map(lambda b, g: Boxed(jnp.asarray(g), b.axes),
                              jparams, g_np, is_leaf=is_boxed)
        jparams, jstate, jm = jopt.apply_updates(jparams, jgrads, jstate, jc)
        grads = jax.tree.map(torch.from_numpy, g_np)
        params, state, m = optim.apply_updates(params, grads, state, pc)
        assert abs(float(m["grad_norm"]) - float(jm["grad_norm"])) <= \
            1e-6 * float(jm["grad_norm"])
        assert abs(m["lr"] - float(jm["lr"])) <= 2.0 ** -23 * m["lr"]
    assert int(state.step) == int(jstate.step) == 2
    assert_close(params, np_tree(jparams), 1e-6)
    assert_close(state.mu, np_tree(jstate.mu), 1e-6)
    assert_close(state.nu, np_tree(jstate.nu), 1e-6)
    if compression == "int8_ef":
        assert_close(state.ef, np_tree(jstate.ef), 1e-6)
    else:
        assert state.ef == ()


def test_mesh_raises_naming_the_roadmap():
    with pytest.raises(NotImplementedError, match="item 9b"):
        optim.constrain_grads_zero1({}, mesh=object())
    assert optim.zero1_pspec((None, "model"), (8, 4), ("data", "model"),
                             {"data": 2, "model": 2}) == ("data", "model")
    assert optim.zero1_pspec((None,), (8,), ("model",), {"model": 2}) == \
        (None,)


# ----------------------------------------------------------- train step
@pytest.mark.parametrize("grad_accum,compression", [
    (1, "none"), (2, "none"), (1, "bf16"), (2, "bf16"), (1, "int8_ef")])
def test_three_train_steps_match_jax(grad_accum, compression):
    (jcfg, jparams), (cfg, params) = llama()
    kw = dict(lr=3e-4, weight_decay=0.1, warmup_steps=1, total_steps=3,
              grad_compression=compression)
    jc, pc = jopt.OptimConfig(**kw), optim.OptimConfig(**kw)
    jstate = jopt.init_opt_state(jparams, jc)
    state = optim.init_opt_state(params, pc)
    jstep = jax.jit(jax_make_train_step(jcfg, jc, grad_accum))
    step = make_train_step(cfg, pc, grad_accum)
    dc = synth.DataConfig(global_batch=B, seq_len=S, seed=0)
    for i in range(3):
        nb = synth.synth_batch(cfg, dc, i)
        jparams, jstate, jm = jstep(jparams, jstate,
                                    {k: jnp.asarray(v) for k, v in nb.items()})
        params, state, m = step(
            params, state, {k: torch.from_numpy(v) for k, v in nb.items()})
        assert abs(float(m["loss"]) - float(jm["loss"])) <= \
            1e-5 * float(jm["loss"])
        assert abs(float(m["grad_norm"]) - float(jm["grad_norm"])) <= \
            1e-5 * float(jm["grad_norm"])
        assert abs(m["lr"] - float(jm["lr"])) <= 2.0 ** -23 * m["lr"]
    if compression == "none":
        assert_close(params, np_tree(jparams), 1e-5)
        assert_close(state.mu, np_tree(jstate.mu), 1e-5, floor=0.0)
        assert_close(state.nu, np_tree(jstate.nu), 1e-5, floor=0.0)
        return
    grid = 2.0 ** -8 if compression == "bf16" else 1.0 / 127
    assert_close(params, np_tree(jparams), 2 * pc.lr)
    assert share_past(params, np_tree(jparams), 1e-5) <= 1e-4
    assert_close(state.mu, np_tree(jstate.mu), 2 * grid, floor=0.0)
    assert_close(state.nu, np_tree(jstate.nu), 4 * grid, floor=0.0)


def test_bf16_model_steps_in_place_and_keeps_dtypes():
    """A bfloat16 model: one step updates the stacked leaves in place
    (same storages), parameters stay bfloat16, moments float32, the
    router-free dense tree has the reference's 12 leaves."""
    _, (cfg, params) = llama("bfloat16")
    pc = optim.OptimConfig(warmup_steps=1, total_steps=2)
    state = optim.init_opt_state(params, pc)
    ptrs = [p.data_ptr() for p in optim.tree_leaves(params)]
    nb = synth.synth_batch(cfg, synth.DataConfig(2, 16), 0)
    params, state, m = make_train_step(cfg, pc)(
        params, state, {k: torch.from_numpy(v) for k, v in nb.items()})
    leaves = optim.tree_leaves(params)
    assert [p.data_ptr() for p in leaves] == ptrs and len(leaves) == 12
    assert all(p.dtype == torch.bfloat16 for p in leaves)
    assert all(x.dtype == torch.float32 for x in optim.tree_leaves(state.mu))
    assert state.step.dtype == torch.int32 and int(state.step) == 1
    assert np.isfinite(float(m["loss"]))

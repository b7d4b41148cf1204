"""The port's shape cells (``repro_torch.launch.shapes``) against the JAX
package's (``repro.launch.shapes``), at full size for all ten archs:

* the parameters the port draws on the meta device equal JAX's
  ``params_shapes`` (unboxed ``jax.eval_shape``) leaf for leaf, shape
  and dtype, under ``convert.lm_params_from_numpy``'s key mapping (the
  same nested keys: the stacked tree);
* so do the optimizer state (``init_opt_state`` on meta against
  ``jax.eval_shape(init_opt_state)``), the decode caches of
  ``decode_32k`` and, for the hybrid and ssm families, ``long_500k``;
* ``cell_supported`` agrees on all 10 × 4 (arch, shape) pairs, and
  ``default_grad_accum`` gives one row a microbatch on one card.

Nothing is allocated on either side.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.distributed.sharding import unbox  # noqa: E402
from repro.launch import shapes as JS  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import whisper as jwh  # noqa: E402
from repro.train import optim as jopt  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.launch import shapes as PS  # noqa: E402
from repro_torch.train import optim  # noqa: E402


def _leaves(tree, path=""):
    """{path: (shape, dtype name)} of a nested dict / tuple / list tree of
    jax ShapeDtypeStructs or torch tensors."""
    if isinstance(tree, dict):
        out = {}
        for k in tree:
            out.update(_leaves(tree[k], f"{path}/{k}"))
        return out
    if isinstance(tree, (tuple, list)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_leaves(v, f"{path}/{i}"))
        return out
    dt = tree.dtype
    name = str(dt).replace("torch.", "") if isinstance(dt, torch.dtype) \
        else np.dtype(dt).name
    return {path: (tuple(tree.shape), name)}


def same_tree(port, ref):
    got, want = _leaves(port), _leaves(ref)
    assert set(got) == set(want), sorted(set(got) ^ set(want))
    bad = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
    assert not bad, bad


def jax_params(arch):
    return JS.params_shapes(jax_get_config(arch))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_params_and_opt_state_shapes_match_jax(arch):
    cfg = get_config(arch)
    params = PS.params_shapes(cfg)
    assert all(t.device.type == "meta" for t in optim.tree_leaves(params))
    jboxed = jax_params(arch)
    same_tree(params, unbox(jboxed))
    ocfg = optim.OptimConfig()
    state = optim.init_opt_state(params, ocfg)
    jstate = jax.eval_shape(
        lambda p: jopt.init_opt_state(p, jopt.OptimConfig()), jboxed)
    same_tree(state.mu, unbox(jstate.mu))
    same_tree(state.nu, unbox(jstate.nu))
    assert state.ef == jstate.ef == ()
    assert (tuple(state.step.shape), state.step.dtype) == ((), torch.int32)
    assert jstate.step.dtype == jnp.int32


def jax_cache(arch, shape):
    jcfg = jax_get_config(arch)
    b, s = shape.global_batch, shape.seq_len
    if jcfg.family != "encdec":
        return jax.eval_shape(lambda: jlm.init_cache(jcfg, b, s))
    enc = jax.ShapeDtypeStruct((b, PS.DECODE_ENC_LEN, jcfg.d_model),
                               jnp.dtype(jcfg.dtype))
    return jax.eval_shape(lambda p, e: jwh.init_cache(p, jcfg, e, b, s),
                          jax_params(arch), enc)


CACHE_CELLS = [(a, "decode_32k") for a in ARCH_IDS] + [
    (a, "long_500k") for a in ARCH_IDS
    if get_config(a).family in ("hybrid", "ssm")]


@pytest.mark.parametrize("arch,shape_name", CACHE_CELLS)
def test_decode_cache_shapes_match_jax(arch, shape_name):
    cfg, shape = get_config(arch), PS.SHAPES[shape_name]
    step, args = PS.build_cell(cfg, shape)
    params, tokens, cache, position = args
    same_tree(cache, jax_cache(arch, shape))
    assert tuple(tokens.shape) == (shape.global_batch, 1)
    assert position == shape.seq_len - 1
    assert all(t.device.type == "meta" for t in optim.tree_leaves(cache))


def test_cell_supported_agrees_and_grad_accum():
    for arch in ARCH_IDS:
        for name, shape in PS.SHAPES.items():
            assert PS.cell_supported(get_config(arch), shape) == \
                JS.cell_supported(jax_get_config(arch), JS.SHAPES[name]), \
                (arch, name)
    assert {k: (v.kind, v.seq_len, v.global_batch)
            for k, v in PS.SHAPES.items()} == \
        {k: (v.kind, v.seq_len, v.global_batch)
         for k, v in JS.SHAPES.items()}
    assert PS.default_grad_accum(PS.SHAPES["train_4k"]) == 256
    assert PS.default_grad_accum(PS.SHAPES["train_4k"], devices=4) == 64
    with pytest.raises(ValueError, match="500k"):
        PS.build_cell(get_config("llama3.2-3b"), PS.SHAPES["long_500k"])
    with pytest.raises(NotImplementedError, match="9b"):
        PS.build_cell(get_config("llama3.2-3b"), PS.SHAPES["train_4k"],
                      mesh=object())


def test_train_cell_batch_matches_the_reference_layout():
    """train_4k on meta: (256, 4096) tokens and targets, whisper's stub
    frames at half the sequence, one microbatch a row by default."""
    for arch in ("llama3.2-3b", "whisper-base"):
        cfg = get_config(arch)
        step, (params, state, batch) = PS.build_cell(
            cfg, PS.SHAPES["train_4k"])
        assert {k: (tuple(v.shape), v.dtype) for k, v in batch.items()} \
            == {"tokens": ((256, 4096), torch.int32),
                "targets": ((256, 4096), torch.int32),
                **({"frames": ((256, 2048, 512), torch.float32)}
                   if cfg.family == "encdec" else {})}
        assert callable(step)


def test_meta_draw_is_the_cpu_draw_in_shape_and_card_draws_unchanged():
    """``device=`` only places the draws: the reduced tree drawn on meta
    has the CPU tree's shapes and dtypes, and a CPU draw with
    ``device="cpu"`` is bitwise the default one."""
    cfg = get_config("qwen3-moe-30b-a3b").reduced()
    a = PS.init_fn_for(cfg)(cfg, torch.Generator().manual_seed(0),
                            stacked=True)
    b = PS.init_fn_for(cfg)(cfg, torch.Generator().manual_seed(0),
                            stacked=True, device="cpu")
    m = PS.init_fn_for(cfg)(cfg, torch.Generator().manual_seed(0),
                            stacked=True, device="meta")
    same_tree(m, a)
    assert all(torch.equal(x, y) for x, y in zip(optim.tree_leaves(a),
                                                 optim.tree_leaves(b)))

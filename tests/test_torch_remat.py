"""Remat in the port (``cfg.remat``: none | full | dots; ``lm._remat``,
``whisper._remat``) on the reduced dense, moe, hybrid, ssm and encdec
configs in float32 on the CPU:

* the loss and every gradient are bitwise equal across the three modes
  (a unit recomputed runs the same ops on the same inputs);
* the loss matches the JAX package's under the same remat within 1e-5
  (relative: the train tests' tolerance), JAX's parameters carried
  across;
* the bytes saved for the backward (``launch/hlo_cost.py``'s
  ``saved_bytes``, counted on meta) fall from none to dots to full:
  "dots" keeps the 2-D products' outputs, so its policy must reach the
  ops the projections dispatch to (``aten.mm``), or it would quietly be
  "full";
* decode logits and the cache after 4 steps are bitwise equal across the
  modes with grad mode on, and no decode step checkpoints anything: remat
  never touches the cache path, whose recompute would write the slots a
  second time.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch.utils.checkpoint import CheckpointPolicy  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.distributed.sharding import unbox  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import whisper as jwh  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.data.synth import DataConfig, synth_batch  # noqa: E402
from repro_torch.launch.hlo_cost import count_train  # noqa: E402
from repro_torch.launch.shapes import ShapeCell, build_cell  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import whisper as wh  # noqa: E402
from repro_torch.train.optim import OptimConfig, tree_leaves  # noqa: E402
from repro_torch.train.step import compute_grads  # noqa: E402

FAMILIES = ("llama3.2-3b", "qwen3-moe-30b-a3b", "recurrentgemma-9b",
            "xlstm-1.3b", "whisper-base")
MODES = ("none", "full", "dots")
B, S = 2, 32                   # one whole mLSTM chunk of the reduced xlstm


@functools.lru_cache(maxsize=None)
def jax_side(arch):
    """The JAX config and parameters of ``arch``, drawn once (the
    parameters as numpy arrays too)."""
    jcfg = jax_get_config(arch).reduced().replace(dtype="float32",
                                                  attn_chunk=8)
    init = jwh.init_params if jcfg.family == "encdec" else jlm.init_params
    jparams = init(jax.random.PRNGKey(0), jcfg)
    return jcfg, jparams, jax.tree.map(np.asarray, unbox(jparams))


def sides(arch):
    """(JAX config, parameters), (the port's config, its own copy of
    those parameters, stacked) and a synthetic batch."""
    jcfg, jparams, arrays = jax_side(arch)
    cfg = get_config(arch).reduced().replace(dtype="float32")
    params = lm_params_from_numpy(arrays, device="cpu", stacked=True)
    nb = synth_batch(cfg, DataConfig(global_batch=B, seq_len=S, seed=1), 0)
    return (jcfg, jparams), (cfg, params), nb


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_grads_bitwise_across_modes_and_loss_matches_jax(arch):
    (jcfg, jparams), (cfg, params), nb = sides(arch)
    batch = {k: torch.from_numpy(v) for k, v in nb.items()}
    fam = jwh if jcfg.family == "encdec" else jlm
    out = {}
    for mode in MODES:
        loss, grads = compute_grads(params, cfg.replace(remat=mode), batch)
        out[mode] = (loss, tree_leaves(grads))
        jl = float(fam.lm_loss(jparams, jcfg.replace(remat=mode),
                               {k: jnp.asarray(v) for k, v in nb.items()}))
        assert abs(float(loss) - jl) <= 1e-5 * abs(jl), (mode, float(loss),
                                                         jl)
    loss0, grads0 = out["none"]
    for mode in ("full", "dots"):
        loss, grads = out[mode]
        assert torch.equal(loss, loss0), mode
        assert len(grads) == len(grads0)
        for g, g0 in zip(grads, grads0):
            assert torch.equal(g, g0), mode


@pytest.mark.parametrize("arch", FAMILIES)
def test_saved_bytes_fall_from_none_to_full(arch):
    """Counted on the meta device (the bytes depend on shapes alone)."""
    cfg = get_config(arch).reduced().replace(dtype="float32")
    ocfg = OptimConfig()
    saved = {}
    for mode in MODES:
        c = cfg.replace(remat=mode)
        _, (params, state, batch) = build_cell(c, ShapeCell("mini", "train",
                                                            S, B),
                                               grad_accum=1)
        saved[mode] = count_train(c, params, state, batch, ocfg,
                                  1).saved_bytes
    assert saved["none"] > saved["full"] > 0, saved
    if cfg.family == "encdec":
        assert saved["dots"] == saved["full"], saved      # plain checkpoint
    else:
        assert saved["none"] > saved["dots"] > saved["full"], saved


def test_dots_keeps_the_projections_outputs(monkeypatch):
    """Under "dots" the policy keeps exactly the 2-D products of a dense
    layer: q, k, v and o, and the MLP's three, B·S rows each."""
    _, (cfg, params), nb = sides("llama3.2-3b")
    cfg = cfg.replace(remat="dots", n_layers=1)
    params = dict(params, blocks={k: {n: t[:1] for n, t in v.items()}
                                  for k, v in params["blocks"].items()})
    batch = {k: torch.from_numpy(v) for k, v in nb.items()}
    kept, keep_dots = [], lm._keep_dots

    def keep(ctx, op, *args, **kwargs):
        policy = keep_dots(ctx, op, *args, **kwargs)
        if policy == CheckpointPolicy.MUST_SAVE and not ctx.is_recompute:
            kept.append(args[-2].shape[0] * args[-1].shape[1] * 4)
        return policy

    monkeypatch.setattr(lm, "_keep_dots", keep)
    compute_grads(params, cfg, batch)
    d, hd = cfg.d_model, cfg.head_dim
    widths = [cfg.n_heads * hd, cfg.n_kv_heads * hd, cfg.n_kv_heads * hd, d,
              cfg.d_ff, cfg.d_ff, d]
    assert sorted(kept) == sorted(B * S * w * 4 for w in widths)


def test_remat_mode_is_checked():
    _, (cfg, params), nb = sides("llama3.2-3b")
    batch = {k: torch.from_numpy(v) for k, v in nb.items()}
    with pytest.raises(ValueError, match="remat"):
        compute_grads(params, cfg.replace(remat="some"), batch)


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_untouched_by_remat(arch, monkeypatch):
    """4 decode steps with grad mode on and parameters that require grad:
    the same logits and cache bits under every mode, and no checkpoint."""
    _, (cfg, params), nb = sides(arch)
    calls = []

    def spy(*a, **k):
        calls.append(1)
        raise AssertionError("a decode step checkpointed a unit")
    monkeypatch.setattr(lm, "checkpoint", spy)      # whisper's too
    for p in tree_leaves(params):
        p.requires_grad_(True)
    toks = torch.from_numpy(nb["tokens"][:, :4].astype(np.int32))
    runs = {}
    for mode in MODES:
        c = cfg.replace(remat=mode)
        if c.family == "encdec":
            frames = torch.from_numpy(nb["frames"])
            with torch.no_grad():
                enc = wh.encode(params, c, frames)
            cache = wh.init_cache(params, c, enc, B, 8, device="cpu")
            step = wh.decode_step
        else:
            cache = lm.init_cache(c, B, 8, device="cpu")
            step = lm.decode_step
        logits = []
        for i in range(4):
            lg, cache = step(params, c, toks[:, i:i + 1], cache, i)
            logits.append(lg.detach())
        runs[mode] = (logits, [t.detach().clone() for t in
                               tree_leaves(cache)])
    assert not calls
    for mode in ("full", "dots"):
        for a, b in zip(runs[mode][0] + runs[mode][1],
                        runs["none"][0] + runs["none"][1]):
            assert torch.equal(a, b), mode

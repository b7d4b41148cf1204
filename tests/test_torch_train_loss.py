"""Parity of the port's training loss with the JAX package's, per family:
``lm.cross_entropy``/``lm.lm_loss`` (dense llama3.2-3b, moe qwen3-moe-30b-a3b,
vlm chameleon-34b with stub embeddings, hybrid recurrentgemma-9b, ssm
xlstm-1.3b) and ``whisper.lm_loss`` (encdec whisper-base), on the reduced
configs in float32: JAX's parameters carried across stacked
(``convert.lm_params_from_numpy(stacked=True)``, the tree training holds),
the same batch (``data/synth.py``, numpy) on both sides.

* the loss within 1e-5 (relative) of JAX's;
* every leaf's gradient (autograd through K6/K7's plain versions on the
  CPU) within 1e-4 of JAX's ``jax.grad``, relative to the leaf's largest
  entry (a gradient entry sums many terms, in another order);
* ``cross_entropy``'s gather equals the one-hot sum exactly, and the
  per-layer views of stacked parameters give the same loss as the
  per-layer form.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.distributed.sharding import unbox  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import whisper as jwh  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.data.synth import DataConfig, synth_batch  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import whisper as wh  # noqa: E402
from repro_torch.models.lm import per_layer  # noqa: E402
from repro_torch.train.optim import tree_leaves  # noqa: E402

FAMILIES = ("llama3.2-3b", "qwen3-moe-30b-a3b", "chameleon-34b",
            "recurrentgemma-9b", "xlstm-1.3b", "whisper-base")
B, S = 2, 32                   # one whole mLSTM chunk of the reduced xlstm


def sides(arch, seed=0):
    jcfg = jax_get_config(arch).reduced().replace(dtype="float32",
                                                  attn_chunk=8)
    init = jwh.init_params if jcfg.family == "encdec" else jlm.init_params
    jparams = init(jax.random.PRNGKey(seed), jcfg)
    cfg = get_config(arch).reduced().replace(dtype="float32")
    params = lm_params_from_numpy(jax.tree.map(np.asarray, unbox(jparams)),
                                  device="cpu", stacked=True)
    nb = synth_batch(cfg, DataConfig(global_batch=B, seq_len=S, seed=1), 0)
    if cfg.family == "vlm":
        nb["embeddings"] = (np.random.default_rng(2).standard_normal(
            (B, S, cfg.d_model)) * 0.02).astype(np.float32)
    return (jcfg, jparams), (cfg, params), nb


def jax_loss_fn(jcfg):
    fam = jwh if jcfg.family == "encdec" else jlm
    return lambda p, b: fam.lm_loss(p, jcfg, b)


def port_loss(cfg, params, batch):
    fam = wh if cfg.family == "encdec" else lm
    return fam.lm_loss(params, cfg, batch)


def assert_tree_close(got, want, tol, path=""):
    """Per leaf: max|got − want| ≤ tol · max|want|."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            assert_tree_close(got[k], want[k], tol, f"{path}/{k}")
        return
    g = got.detach().double().numpy()
    w = np.asarray(want, np.float64)
    assert g.shape == w.shape, path
    scale = max(np.abs(w).max(), 1e-30)
    assert np.abs(g - w).max() <= tol * scale, (path, np.abs(g - w).max(),
                                                scale)


@pytest.mark.parametrize("arch", FAMILIES)
def test_lm_loss_and_grads_match_jax(arch):
    (jcfg, jparams), (cfg, params), nb = sides(arch)
    jbatch = {k: jnp.asarray(v) for k, v in nb.items()}
    jl, jg = jax.value_and_grad(jax_loss_fn(jcfg))(jparams, jbatch)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = port_loss(cfg, params, {k: torch.from_numpy(v)
                                   for k, v in nb.items()})
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    assert abs(float(loss.detach()) - float(jl)) <= 1e-5 * abs(float(jl))
    by_id = {id(p): torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)}

    def tree(node):
        if isinstance(node, dict):
            return {k: tree(v) for k, v in node.items()}
        return by_id[id(node)]
    assert_tree_close(tree(params), jax.tree.map(np.asarray, unbox(jg)),
                      1e-4)


@pytest.mark.parametrize("arch", ("llama3.2-3b", "recurrentgemma-9b"))
def test_stacked_and_per_layer_forms_give_one_loss(arch):
    """``per_layer`` is what every entry point applies to stacked
    parameters: the two forms compute the same loss, bitwise."""
    _, (cfg, params), nb = sides(arch)
    batch = {k: torch.from_numpy(v) for k, v in nb.items()}
    with torch.no_grad():
        a = port_loss(cfg, params, batch)
        b = port_loss(cfg, per_layer(params), batch)
    assert torch.equal(a, b)


def test_cross_entropy_gather_equals_one_hot_sum():
    (jcfg, jparams), (cfg, params), nb = sides("llama3.2-3b")
    rng = np.random.default_rng(5)
    hidden = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    got = lm.cross_entropy(params, cfg, torch.from_numpy(hidden),
                           torch.from_numpy(nb["targets"]))
    want = jlm.cross_entropy(jparams, jcfg, jnp.asarray(hidden),
                             jnp.asarray(nb["targets"]))
    assert abs(float(got) - float(want)) <= 1e-6 * abs(float(want))
    logits = (torch.from_numpy(hidden) @ params["embed"]["head"]).float()
    t = torch.from_numpy(nb["targets"]).long()
    onehot = torch.nn.functional.one_hot(t, cfg.vocab_size).float()
    assert torch.equal(logits.gather(-1, t[..., None])[..., 0],
                       (logits * onehot).sum(-1))

"""Parity of the port's whisper encoder-decoder (``repro_torch.models.
whisper``) with the JAX package's (``repro/models/whisper.py``) on the
reduced whisper-base (2 + 2 layers, d_model 128): JAX's parameters carried
across by ``convert.lm_params_from_numpy``, the same stub frame embeddings
(drawn with numpy from a seed) and tokens on both sides.

* float32, within 1e-5 of max|out|: ``encode``, ``decode_train``'s logits
  and 16 ``decode_step`` logits over a cache preloaded with the encoder's
  K/V; greedy decoding from a prompt gives the same tokens;
* the port's step-by-step decode equals its ``decode_train`` (1e-5);
* bfloat16, within 5e-2 of max|logit|: the packages round at other
  places (JAX casts the softmax weights to bf16 before P·V, the port's K6
  keeps P·V in float32, as the Pallas kernel);
* the init draws the reference's distributions and dtypes, and K6 runs
  each attention (plain version on the CPU: no launch).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.distributed.sharding import unbox  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import whisper as JWH  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.kernels.flash import kernel as FK  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import whisper as WH  # noqa: E402
from repro_torch.models.config import param_counts  # noqa: E402

B, S_ENC, S = 2, 24, 16


def sides(dtype, seed=0):
    jcfg = jax_get_config("whisper_base").reduced().replace(dtype=dtype,
                                                           attn_chunk=8)
    jparams = JWH.init_params(jax.random.PRNGKey(seed), jcfg)
    cfg = get_config("whisper_base").reduced().replace(dtype=dtype)
    params = lm_params_from_numpy(jax.tree.map(np.asarray, unbox(jparams)),
                                  device="cpu")
    return (jcfg, jparams), (cfg, params)


def frames(d, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (B, S_ENC, d)).astype(np.float32)


def tokens(vocab, seed=3):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


def shapes(tree):
    """Leaf shapes in JAX's order (dictionary keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in shapes(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in shapes(v)]
    return [tuple(tree.shape)]


def rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / np.abs(b).max())


def jax_run(jcfg, jparams, fr, toks):
    """JAX's encoder output, decode_train logits and step logits."""
    enc = jax.jit(lambda f: JWH.encode(jparams, jcfg, f))(jnp.asarray(fr))
    train = np.asarray(jax.jit(lambda e, t: JL.lm_logits(
        jparams["embed"], jcfg, JWH.decode_train(jparams, jcfg, e, t)))(
            enc, jnp.asarray(toks)), np.float32)
    step = jax.jit(lambda t, c, i: JWH.decode_step(jparams, jcfg, t, c, i))
    cache = JWH.init_cache(jparams, jcfg, enc, B, S)
    outs = []
    for i in range(S):
        lg, cache = step(jnp.asarray(toks[:, i:i + 1]), cache,
                         jnp.asarray(i, jnp.int32))
        outs.append(np.asarray(lg, np.float32))
    return np.asarray(enc, np.float32), train, np.stack(outs, 1)


def port_run(cfg, params, fr, toks):
    enc = WH.encode(params, cfg, torch.from_numpy(fr))
    hid = WH.decode_train(params, cfg, enc, torch.from_numpy(toks))
    train = L.lm_logits(params["embed"], cfg, hid).float().numpy()
    cache = WH.init_cache(params, cfg, enc, B, S, device="cpu")
    outs = []
    for i in range(S):
        lg, cache = WH.decode_step(params, cfg, torch.from_numpy(
            toks[:, i:i + 1]), cache, i)
        outs.append(lg.float().numpy())
    return enc.float().numpy(), train, np.stack(outs, 1)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 5e-2)])
def test_encode_decode_train_and_decode_step_match_jax(dtype, tol):
    (jcfg, jparams), (cfg, params) = sides(dtype)
    fr, toks = frames(cfg.d_model), tokens(cfg.vocab_size)
    for port, ref in zip(port_run(cfg, params, fr, toks),
                         jax_run(jcfg, jparams, fr, toks)):
        assert rel(port, ref) < tol


def greedy(step, cache, first, n):
    """n greedy tokens from a (B, 1) first token: step(tok, cache, i) →
    (logits as numpy, cache)."""
    tok, out = first, []
    for i in range(n):
        lg, cache = step(tok, cache, i)
        nxt = lg.argmax(-1).astype(np.int32)
        out.append(nxt)
        tok = nxt[:, None]
    return np.stack(out, 1)


def test_greedy_tokens_equal_jax_and_decode_equals_decode_train():
    (jcfg, jparams), (cfg, params) = sides("float32")
    fr = frames(cfg.d_model, seed=2)
    first = np.zeros((B, 1), np.int32)
    jenc = JWH.encode(jparams, jcfg, jnp.asarray(fr))
    jstep = jax.jit(lambda t, c, i: JWH.decode_step(jparams, jcfg, t, c, i))
    jtoks = greedy(lambda t, c, i: (lambda lg, c: (np.asarray(lg), c))(
        *jstep(jnp.asarray(t), c, jnp.asarray(i, jnp.int32))),
        JWH.init_cache(jparams, jcfg, jenc, B, S), first, S)
    enc = WH.encode(params, cfg, torch.from_numpy(fr))
    cache = WH.init_cache(params, cfg, enc, B, S, device="cpu")
    toks = greedy(lambda t, c, i: (lambda lg, c: (lg.numpy(), c))(
        *WH.decode_step(params, cfg, torch.from_numpy(t), c, i)),
        cache, first, S)
    assert np.array_equal(toks, jtoks)
    # the port's steps (already run into `cache`) against decode_train
    fed = np.concatenate([first, toks[:, :-1]], 1)
    hid = WH.decode_train(params, cfg, enc, torch.from_numpy(fed))
    train = L.lm_logits(params["embed"], cfg, hid).numpy()
    cache = WH.init_cache(params, cfg, enc, B, S, device="cpu")
    steps = np.stack([WH.decode_step(params, cfg, torch.from_numpy(
        fed[:, i:i + 1]), cache, i)[0].numpy() for i in range(S)], 1)
    assert rel(steps, train) < 1e-5
    assert np.array_equal(train.argmax(-1), toks)


def test_init_draws_jax_distributions_and_dtypes():
    cfg = get_config("whisper_base").reduced().replace(dtype="float32")
    p = WH.init_params(cfg, torch.Generator().manual_seed(1))
    d, ne, nd = cfg.d_model, cfg.n_enc_layers, cfg.n_dec_layers
    norms = (2 * ne + 3 * nd + 2) * 2 * d          # layernorm scale + bias
    from repro_torch.models import lm
    assert lm.param_numel(p) == param_counts(cfg)["total"] + norms
    wq = torch.stack([layer["self_attn"]["wq"] for layer in p["dec"]])
    assert abs(float(wq.std()) * math.sqrt(d) - 1) < 0.05
    w_down = torch.stack([layer["mlp"]["w_down"] for layer in p["enc"]])
    assert abs(float(w_down.std()) * math.sqrt(cfg.d_ff) - 1) < 0.05
    assert abs(float(p["embed"]["tok"].std()) / 0.02 - 1) < 0.05
    assert torch.equal(p["enc_norm"]["scale"], torch.ones(d))
    assert not p["dec"][0]["cross_norm"]["bias"].any()
    _, (_, carried) = sides("bfloat16")
    drawn = WH.init_params(get_config("whisper_base").reduced(),
                           torch.Generator().manual_seed(0))
    assert {t.dtype for t in lm.tensors(drawn)} == \
        {t.dtype for t in lm.tensors(carried)} == {torch.bfloat16}
    assert shapes(drawn) == shapes(carried)


def test_cache_layout_and_k6_calls(monkeypatch):
    """The cache holds the reference's leaves; every attention goes
    through K6's wrapper (non-causal for the encoder and the
    cross-attention), which on CPU tensors runs the plain version and
    launches nothing."""
    (jcfg, jparams), (cfg, params) = sides("float32")
    fr = frames(cfg.d_model)
    jcache = JWH.init_cache(jparams, jcfg, JWH.encode(
        jparams, jcfg, jnp.asarray(fr)), B, S)
    enc = WH.encode(params, cfg, torch.from_numpy(fr))
    cache = WH.init_cache(params, cfg, enc, B, S, device="cpu")
    assert shapes(cache) == [a.shape for a in jax.tree.leaves(jcache)]
    assert bool((cache["self"]["pos"] == -1).all())
    calls, inner = [], WH.attention

    def spy(*a, causal=True, **kw):
        calls.append(causal)
        return inner(*a, causal=causal, **kw)
    monkeypatch.setattr(L, "attention", spy)
    monkeypatch.setattr(WH, "attention", spy)
    FK.reset_launch_counts()
    WH.encode(params, cfg, torch.from_numpy(fr))
    WH.decode_step(params, cfg, torch.zeros((B, 1), dtype=torch.long),
                   cache, 0)
    assert calls == [False] * cfg.n_enc_layers + [True, False] \
        * cfg.n_dec_layers
    assert FK.launch_counts()["flash_attention_fwd"] == 0

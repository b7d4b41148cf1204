"""Parity of the port's LM with the JAX package on the reduced
llama3.2-3b (dense), qwen3-moe-30b-a3b and dbrx-132b (moe, at the
published capacity factor, so decode drops pairs), chameleon-34b (vlm,
qk-norm), recurrentgemma-9b (hybrid, with a recurrent tail and a ring
that wraps) and xlstm-1.3b (ssm: mLSTM and sLSTM groups; a reset slot
is zeroed as in the reference, C18): JAX's own parameters carried across by
``convert.lm_params_from_numpy``, the same tokens on both sides.

* float32: ``forward`` and ``decode_step`` logits within 1e-5 of
  max|logit| (the two differ only in summation order);
* the port's step-by-step decode equals its teacher-forced forward (as
  ``tests/test_models_smoke.py::test_decode_matches_forward``);
* bfloat16: logits within 5e-2 of max|logit|.  The packages round at
  other places: JAX casts the softmax weights to bf16 before P·V and
  computes SiLU in bf16, the port keeps P·V in float32 (as the Pallas
  kernel) and PyTorch evaluates SiLU in float32 before rounding.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.distributed.sharding import unbox  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models.config import param_counts as jax_param_counts  # noqa: E402,E501
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.config import param_counts  # noqa: E402

B, S = 2, 16


def reduced(dtype):
    return get_config("llama3.2-3b").reduced().replace(dtype=dtype)


def jax_side(dtype, seed=0):
    cfg = jax_get_config("llama3.2-3b").reduced().replace(dtype=dtype,
                                                          attn_chunk=8)
    params = jlm.init_params(jax.random.PRNGKey(seed), cfg)
    return cfg, params


def carried(params):
    return lm_params_from_numpy(jax.tree.map(np.asarray, unbox(params)),
                                device="cpu")


def tokens(vocab, seed=3):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


def jax_forward_logits(cfg, params, toks):
    hid, _ = jlm.forward(params, cfg, jnp.asarray(toks))
    return np.asarray(JL.lm_logits(params["embed"], cfg, hid), np.float32)


def port_forward_logits(cfg, params, toks):
    hid, _ = lm.forward(params, cfg, torch.from_numpy(toks))
    return L.lm_logits(params["embed"], cfg, hid).float().numpy()


def port_decode_logits(cfg, params, toks, vector=False):
    cache = lm.init_cache(cfg, B, S, device="cpu")
    outs = []
    for i in range(S):
        pos = torch.full((B,), i, dtype=torch.int32) if vector else i
        lg, cache = lm.decode_step(params, cfg, torch.from_numpy(
            toks[:, i:i + 1]), cache, pos)
        outs.append(lg.float().numpy())
    return np.stack(outs, 1)


def rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


def test_forward_and_decode_match_jax_in_float32():
    jcfg, jparams = jax_side("float32")
    cfg, params = reduced("float32"), carried(jparams)
    toks = tokens(cfg.vocab_size)
    ref = jax_forward_logits(jcfg, jparams, toks)
    assert rel(port_forward_logits(cfg, params, toks), ref) < 1e-5
    cache = jlm.init_cache(jcfg, B, S)
    jdec = []
    for i in range(S):
        lg, cache = jlm.decode_step(jparams, jcfg, jnp.asarray(toks[:, i:i + 1]),
                                    cache, jnp.asarray(i, jnp.int32))
        jdec.append(np.asarray(lg))
    jdec = np.stack(jdec, 1)
    for vector in (False, True):
        assert rel(port_decode_logits(cfg, params, toks, vector), jdec) < 1e-5


def test_port_decode_matches_its_forward():
    cfg = reduced("float32")
    params = lm.init_params(cfg, torch.Generator().manual_seed(0))
    toks = tokens(cfg.vocab_size, seed=4)
    ref = port_forward_logits(cfg, params, toks)
    assert rel(port_decode_logits(cfg, params, toks, vector=True), ref) < 1e-5


def test_forward_matches_jax_in_bfloat16():
    jcfg, jparams = jax_side("bfloat16")
    cfg, params = reduced("bfloat16"), carried(jparams)
    assert params["embed"]["tok"].dtype == torch.bfloat16
    assert np.array_equal(
        params["blocks"][1]["attn"]["wq"].float().numpy(),
        np.asarray(unbox(jparams)["blocks"]["attn"]["wq"][1], np.float32))
    toks = tokens(cfg.vocab_size)
    assert rel(port_forward_logits(cfg, params, toks),
               jax_forward_logits(jcfg, jparams, toks)) < 5e-2


def test_configs_and_param_counts():
    cfg = get_config("llama3.2-3b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab_size, cfg.rope_theta,
            cfg.dtype) == (28, 3072, 24, 8, 128, 8192, 128256, 5e5,
                           "bfloat16")
    assert param_counts(cfg)["total"] == 3_606_577_152
    for arch in ARCH_IDS:                  # the nine others are data
        port = dataclasses.asdict(get_config(arch))
        ref = dataclasses.asdict(jax_get_config(arch))
        assert port == {f: ref[f] for f in port}  # less JAX's XLA options
        assert param_counts(get_config(arch)) == \
            jax_param_counts(jax_get_config(arch))


def test_other_families_raise_naming_the_roadmap():
    """Only the encoder-decoder is refused, with the reference's wording:
    ``lm`` does not handle the family (it lives in ``models/whisper.py``)
    and ``ServeEngine`` serves decoder-only archs."""
    from repro_torch.serve.engine import ServeEngine
    cfg = get_config("whisper_base").reduced()
    with pytest.raises(ValueError, match="not handled here.*whisper.py"):
        lm.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="not handled here.*whisper.py"):
        lm.init_cache(cfg, 2, 8, device="cpu")
    with pytest.raises(NotImplementedError, match="decoder-only archs; "
                       "whisper uses whisper.decode_step directly"):
        ServeEngine(None, cfg)
    ssm = get_config("xlstm_1_3b").reduced()
    assert lm.attention_layers(ssm) == 0
    lm.init_cache(ssm, 2, 8, device="cpu")


def test_init_draws_jax_distributions():
    cfg = get_config("llama3.2-3b").reduced().replace(dtype="float32")
    p = lm.init_params(cfg, torch.Generator().manual_seed(1))
    n = lm.param_bytes(p) // 4
    assert n == param_counts(cfg)["total"] + (2 * cfg.n_layers + 1) \
        * cfg.d_model                              # plus the norm scales
    wq = torch.stack([b["attn"]["wq"] for b in p["blocks"]])
    assert abs(float(wq.std()) * math.sqrt(cfg.d_model) - 1) < 0.02
    w_down = torch.stack([b["mlp"]["w_down"] for b in p["blocks"]])
    assert abs(float(w_down.std()) * math.sqrt(cfg.d_ff) - 1) < 0.02
    assert abs(float(p["embed"]["tok"].std()) / 0.02 - 1) < 0.02
    assert torch.equal(p["blocks"][0]["attn_norm"]["scale"],
                       torch.ones(cfg.d_model))


def test_reset_slot_empties_one_slot_in_place():
    cfg = reduced("float32")
    params = lm.init_params(cfg, torch.Generator().manual_seed(0))
    cache = lm.init_cache(cfg, 2, 8, device="cpu")
    for i in range(3):
        _, cache = lm.decode_step(params, cfg, torch.ones((2, 1), dtype=torch.long),
                                  cache, i)
    k_ptr = cache["k"].data_ptr()
    out = lm.reset_slot(cfg, cache, 1)
    assert out["k"].data_ptr() == k_ptr
    assert torch.all(cache["pos"][:, 1] == -1)
    assert not torch.any(cache["k"][:, 1]) and not torch.any(cache["v"][:, 1])
    assert torch.equal(cache["pos"][:, 0, :4],
                       torch.tensor([0, 1, 2, -1], dtype=torch.int32).expand(
                           cfg.n_layers, 4))


# ---------------------------------------------------------------------------
# moe, vlm, hybrid and ssm families
# ---------------------------------------------------------------------------

FAMILIES = ("qwen3_moe_30b_a3b", "dbrx_132b", "chameleon_34b",
            "recurrentgemma_9b", "xlstm_1_3b")
S_FAM = 20          # > the hybrid test window: the ring wraps twice


def family_kw(arch):
    """Hybrid: a recurrent tail (5 layers = one triple + 2) and a window
    of 8, so S_FAM decode steps wrap its ring."""
    return dict(n_layers=5, window=8) if arch == "recurrentgemma_9b" else {}


def family_sides(arch, dtype, seed=0, **kw):
    jcfg = jax_get_config(arch).reduced().replace(
        dtype=dtype, attn_chunk=8, **family_kw(arch), **kw)
    jparams = jlm.init_params(jax.random.PRNGKey(seed), jcfg)
    cfg = get_config(arch).reduced().replace(dtype=dtype, **family_kw(arch),
                                             **kw)
    return (jcfg, jparams), (cfg, carried(jparams))


def family_tokens(vocab, seed=3):
    return np.random.default_rng(seed).integers(0, vocab, (B, S_FAM)).astype(
        np.int32)


def jax_decode_logits(jcfg, jparams, toks, vector):
    step = jax.jit(lambda t, c, i: jlm.decode_step(jparams, jcfg, t, c, i))
    cache = jlm.init_cache(jcfg, B, toks.shape[1])
    outs = []
    for i in range(toks.shape[1]):
        pos = jnp.full((B,), i, jnp.int32) if vector else \
            jnp.asarray(i, jnp.int32)
        lg, cache = step(jnp.asarray(toks[:, i:i + 1]), cache, pos)
        outs.append(np.asarray(lg))
    return np.stack(outs, 1)


def port_family_decode(cfg, params, toks, vector):
    cache = lm.init_cache(cfg, B, toks.shape[1], device="cpu")
    outs = []
    for i in range(toks.shape[1]):
        pos = torch.full((B,), i, dtype=torch.int32) if vector else i
        lg, cache = lm.decode_step(params, cfg, torch.from_numpy(
            toks[:, i:i + 1]), cache, pos)
        outs.append(lg.float().numpy())
    return np.stack(outs, 1)


@pytest.mark.parametrize("arch", FAMILIES)
def test_families_match_jax_in_float32(arch):
    (jcfg, jparams), (cfg, params) = family_sides(arch, "float32")
    toks = family_tokens(cfg.vocab_size)
    hid, jaux = jlm.forward(jparams, jcfg, jnp.asarray(toks))
    ref = np.asarray(JL.lm_logits(jparams["embed"], jcfg, hid), np.float32)
    phid, aux = lm.forward(params, cfg, torch.from_numpy(toks))
    assert rel(L.lm_logits(params["embed"], cfg, phid).numpy(), ref) < 1e-5
    assert abs(float(aux) - float(jaux)) <= 1e-5 * max(abs(float(jaux)), 1)
    assert (float(aux) > 0) == cfg.is_moe
    for vector in (False, True):
        jdec = jax_decode_logits(jcfg, jparams, toks, vector)
        assert rel(port_family_decode(cfg, params, toks, vector), jdec) < 1e-5


def jax_router_probs(jcfg, jparams, toks):
    """JAX's router probabilities (B·S, E) at every layer of a forward,
    layer by layer through the package's own block, and that forward's
    logits."""
    x = JL.embed_tokens(jparams["embed"], jnp.asarray(toks))
    b, s = toks.shape
    pos = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32)[None], (b, s))
    out = []
    for i in range(jcfg.n_layers):
        p = jax.tree.map(lambda a: a[i], jparams["blocks"])
        h = JL.apply_norm(p["attn_norm"], x, jcfg.norm)
        a, _ = JL.apply_attention(p["attn"], jcfg, h, pos, window=0)
        h = JL.apply_norm(p["mlp_norm"], x + a, jcfg.norm)
        logits = h.reshape(b * s, -1).astype(jnp.float32) \
            @ p["moe"]["router"].value
        out.append(np.asarray(jax.nn.softmax(logits, -1)))
        x, _, _ = jlm._apply_dense_block(p, jcfg, x, pos)
    x = JL.apply_norm(jparams["final_norm"], x, jcfg.norm)
    return out, np.asarray(JL.lm_logits(jparams["embed"], jcfg, x),
                           np.float32)


def port_router_probs(monkeypatch, cfg, params, toks):
    """The port's router probabilities at every layer of ``lm.forward``
    (and its logits)."""
    from repro_torch.models import moe as MOE
    seen, inner = [], MOE._route

    def spy(x_flat, router_w, k):
        out = inner(x_flat, router_w, k)
        seen.append(out[0].numpy())
        return out
    monkeypatch.setattr(MOE, "_route", spy)
    hid, _ = lm.forward(params, cfg, torch.from_numpy(toks))
    monkeypatch.setattr(MOE, "_route", inner)
    return seen, L.lm_logits(params["embed"], cfg, hid).float().numpy()


def routing_flips(jprobs, probs, k):
    """Tokens whose top-k set differs between the packages, each at its
    first such layer, with JAX's gap p_k − p_(k+1) there and the largest
    |Δp| of that token between the packages."""
    flips = {}
    for a, b in zip(jprobs, probs):
        top_a = np.sort(np.argsort(-a, 1, kind="stable")[:, :k], 1)
        top_b = np.sort(np.argsort(-b, 1, kind="stable")[:, :k], 1)
        for t in np.nonzero((top_a != top_b).any(1))[0]:
            if t not in flips:
                srt = np.sort(a[t])[::-1]
                flips[t] = (srt[k - 1] - srt[k], np.abs(a[t] - b[t]).max())
    return flips


@pytest.mark.parametrize("arch", FAMILIES)
def test_families_match_jax_in_bfloat16(arch, monkeypatch):
    """Logits within 5e-2 of max|logit|.  The packages round bfloat16
    activations at other places (see the module docstring), and a router
    turns that drift into a discrete choice: where two experts' JAX
    probabilities lie closer than the drift, the packages may pick
    different ones.  So for moe (at capacity factor 100, no drops; the
    float32 tests hold the drops exactly): every token whose top-k differs
    is such a near tie at the first layer where it differs, at most a few
    tokens do, and the logits of every token that attends to none of them
    (the tokens before a row's first such tie) are within 5e-2."""
    kw = dict(moe_capacity_factor=100.0) if "moe" in arch or "dbrx" in arch \
        else {}
    (jcfg, jparams), (cfg, params) = family_sides(arch, "bfloat16", **kw)
    toks = family_tokens(cfg.vocab_size, seed=4)
    if cfg.is_moe:
        probs, out = port_router_probs(monkeypatch, cfg, params, toks)
        jprobs, ref = jax_router_probs(jcfg, jparams, toks)
        flips = routing_flips(jprobs, probs, cfg.experts_per_token)
        assert len(flips) <= B * S_FAM // 8, flips
        for t, (gap, drift) in flips.items():
            assert gap <= 2 * drift and drift <= 5e-2, (t, gap, drift)
        # causal attention carries a flip to the later tokens of its row
        keep = np.ones((B, S_FAM), bool)
        for t in flips:
            keep[t // S_FAM, t % S_FAM:] = False
        assert np.abs(out - ref)[keep].max() / np.abs(ref).max() < 5e-2
        return
    hid, _ = jlm.forward(jparams, jcfg, jnp.asarray(toks))
    ref = np.asarray(JL.lm_logits(jparams["embed"], jcfg, hid), np.float32)
    phid, _ = lm.forward(params, cfg, torch.from_numpy(toks))
    assert rel(L.lm_logits(params["embed"], cfg, phid).float().numpy(),
               ref) < 5e-2
    dec = port_family_decode(cfg, params, toks[:, :6], vector=True)
    jdec = jax_decode_logits(jcfg, jparams, toks[:, :6], vector=True)
    assert rel(dec, jdec) < 5e-2


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_decode_matches_its_forward(arch):
    """Without drops (capacity factor 100, as
    tests/test_models_smoke.py::test_moe_decode_matches_forward_nodrop),
    step-by-step decode equals the teacher-forced forward; hybrid through
    its wrapped ring and recurrent tail."""
    cfg = get_config(arch).reduced().replace(
        dtype="float32", moe_capacity_factor=100.0, **family_kw(arch))
    params = lm.init_params(cfg, torch.Generator().manual_seed(0))
    toks = family_tokens(cfg.vocab_size, seed=5)
    hid, _ = lm.forward(params, cfg, torch.from_numpy(toks))
    ref = L.lm_logits(params["embed"], cfg, hid).numpy()
    assert rel(port_family_decode(cfg, params, toks, vector=True), ref) < 1e-5


def test_forward_takes_embeddings():
    cfg = get_config("chameleon_34b").reduced().replace(dtype="float32")
    params = lm.init_params(cfg, torch.Generator().manual_seed(0))
    toks = torch.from_numpy(family_tokens(cfg.vocab_size))
    emb = L.embed_tokens(params["embed"], toks)
    a, _ = lm.forward(params, cfg, toks)
    b, _ = lm.forward(params, cfg, None, embeddings=emb)
    assert torch.equal(a, b)


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_init_counts_and_dtypes(arch):
    """Parameters by element (the router, lambda_param, w_if and r_* are
    float32 in a bfloat16 model): param_counts plus what it leaves out,
    the norm scales (and layernorm biases), qk-norm scales, and for hybrid
    the RG-LRU gate matrices and GeGLU's gate projection; for ssm the
    blocks as drawn (param_counts counts every layer an mLSTM block with
    q/k/v of 3·up/2 columns)."""
    cfg = get_config(arch).reduced().replace(**family_kw(arch))
    params = lm.init_params(cfg, torch.Generator().manual_seed(1))
    d, n = cfg.d_model, cfg.n_layers
    norms = 2 if cfg.norm == "layernorm" else 1       # scale (and bias)
    want = param_counts(cfg)["total"] + (2 * n + 1) * d * norms
    if cfg.family == "ssm":
        n_groups, n_m = lm.ssm_layout(cfg)
        up, heads, wh = 2 * d, cfg.n_heads, d // cfg.n_heads
        mlstm = (3 * d * up + 2 * up * up // 2 + cfg.conv_width * up
                 + 2 * heads * up + 2 * up)
        slstm = 5 * d * d + 4 * heads * wh * wh
        want = (cfg.vocab_size * d * 2 + d * norms
                + n_groups * (n_m * mlstm + slstm))
        assert len(params["groups"]) == n_groups == 2
        assert len(params["groups"][0]["mlstm"]) == n_m == 1
        assert params["groups"][0]["mlstm"][0]["w_if"].dtype == \
            params["groups"][1]["slstm"]["r_o"].dtype == torch.float32
        assert params["groups"][0]["slstm"]["w_in"].dtype == torch.bfloat16
        assert lm.attention_layers(cfg) == 0
        assert lm.param_numel(params) == want
        return
    if cfg.qk_norm:
        want += 2 * cfg.head_dim * n
    if cfg.family == "hybrid":
        n_tri, n_tail = lm.hybrid_layout(cfg)
        n_rec, w = n - n_tri, cfg.lru_width
        want += n_rec * (2 * w * w - w) + n * d * cfg.d_ff
        assert len(params["triples"]) == 1 and len(params["tail"]) == 2
        assert params["tail"][0]["rec"]["lambda_param"].dtype == \
            torch.float32
        assert lm.attention_layers(cfg) == 1
    else:
        assert lm.attention_layers(cfg) == n
    if cfg.is_moe:
        assert params["blocks"][0]["moe"]["router"].dtype == torch.float32
        assert params["blocks"][0]["moe"]["w_up"].dtype == torch.bfloat16
    assert lm.param_numel(params) == want


def test_hybrid_cache_is_a_ring_and_reset_slot_walks_it():
    cfg = get_config("recurrentgemma_9b").reduced().replace(
        dtype="float32", **family_kw("recurrentgemma_9b"))
    params = lm.init_params(cfg, torch.Generator().manual_seed(0))
    cache = lm.init_cache(cfg, 2, 32, device="cpu")
    assert cache["triples"]["attn"]["k"].shape == (1, 2, 8, cfg.n_kv_heads,
                                                   cfg.head_dim)
    assert cache["tail"]["h"].shape == (2, 2, cfg.lru_width)
    for i in range(11):
        pos = torch.tensor([i, -1 if i < 3 else i - 3], dtype=torch.int32)
        _, cache = lm.decode_step(params, cfg, torch.ones((2, 1),
                                  dtype=torch.long), cache, pos)
    ring = cache["triples"]["attn"]["pos"][0]
    assert ring[0].tolist() == [8, 9, 10, 3, 4, 5, 6, 7]
    assert ring[1].tolist() == [0, 1, 2, 3, 4, 5, 6, 7]
    ptr = cache["tail"]["h"].data_ptr()
    out = lm.reset_slot(cfg, cache, 1)
    assert out["tail"]["h"].data_ptr() == ptr
    for leaf in lm.tensors(cache):
        assert leaf[:, 0].abs().sum() > 0
    assert torch.all(cache["triples"]["attn"]["pos"][:, 1] == -1)
    for leaf in (cache["triples"]["rec1"]["h"], cache["tail"]["conv"],
                 cache["triples"]["attn"]["k"]):
        assert not torch.any(leaf[:, 1])


def test_ssm_reset_slot_equals_jax_leaf_for_leaf():
    """After a few steps, resetting slot 1 of an ssm cache zeroes every
    leaf of that slot along the reference's batch axis (2 for the doubly
    stacked mLSTM leaves, 1 for the sLSTM's), so the cache equals JAX's
    leaf for leaf, and the reset slot is not a fresh one: its mLSTM m is
    0, not −1e30, and its sLSTM n 0, not 1 (ROADMAP C18)."""
    (jcfg, jparams), (cfg, params) = family_sides("xlstm_1_3b", "float32")
    toks = family_tokens(cfg.vocab_size, seed=7)
    step = jax.jit(lambda t, c, i: jlm.decode_step(jparams, jcfg, t, c, i))
    jcache = jlm.init_cache(jcfg, B, 8)
    cache = lm.init_cache(cfg, B, 8, device="cpu")
    for i in range(4):
        _, jcache = step(jnp.asarray(toks[:, i:i + 1]), jcache,
                         jnp.asarray(i, jnp.int32))
        _, cache = lm.decode_step(params, cfg, torch.from_numpy(
            toks[:, i:i + 1]), cache, i)
    ptr = cache["groups"]["mlstm"][1][0].data_ptr()
    jcache = jlm.reset_slot(jcfg, jcache, 1)
    out = lm.reset_slot(cfg, cache, 1)
    assert out["groups"]["mlstm"][1][0].data_ptr() == ptr
    port, ref = list(lm.tensors(cache)), jax.tree.leaves(jcache)
    assert [tuple(t.shape) for t in port] == [a.shape for a in ref]
    for t, a in zip(port, ref):
        assert np.abs(t.numpy() - np.asarray(a)).max() <= \
            1e-5 * max(np.abs(np.asarray(a)).max(), 1.0)
    _, (C, n, m) = cache["groups"]["mlstm"]
    assert bool((m[:, :, 1] == 0).all()) and bool((m[:, :, 0] > -1e29).all())
    assert not C[:, :, 1].any() and C[:, :, 0].abs().sum() > 0
    fresh = lm.init_cache(cfg, B, 8, device="cpu")
    assert bool((fresh["groups"]["mlstm"][1][2] == -1e30).all())
    assert bool((fresh["groups"]["slstm"][1] == 1).all())
    assert not cache["groups"]["slstm"][1][:, 1].any()


@pytest.mark.parametrize("arch", ("llama3_2_3b",) + FAMILIES)
def test_idle_rows_match_jax(arch):
    """Rows at position −1 ride along a decode step: their attention sees
    no key and gets the mean of v, as in ``attention_xla`` (ROADMAP C9),
    so their logits, the MoE capacity they take and the recurrent states
    they advance (C17) are the reference's; every row's logits within
    1e-5."""
    (jcfg, jparams), (cfg, params) = family_sides(arch, "float32")
    toks = family_tokens(cfg.vocab_size, seed=6)
    sched = [(i, -1 if i % 3 == 1 else i // 2) for i in range(12)]
    step = jax.jit(lambda t, c, i: jlm.decode_step(jparams, jcfg, t, c, i))
    jcache = jlm.init_cache(jcfg, B, 12)
    cache = lm.init_cache(cfg, B, 12, device="cpu")
    for i, p1 in sched:
        pos = np.array([i, p1], np.int32)
        jl, jcache = step(jnp.asarray(toks[:, i:i + 1]), jcache,
                          jnp.asarray(pos))
        lg, cache = lm.decode_step(params, cfg, torch.from_numpy(
            toks[:, i:i + 1]), cache, torch.from_numpy(pos))
        assert rel(lg.numpy(), np.asarray(jl)) < 1e-5, (i, p1)

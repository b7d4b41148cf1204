"""Parity of the port's dense LM with the JAX package on the reduced
llama3.2-3b: JAX's own parameters carried across by
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
    for arch in ("dbrx_132b", "recurrentgemma_9b", "xlstm_1_3b"):
        cfg = get_config(arch).reduced()
        with pytest.raises(NotImplementedError, match="A12"):
            lm.init_params(cfg, torch.Generator().manual_seed(0))


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

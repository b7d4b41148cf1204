"""Parity of the port's RecurrentGemma recurrent block
(``repro_torch.models.rglru``) with the JAX package's
(``repro/models/rglru.py``) on the reduced recurrentgemma-9b: JAX's own
parameters carried across, inputs drawn with numpy from a seed, float32.

* ``apply_recurrent_block`` over a sequence (the port's sequential scan
  against the reference's associative scan): y within 1e-5 of max|y|;
* step-by-step decode with the carried (conv, h) state: every step's y
  and the final state within 1e-5, and the decode equal to the forward;
* a prefill from a carried state (h0 folded into the first step);
* ``lambda_param`` and ``h`` stay float32 in a bfloat16 block.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.distributed.sharding import unbox  # noqa: E402
from repro.models import rglru as JRG  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import _lm_tensor  # noqa: E402
from repro_torch.models import rglru as RG  # noqa: E402

B, S = 2, 16


def sides(dtype="float32", seed=0):
    jcfg = jax_get_config("recurrentgemma_9b").reduced().replace(dtype=dtype)
    cfg = get_config("recurrentgemma_9b").reduced().replace(dtype=dtype)
    jp = JRG.init_recurrent_block(jax.random.PRNGKey(seed), jcfg,
                                  jnp.dtype(dtype))
    tree = jax.tree.map(np.asarray, unbox(jp))
    p = {k: _lm_tensor(v, torch.device("cpu")) for k, v in tree.items()}
    return (jcfg, jp), (cfg, p)


def inputs(d, seed=7, s=S):
    x = np.random.default_rng(seed).standard_normal((B, s, d)).astype(
        np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def close(a, b, tol=1e-5):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a - b).max() <= tol * max(np.abs(b).max(), 1e-30)


def test_forward_matches_jax():
    (jcfg, jp), (cfg, p) = sides()
    jx, x = inputs(cfg.d_model)
    jy, _ = JRG.apply_recurrent_block(jp, jcfg, jx)
    y, state = RG.apply_recurrent_block(p, cfg, x)
    assert state is None and y.shape == (B, S, cfg.d_model)
    assert close(y.numpy(), jy)


def test_stepwise_decode_with_carried_state_matches_jax_and_forward():
    (jcfg, jp), (cfg, p) = sides()
    jx, x = inputs(cfg.d_model, seed=8)
    js = JRG.init_recurrent_state(jcfg, B, jnp.float32)
    st = RG.init_recurrent_state(cfg, B, torch.float32, device="cpu")
    assert st["h"].dtype == torch.float32 and st["conv"].shape == (
        B, cfg.conv_width - 1, cfg.lru_width)
    ys = []
    for t in range(S):
        jy, js = JRG.apply_recurrent_block(jp, jcfg, jx[:, t:t + 1], js)
        y, st = RG.apply_recurrent_block(p, cfg, x[:, t:t + 1], st)
        assert close(y.numpy(), jy)
        ys.append(y)
    assert close(st["h"].numpy(), js["h"]) and close(st["conv"].numpy(),
                                                     js["conv"])
    full, _ = RG.apply_recurrent_block(p, cfg, x)
    assert close(torch.cat(ys, 1).numpy(), full.numpy())


def test_prefill_from_a_carried_state_matches_jax():
    (jcfg, jp), (cfg, p) = sides()
    jx, x = inputs(cfg.d_model, seed=9)
    js = JRG.init_recurrent_state(jcfg, B, jnp.float32)
    st = RG.init_recurrent_state(cfg, B, torch.float32, device="cpu")
    _, js = JRG.apply_recurrent_block(jp, jcfg, jx[:, :5], js)
    _, st = RG.apply_recurrent_block(p, cfg, x[:, :5], st)
    jy, js = JRG.apply_recurrent_block(jp, jcfg, jx[:, 5:], js)
    y, st = RG.apply_recurrent_block(p, cfg, x[:, 5:], st)
    assert close(y.numpy(), jy) and close(st["h"].numpy(), js["h"])


def test_float32_leaves_of_a_bfloat16_block():
    _, (cfg, p) = sides("bfloat16")
    assert p["lambda_param"].dtype == torch.float32
    assert p["w_rec_in"].dtype == torch.bfloat16
    drawn = RG.init_recurrent_block(torch.Generator().manual_seed(0), cfg,
                                    torch.bfloat16)
    assert {k: v.dtype for k, v in drawn.items()} == \
        {k: v.dtype for k, v in p.items()}
    st = RG.init_recurrent_state(cfg, B, torch.bfloat16, device="cpu")
    x = torch.randn(B, 3, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1)).to(torch.bfloat16)
    y, st = RG.apply_recurrent_block(p, cfg, x, st)
    assert y.dtype == torch.bfloat16 and st["h"].dtype == torch.float32
    assert st["conv"].dtype == torch.bfloat16

"""Parity of the port's xLSTM cells and blocks (``repro_torch.models.xlstm``)
with the JAX package's (``repro/models/xlstm.py``): inputs drawn with
numpy from a seed, the same values on both sides.

* the cells in float64 (within 1e-10 of max|out|) and float32 (1e-5):
  ``mlstm_chunkwise`` at chunk sizes 4–32 from no state and from a carried
  one, ``mlstm_step``, ``slstm_scan`` with and without a state; the final
  states too;
* inside the port, the chunkwise form equals the step-by-step recurrence
  and a prefill continued from its carried state equals the whole
  sequence (as ``tests/test_recurrent_cells.py`` holds for JAX), float64,
  1e-10;
* the reduced xlstm-1.3b's mLSTM and sLSTM blocks with JAX's parameters
  carried across, float32, 1e-5: a prefill from no state and from a
  carried state, and step-by-step decode (each step's y and the final
  state); ``w_if`` and ``r_*`` stay float32 in a bfloat16 block.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.distributed.sharding import unbox  # noqa: E402
from repro.models import xlstm as JXL  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import _lm_tensor  # noqa: E402
from repro_torch.models import xlstm as XL  # noqa: E402

B, H, S, DK, DV = 2, 3, 32, 8, 16
TOL = {"float64": 1e-10, "float32": 1e-5}


def close(a, b, tol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() <= tol * max(np.abs(b).max(), 1e-30)


def cell_inputs(dtype, seed=0, s=S):
    """q, k, v, logf, logi as numpy arrays (a forget gate near 1, as a
    trained cell's; input gates around 0)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, s, DK))
    k = rng.standard_normal((B, H, s, DK))
    v = rng.standard_normal((B, H, s, DV))
    f = rng.standard_normal((B, H, s)) + 1.0
    logf = -np.log1p(np.exp(-f))
    logi = 0.5 * rng.standard_normal((B, H, s))
    return [a.astype(dtype) for a in (q, k, v, logf, logi)]


def both(arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays])


def carried_state(dtype, seed=1):
    rng = np.random.default_rng(seed)
    C = rng.standard_normal((B, H, DK, DV))
    n = rng.standard_normal((B, H, DK))
    m = rng.standard_normal((B, H))
    return [a.astype(dtype) for a in (C, n, m)]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("chunk", [4, 8, 16, 32])
def test_mlstm_chunkwise_matches_jax(dtype, chunk):
    (jq, *jr), (q, *r) = both(cell_inputs(dtype))
    for st in (None, carried_state(dtype)):
        jst, tst = (None, None) if st is None else both(st)
        jh, jfin = JXL.mlstm_chunkwise(jq, *jr, chunk, None if jst is None
                                       else tuple(jst))
        h, fin = XL.mlstm_chunkwise(q, *r, chunk, None if tst is None
                                    else tuple(tst))
        assert h.dtype == getattr(torch, dtype)
        assert close(h.numpy(), jh, TOL[dtype])
        for a, b in zip(fin, jfin):
            assert close(a.numpy(), b, TOL[dtype])


def test_mlstm_chunkwise_raises_on_a_ragged_sequence():
    _, (q, k, v, lf, li) = both(cell_inputs("float32"))
    with pytest.raises(ValueError, match="multiple"):
        XL.mlstm_chunkwise(q, k, v, lf, li, 5)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_mlstm_step_matches_jax(dtype):
    (jq, jk, jv, jf, ji), (q, k, v, lf, li) = both(cell_inputs(dtype, s=4))
    jst, st = both(carried_state(dtype))
    jst, st = tuple(jst), tuple(st)
    for t in range(4):
        jh, jst = JXL.mlstm_step(jq[:, :, t], jk[:, :, t], jv[:, :, t],
                                 jf[:, :, t], ji[:, :, t], jst)
        h, st = XL.mlstm_step(q[:, :, t], k[:, :, t], v[:, :, t],
                              lf[:, :, t], li[:, :, t], st)
        assert close(h.numpy(), jh, TOL[dtype])
    for a, b in zip(st, jst):
        assert close(a.numpy(), b, TOL[dtype])


def test_port_chunkwise_equals_its_recurrence_and_continues():
    _, (q, k, v, lf, li) = both(cell_inputs("float64", seed=2))
    st = (torch.zeros(B, H, DK, DV, dtype=torch.float64),
          torch.zeros(B, H, DK, dtype=torch.float64),
          torch.full((B, H), -1e30, dtype=torch.float64))
    outs = []
    for t in range(S):
        h, st = XL.mlstm_step(q[:, :, t], k[:, :, t], v[:, :, t],
                              lf[:, :, t], li[:, :, t], st)
        outs.append(h)
    ref = torch.stack(outs, 2)
    for chunk in (4, 8, 16, 32):
        h, fin = XL.mlstm_chunkwise(q, k, v, lf, li, chunk)
        assert close(h.numpy(), ref.numpy(), 1e-10), chunk
        for a, b in zip(fin, st):
            assert close(a.numpy(), b.numpy(), 1e-10), chunk
    half = S // 2
    h1, mid = XL.mlstm_chunkwise(q[:, :, :half], k[:, :, :half],
                                 v[:, :, :half], lf[:, :, :half],
                                 li[:, :, :half], 4)
    h2, _ = XL.mlstm_chunkwise(q[:, :, half:], k[:, :, half:],
                               v[:, :, half:], lf[:, :, half:],
                               li[:, :, half:], 8, state=mid)
    assert close(torch.cat([h1, h2], 2).numpy(), ref.numpy(), 1e-10)


def slstm_inputs(dtype, seed=3, s=12, w=24, nh=3):
    rng = np.random.default_rng(seed)
    pre = [rng.standard_normal((B, s, w)).astype(dtype) for _ in range(4)]
    r = [(rng.standard_normal((nh, w // nh, w // nh))
          / np.sqrt(w // nh)).astype(dtype) for _ in range(4)]
    state = [rng.standard_normal((B, w)).astype(dtype) for _ in range(4)]
    state[1] = np.abs(state[1]) + 0.5                 # a normalizer
    return pre, r, state


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_slstm_scan_matches_jax(dtype):
    pre, r, state = slstm_inputs(dtype)
    (jpre, tpre), (jr, tr) = both(pre), both(r)
    for st in (None, state):
        jst, tst = (None, None) if st is None else both(st)
        jh, jfin = JXL.slstm_scan(*jpre, *jr, None if jst is None
                                  else tuple(jst))
        h, fin = XL.slstm_scan(*tpre, *tr, None if tst is None
                               else tuple(tst))
        assert h.dtype == getattr(torch, dtype)
        assert close(h.numpy(), jh, TOL[dtype])
        for a, b in zip(fin, jfin):
            assert close(a.numpy(), b, TOL[dtype])


# ---------------------------------------------------------------------------
# blocks, on the reduced xlstm-1.3b
# ---------------------------------------------------------------------------

def block_sides(kind, dtype="float32", seed=0):
    jcfg = jax_get_config("xlstm_1_3b").reduced().replace(dtype=dtype,
                                                         mlstm_chunk=4)
    cfg = get_config("xlstm_1_3b").reduced().replace(dtype=dtype,
                                                     mlstm_chunk=4)
    init = JXL.init_mlstm_block if kind == "mlstm" else JXL.init_slstm_block
    jp = init(jax.random.PRNGKey(seed), jcfg, jnp.dtype(dtype))
    tree = jax.tree.map(np.asarray, unbox(jp))
    p = {k: _lm_tensor(v, torch.device("cpu")) for k, v in tree.items()}
    return (jcfg, jp), (cfg, p)


def block_states(kind, cfg, jcfg):
    if kind == "mlstm":
        return (JXL.init_mlstm_state(jcfg, B, jnp.float32),
                XL.init_mlstm_state(cfg, B, torch.float32, device="cpu"))
    return JXL.init_slstm_state(jcfg, B), XL.init_slstm_state(cfg, B,
                                                             device="cpu")


def leaves(state):
    if isinstance(state, (tuple, list)):
        return [x for s in state for x in leaves(s)]
    return [state]


def apply(kind, mod, p, cfg, x, state=None, decode=False):
    if kind == "mlstm":
        return mod.apply_mlstm_block(p, cfg, x, state, decode=decode)
    return mod.apply_slstm_block(p, cfg, x, state)


def jax_apply(kind, jp, jcfg):
    """JAX's block, jitted (one program a call signature)."""
    fns = {d: jax.jit(lambda x, s, d=d: apply(kind, JXL, jp, jcfg, x, s, d))
           for d in (False, True)}
    return lambda x, s=None, decode=False: fns[decode](x, s)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_block_prefill_and_decode_match_jax(kind):
    (jcfg, jp), (cfg, p) = block_sides(kind)
    x = np.random.default_rng(7).standard_normal((B, 16, cfg.d_model)) \
        .astype(np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    japply = jax_apply(kind, jp, jcfg)
    # a prefill from no state
    jy, _ = japply(jx)
    y, st = apply(kind, XL, p, cfg, tx)
    assert st is None and close(y.numpy(), jy, 1e-5)
    # a prefill of 8 tokens carrying its state, then 8 decode steps
    js, ts = block_states(kind, cfg, jcfg)
    jy, js = japply(jx[:, :8], js)
    y, ts = apply(kind, XL, p, cfg, tx[:, :8], ts)
    assert close(y.numpy(), jy, 1e-5)
    steps = []
    for t in range(8, 16):
        jy, js = japply(jx[:, t:t + 1], js, decode=True)
        y, ts = apply(kind, XL, p, cfg, tx[:, t:t + 1], ts, decode=True)
        assert close(y.numpy(), jy, 1e-5), t
        steps.append(y)
    for a, b in zip(leaves(ts), leaves(js)):
        assert a.dtype == torch.float32 or kind == "mlstm"
        assert close(a.numpy(), b, 1e-5)
    # the port's own decode equals its prefill over the same tokens
    full, _ = apply(kind, XL, p, cfg, tx)
    assert close(torch.cat(steps, 1).numpy(), full[:, 8:].numpy(), 1e-5)


def test_float32_leaves_of_a_bfloat16_model():
    for kind in ("mlstm", "slstm"):
        _, (cfg, p) = block_sides(kind, "bfloat16")
        init = XL.init_mlstm_block if kind == "mlstm" else \
            XL.init_slstm_block
        drawn = init(torch.Generator().manual_seed(0), cfg, torch.bfloat16)
        assert {k: v.dtype for k, v in drawn.items()} == \
            {k: v.dtype for k, v in p.items()}
        assert {k for k, v in drawn.items() if v.dtype == torch.float32} \
            == ({"w_if"} if kind == "mlstm" else {"r_z", "r_i", "r_f",
                                                  "r_o"})
    conv, (C, n, m) = XL.init_mlstm_state(cfg, B, torch.bfloat16,
                                          device="cpu")
    assert conv.dtype == torch.bfloat16 and C.dtype == n.dtype == m.dtype \
        == torch.float32 and bool((m == -1e30).all())
    c, n, h, m = XL.init_slstm_state(cfg, B, device="cpu")
    assert bool((n == 1).all()) and not bool(c.any() or h.any() or m.any())

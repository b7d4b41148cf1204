"""Parity of the port's MoE block (``repro_torch.models.moe``) with the JAX
package's local path (``repro/models/moe.py``, no mesh) on the reduced
qwen3-moe-30b-a3b and dbrx-132b: JAX's own parameters carried across,
the same inputs drawn with numpy from a seed.

* float32 at capacity factors 0.5 and 1.25 (pairs drop) and 100 (none
  do): y within 1e-5 of max|y|, the aux loss within 1e-6;
* a zero router, so every probability ties: both break the tie toward
  the lower expert index (``lax.top_k``'s order), i.e. pick experts
  0…k−1 with gates 1/k each;
* bfloat16: y within 2e-2 of max|y| (the packages round SiLU and the
  combine at other places);
* expert parallelism (``apply_moe(mesh=)``) on a (1, 4) mesh of torch's
  fake process group, one rank at a time: each rank's part (its 2 of 8
  experts; the fake all-reduce does nothing) sums to the local path's y
  within 1e-5 of max|y|, and E = 6 raises the reference's ValueError.
  The spawned worlds of ``test_torch_lm_mesh.py`` check the all-reduce.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.distributed.sharding import unbox  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import _lm_tensor  # noqa: E402
from repro_torch.launch.mesh import make_smoke_mesh  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from lm_mesh_ranks import fake_world  # noqa: E402

ARCHS = ("qwen3_moe_30b_a3b", "dbrx_132b")
B, S = 2, 16


def sides(arch, dtype, cf, seed=0):
    jcfg = jax_get_config(arch).reduced().replace(dtype=dtype,
                                                  moe_capacity_factor=cf)
    cfg = get_config(arch).reduced().replace(dtype=dtype,
                                             moe_capacity_factor=cf)
    jp = JMOE.init_moe(jax.random.PRNGKey(seed), jcfg, jnp.dtype(dtype))
    tree = jax.tree.map(np.asarray, unbox(jp))
    p = {k: _lm_tensor(v, torch.device("cpu")) for k, v in tree.items()}
    return (jcfg, jp), (cfg, p)


def inputs(d, dtype, seed=5):
    x = np.random.default_rng(seed).standard_normal((B, S, d)).astype(
        np.float32)
    return jnp.asarray(x, jnp.dtype(dtype)), torch.from_numpy(x).to(
        getattr(torch, dtype))


def run_both(jside, side, dtype):
    (jcfg, jp), (cfg, p) = jside, side
    jx, x = inputs(cfg.d_model, dtype)
    jy, jaux = JMOE.apply_moe(jp, jcfg, jx)
    y, aux = MOE.apply_moe(p, cfg, x)
    return (np.asarray(jy, np.float32), float(jaux)), (y.float().numpy(),
                                                      float(aux))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("cf", (0.5, 1.25, 100.0))
def test_apply_moe_matches_jax_in_float32(arch, cf):
    (jy, jaux), (y, aux) = run_both(*sides(arch, "float32", cf), "float32")
    assert y.shape == jy.shape == (B, S, 128)
    assert np.abs(y - jy).max() <= 1e-5 * np.abs(jy).max()
    assert abs(aux - jaux) <= 1e-6 and aux > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_zero_router_ties_pick_the_lowest_experts(arch):
    jside, (cfg, p) = sides(arch, "float32", 100.0)
    jcfg, jp = jside
    jp = dict(jp, router=jax.tree.map(jnp.zeros_like, jp["router"]))
    p = dict(p, router=torch.zeros_like(p["router"]))
    (jy, _), (y, aux) = run_both((jcfg, jp), (cfg, p), "float32")
    assert np.abs(y - jy).max() <= 1e-5 * np.abs(jy).max()
    _, x = inputs(cfg.d_model, "float32")
    xf = x.reshape(B * S, -1)
    k = cfg.experts_per_token
    want = sum(MOE._expert_ffn(p["w_up"][e:e + 1], p["w_gate"][e:e + 1],
                               p["w_down"][e:e + 1], xf[None])[0] / k
               for e in range(k))
    assert np.abs(y.reshape(B * S, -1) - want.numpy()).max() \
        <= 1e-6 * np.abs(jy).max()
    # uniform probabilities, every token on experts 0…k−1: aux = E·k/E
    assert abs(aux - k) <= 1e-6


@pytest.mark.parametrize("arch", ARCHS)
def test_apply_moe_matches_jax_in_bfloat16(arch):
    jside, side = sides(arch, "bfloat16", 1.25)
    assert side[1]["router"].dtype == torch.float32
    assert side[1]["w_up"].dtype == torch.bfloat16
    (jy, jaux), (y, aux) = run_both(jside, side, "bfloat16")
    assert np.abs(y - jy).max() <= 2e-2 * np.abs(jy).max()
    assert abs(aux - jaux) <= 1e-3


def test_mesh_raises_naming_the_roadmap():
    """The mesh path is ported (the name is kept from when it raised):
    the four ranks' parts sum to the local path's output, each rank's
    aux is the local aux over the model axis's 4 ranks (the fake
    all-reduce adds nothing), and E = 6 on 4 ranks raises."""
    _, (cfg, p) = sides("dbrx_132b", "float32", 100.0)
    _, x = inputs(cfg.d_model, "float32")
    want, want_aux = MOE.apply_moe(p, cfg, x)
    total = torch.zeros_like(want)
    for r in range(4):
        with fake_world(r, 4):
            mesh = make_smoke_mesh((1, 4), device="cpu")
            mine = {k: v if k == "router" else v[2 * r:2 * r + 2]
                    for k, v in p.items()}
            y, aux = MOE.apply_moe(mine, cfg, x, mesh=mesh)
            total += y
            assert abs(float(aux) * 4 - float(want_aux)) <= 1e-6
            with pytest.raises(ValueError, match="n_experts=6 not "
                               "divisible by model=4"):
                MOE.apply_moe(p, cfg.replace(n_experts=6), x, mesh=mesh)
    assert (total - want).abs().max() <= 1e-5 * want.abs().max()

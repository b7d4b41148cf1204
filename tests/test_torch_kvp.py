"""Parity of the port's ``gp_mean_kvp`` (kernel K5's plain version on the
CPU) with the JAX package: ``kvp_ref`` in float64 to 1e-12 of Σ|terms|
per row, and the Pallas kernel in interpret mode (float32 inside) to 1e-5
of max|ref|, on the shapes of the JAX package's own kvp test and the BO
path's (10, 544, 20) with _FAR rows."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.kvp.kernel import kvp as jax_kvp  # noqa: E402
from repro.kernels.kvp.ref import kvp_ref as jax_kvp_ref  # noqa: E402
from repro_torch.kernels.kvp import kernel as K  # noqa: E402
from repro_torch.kernels.kvp.ops import gp_mean_kvp  # noqa: E402
from repro_torch.kernels.matern.ref import matern52_gram_ref  # noqa: E402

SHAPES = [(10, 50, 5), (128, 256, 16), (77, 500, 40), (1, 130, 8),
          (10, 544, 20)]


def inputs(q, n, d, far=0):
    rng = np.random.default_rng(q + n)
    xq = rng.standard_normal((q, d))
    xt = rng.standard_normal((n, d))
    if far:                               # the fit's padding pseudo-points
        xt[-far:] = 1e6 + np.arange(far)[:, None]
    al = rng.standard_normal(n)
    if far:
        al[-far:] = 0.0
    ils = np.exp(rng.standard_normal(d) * 0.3)
    return xq, xt, al, ils, 2.1


def sum_scale(xq, xt, al, ils, amp):
    """Σ_j |k_ij α_j| per row: the condition of each sum."""
    t = [torch.tensor(a, dtype=torch.float64) for a in (xq, xt, al, ils, amp)]
    return (matern52_gram_ref(t[0], t[1], t[3], t[4]).abs()
            @ t[2].abs()).numpy()


@pytest.mark.parametrize("q,n,d", SHAPES)
@pytest.mark.parametrize("backend", ["auto", "fused", "plain", "xla"])
def test_gp_mean_kvp_matches_jax(q, n, d, backend):
    far = 32 if n == 544 else 0
    args = inputs(q, n, d, far)
    out = gp_mean_kvp(*(torch.tensor(a, dtype=torch.float64) for a in args),
                      backend=backend).numpy()
    assert out.shape == (q,) and np.all(np.isfinite(out))
    ref = np.asarray(jax_kvp_ref(*(jnp.asarray(a, jnp.float64)
                                   for a in args)))
    assert np.all(np.abs(out - ref) <= 1e-12 * sum_scale(*args))
    pallas = np.asarray(jax_kvp(*(jnp.asarray(a, jnp.float64) for a in args),
                                interpret=True))
    scale = np.abs(ref).max() + 1e-9
    np.testing.assert_allclose(out / scale, pallas / scale, atol=1e-5)
    assert K.launch_counts() == {"kvp_fwd": 0}       # CPU: plain version


def test_gp_mean_kvp_rejects_unknown_backend():
    args = (torch.zeros(2, 3, dtype=torch.float64),
            torch.zeros(4, 3, dtype=torch.float64),
            torch.zeros(4, dtype=torch.float64),
            torch.ones(3, dtype=torch.float64),
            torch.tensor(1.0, dtype=torch.float64))
    with pytest.raises(ValueError, match="unknown backend"):
        gp_mean_kvp(*args, backend="pallas")

"""Card-only tests of the CUDA kernels K1/K2 (no CPU mode exists for a CUDA
kernel, so they skip without a card).  The file imports neither jax nor
the JAX package, so it also runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.mso import MsoOptions, maximize_acqf  # noqa: E402
from repro_torch.engine.posterior import fused_logei_acq  # noqa: E402
from repro_torch.gp.gpr import fit_gram, pad_gp, with_kinv  # noqa: E402
from repro_torch.gp.kernels import KernelParams  # noqa: E402
from repro_torch.kernels.matern import kernel as K  # noqa: E402
from repro_torch.kernels.matern.ops import matern52_posterior_op  # noqa: E402,E501
from repro_torch.kernels.matern.ref import (  # noqa: E402
    matern52_posterior_bwd_ref, matern52_posterior_fwd_ref)

EPS64 = float(np.finfo(np.float64).eps)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def state(n, d, seed, device, n_pad=3):
    rng = np.random.default_rng(seed)
    X = rng.uniform(0, 1, (n - n_pad, d))
    y = np.sin(5 * X).sum(1) + 0.05 * rng.standard_normal(n - n_pad)
    y = (y - y.mean()) / y.std()
    p = KernelParams(
        torch.full((d,), math.log(0.3 * math.sqrt(d)), dtype=torch.float64,
                   device=device),
        torch.tensor(0.2, dtype=torch.float64, device=device),
        torch.tensor(-4.0, dtype=torch.float64, device=device))
    gp = with_kinv(fit_gram(torch.tensor(X, device=device),
                            torch.tensor(y, device=device), p))
    return pad_gp(gp, n)          # _FAR pseudo-points, as the fit pads


def args_of(gp):
    return (gp.x_train, gp.alpha, gp.kinv,
            torch.exp(-gp.params.log_lengthscale), gp.params.amplitude)


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,q", [(32, 3, 5), (160, 8, 129), (544, 20, 10)])
def test_kernels_match_plain_versions_on_card(cuda, n, d, q):
    gp = state(n, d, seed=n, device=cuda)
    args = args_of(gp)
    xq = torch.tensor(np.random.default_rng(q).uniform(0, 1, (q, d)),
                      device=cuda)
    K.reset_launch_counts()
    m_k, v_k, t_k = K.matern52_posterior_fwd(xq, *args)
    m_r, v_r, t_r = matern52_posterior_fwd_ref(xq, *args)
    gm, gv = torch.ones_like(m_k), -0.5 * torch.ones_like(m_k)
    xt, alpha, _, ils, amp = args
    g_k = K.matern52_posterior_bwd_xq(xq, xt, alpha, t_k, v_k, ils, amp,
                                      gm, gv)
    g_r = matern52_posterior_bwd_ref(xq, xt, alpha, t_r, v_r, ils, amp,
                                     gm, gv)
    torch.cuda.synchronize()
    assert K.launch_counts() == {"matern52_posterior_fwd": 1,
                                 "matern52_posterior_bwd_xq": 1}
    # f64 sums in another order; var cancels, so its bound follows ‖K⁻¹‖
    torch.testing.assert_close(m_k, m_r, rtol=1e-11, atol=1e-11)
    torch.testing.assert_close(t_k, t_r, rtol=1e-11, atol=1e-11)
    a, kmax = float(amp), float(gp.kinv.abs().max())
    torch.testing.assert_close(v_k, v_r, rtol=0,
                               atol=8 * n * EPS64 * a * a * kmax)
    torch.testing.assert_close(g_k, g_r, rtol=1e-11, atol=1e-11)
    # row 0 alone is bitwise row 0 of the batch
    m1, v1, t1 = K.matern52_posterior_fwd(xq[:1].contiguous(), *args)
    assert torch.equal(m1[0], m_k[0]) and torch.equal(v1[0], v_k[0])
    assert torch.equal(t1[0], t_k[0])


@pytest.mark.cuda
def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    gp = state(32, 3, seed=1, device=cuda)
    xq = torch.rand(4, 3, dtype=torch.float64, device=cuda)
    xt, alpha, kinv, ils, amp = args_of(gp)
    with pytest.raises(TypeError, match="float64"):
        K.matern52_posterior_fwd(xq.float(), xt, alpha, kinv, ils, amp)
    with pytest.raises(ValueError, match="contiguous"):
        K.matern52_posterior_fwd(xq, xt, alpha, kinv.T, ils, amp)
    with pytest.raises(ValueError, match="shape"):
        K.matern52_posterior_fwd(xq, xt, alpha[:-1], kinv, ils, amp)
    # the autograd op passes its inputs through as they are: no copy
    with pytest.raises(ValueError, match="contiguous"):
        matern52_posterior_op(xq, xt, alpha, kinv.T, ils, amp)


@pytest.mark.cuda
def test_c3_bitwise_on_card(cuda):
    gp = state(64, 4, seed=3, device=cuda)
    best = gp.y_train.max()
    x0 = np.random.default_rng(4).uniform(0, 1, (6, 4))
    acq = fused_logei_acq("fused")
    opts = MsoOptions(maxiter=100, pgtol=1e-5)
    seq, dbe = (maximize_acqf(acq, x0, 0.0, 1.0, acq_state=(gp, best),
                              strategy=s, options=opts)
                for s in ("seq", "dbe"))
    np.testing.assert_array_equal(seq.n_iters, dbe.n_iters)
    np.testing.assert_array_equal(seq.n_evals, dbe.n_evals)
    np.testing.assert_array_equal(seq.x, dbe.x)
    # each MSO's engine counts its own launches: one K1 and one K2 a round
    for res in (seq, dbe):
        assert res.engine_stats["kernel_launches"] == {
            "matern52_posterior_fwd": res.n_rounds,
            "matern52_posterior_bwd_xq": res.n_rounds}
    # one long restart sets D-BE's round count here, so only "fewer"
    assert dbe.n_rounds < seq.n_rounds

"""Card-only tests of the CUDA kernels K1–K4 and of the fused ask on the card
(no CPU mode exists for a CUDA kernel, so they skip without a card).  The file imports neither jax nor
the JAX package, so it also runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.bo.sampler import GPSampler  # noqa: E402
from repro_torch.bo.space import BoxSpace  # noqa: E402
from repro_torch.core.mso import MsoOptions, maximize_acqf  # noqa: E402
from repro_torch.engine.posterior import fused_logei_acq  # noqa: E402
from repro_torch.gp.gpr import fit_gram, pad_gp, with_kinv  # noqa: E402
from repro_torch.gp.kernels import KernelParams  # noqa: E402
from repro_torch.kernels.matern import kernel as K  # noqa: E402
from repro_torch.kernels.matern.ops import matern52_posterior_op  # noqa: E402,E501
from repro_torch.kernels.matern.ref import (  # noqa: E402
    SQRT5, _scaled_sq_dists, matern52_gram_bwd_theta_ref, matern52_gram_ref,
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
                                 "matern52_posterior_bwd_xq": 1,
                                 "matern52_gram_fwd": 0,
                                 "matern52_gram_bwd_theta": 0}
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
    # (the gram kernels ran only in building the state, outside the MSO)
    for res in (seq, dbe):
        assert res.engine_stats["kernel_launches"] == {
            "matern52_posterior_fwd": res.n_rounds,
            "matern52_posterior_bwd_xq": res.n_rounds,
            "matern52_gram_fwd": 0, "matern52_gram_bwd_theta": 0}
    # one long restart sets D-BE's round count here, so only "fewer"
    assert dbe.n_rounds < seq.n_rounds


def gram_tolerances(x1, x2, ils, amp, g):
    """Stated tolerances of K3/K4 against their plain versions: K3 per
    entry 4·D·eps·σ_f²·(1 + |a_i|² + |b_j|²) (the expanded d² cancels to
    eps·(|a|² + |b|²)); K4 1e-10 of Σ|terms| of each sum."""
    a, b, d2 = _scaled_sq_dists(x1, x2, ils)
    d = x1.shape[1]
    k_tol = 4 * d * EPS64 * amp[:, None, None] * (
        1 + (a * a).sum(-1)[..., :, None] + (b * b).sum(-1)[..., None, :])
    r = torch.sqrt(d2 + 1e-36)
    e = torch.exp(-SQRT5 * r)
    c = g.abs() * (1 + SQRT5 * r) * e
    s_il = torch.stack([(c * (x1[:, k, None] - x2[None, :, k]) ** 2
                         ).sum((-1, -2)) for k in range(d)], -1)
    s_il = (5 / 3) * amp[:, None] * ils * s_il
    s_amp = (g.abs() * (1 + SQRT5 * r + 5 / 3 * d2) * e).sum((-1, -2))
    return k_tol, 1e-10 * s_il, 1e-10 * s_amp


def gram_inputs(n1, n2, d, r, device, far=0, seed=0):
    rng = np.random.default_rng(seed + 31 * n1 + d)
    x1 = rng.uniform(0, 1, (n1, d))
    x2 = x1 if n1 == n2 else rng.uniform(0, 1, (n2, d))
    if far:
        x2 = x2.copy()
        x2[-far:] = 1e6 + np.arange(far)[:, None]
        x1 = x2 if n1 == n2 else x1
    ils = np.exp(rng.uniform(-1.0, 4.0, (r, d)))
    amp = np.exp(rng.uniform(-1.0, 1.0, r))
    g = rng.standard_normal((r, n1, n2))
    if far:          # as in the masked LML: no gradient into _FAR entries
        g[:, :, -far:] = 0.0
        if n1 == n2:
            g[:, -far:, :] = 0.0
    return tuple(torch.tensor(v, device=device) for v in (x1, x2, ils, amp, g))


@pytest.mark.cuda
@pytest.mark.parametrize("n1,n2,d,r,far", [
    (32, 32, 5, 2, 0), (544, 544, 20, 2, 32), (1, 544, 20, 1, 32),
    (130, 250, 40, 1, 0), (77, 77, 3, 3, 9)])
def test_gram_kernels_match_plain_versions_on_card(cuda, n1, n2, d, r, far):
    x1, x2, ils, amp, g = gram_inputs(n1, n2, d, r, cuda, far)
    K.reset_launch_counts()
    k_k = K.matern52_gram_fwd(x1, x2, ils, amp)
    k_r = matern52_gram_ref(x1, x2, ils, amp)
    di_k, da_k = K.matern52_gram_bwd_theta(x1, x2, ils, amp, g)
    di_r, da_r = matern52_gram_bwd_theta_ref(x1, x2, ils, amp, g)
    di_2, da_2 = K.matern52_gram_bwd_theta(x1, x2, ils, amp, g)
    torch.cuda.synchronize()
    assert K.launch_counts()["matern52_gram_fwd"] == 1
    assert K.launch_counts()["matern52_gram_bwd_theta"] == 2
    assert bool(torch.isfinite(k_k).all())
    k_tol, il_tol, amp_tol = gram_tolerances(x1, x2, ils, amp, g)
    # entries between two _FAR rows are cancellation noise in any expanded
    # d² (finite, checked above); the fit multiplies them by 0
    real = torch.ones((n1, n2), dtype=torch.bool, device=cuda)
    if far and n1 == n2:
        real[-far:, -far:] = False
    assert bool(((k_k - k_r).abs() <= k_tol)[:, real].all())
    assert bool(((di_k - di_r).abs() <= il_tol).all())
    assert bool(((da_k - da_r).abs() <= amp_tol).all())
    # fixed-order sums, no atomics: bitwise the same run to run
    assert torch.equal(di_k, di_2) and torch.equal(da_k, da_2)
    if n1 == n2:                       # K3 at x1 = x2: d² = 0 exactly
        assert torch.equal(torch.diagonal(k_k, dim1=-2, dim2=-1),
                           amp[:, None].expand(r, n1))


@pytest.mark.cuda
def test_gram_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    x1, x2, ils, amp, g = gram_inputs(8, 8, 3, 2, cuda)
    with pytest.raises(ValueError, match="shape"):
        K.matern52_gram_fwd(x1, x2, ils[:, :2], amp)
    with pytest.raises(ValueError, match="contiguous"):
        K.matern52_gram_bwd_theta(x1, x2, ils, amp, g.transpose(1, 2))
    from repro_torch.kernels.matern.ops import matern52_gram_op
    with pytest.raises(ValueError, match="must not require grad"):
        matern52_gram_op(x1.clone().requires_grad_(True), x2, ils, amp)


def _sphere(x):
    return float(np.sum((x - 0.4) ** 2))


@pytest.mark.cuda
def test_fused_ask_launches_and_equals_host_on_card(cuda):
    """Every fit evaluation is one K3 and one K4 launch, the post-fit gram
    one K3, an incremental ask one K3 (its cross column), every MSO round
    one K1 and one K2; fused == host bitwise at refit_interval=1."""
    space = BoxSpace.cube(3, -1.0, 1.0)
    s = GPSampler(space, strategy="dbe_vec", n_startup_trials=5,
                  n_restarts=6, pad_multiple=8, seed=3)
    assert s.fused and s.device.type == "cuda"
    kinds = set()
    for _ in range(16):
        before = K.launch_counts()
        tr = s.ask()
        after = K.launch_counts()
        s.tell(tr.trial_id, _sphere(tr.x))
        info = s.last_ask_info
        if info is None or len(s.trials) <= 5:
            continue
        delta = {k: after[k] - before[k] for k in after}
        kinds.add(info.kind)
        assert delta["matern52_posterior_fwd"] == info.rounds
        assert delta["matern52_posterior_bwd_xq"] == info.rounds
        assert delta["matern52_gram_bwd_theta"] == info.fit_evals
        assert delta["matern52_gram_fwd"] == (
            1 if info.kind == "incremental" else info.fit_evals + 1)
    assert kinds == {"full", "incremental"}
    xs = []
    for fused in (False, True):
        h = GPSampler(space, strategy="dbe_vec", n_startup_trials=5,
                      n_restarts=6, pad_multiple=8, seed=3, fused=fused,
                      refit_interval=1, warm_start=False)
        out = []
        for _ in range(11):
            tr = h.ask()
            h.tell(tr.trial_id, _sphere(tr.x))
            out.append(tr.x)
        xs.append(np.array(out))
    np.testing.assert_array_equal(xs[0], xs[1])

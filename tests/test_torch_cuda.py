"""Card-only tests of the CUDA kernels K1–K9, of the fused ask and of the
serving engine on the card
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
    y = (y - y.mean()) / (y.std() or 1.0)
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


def k1_tolerances(xq, gp):
    """K1's stated tolerances against its plain version: mean and t
    within 1e-11 of Σ|terms| of their sums; var (which cancels) within
    8·n·eps·σ_f⁴·max|K⁻¹|."""
    xt, alpha, kinv, ils, amp = args_of(gp)
    k = matern52_gram_ref(xq, xt, ils, amp).abs()
    a = float(amp)
    return (1e-11 * float((k @ alpha.abs()).max()),
            1e-11 * float((k @ kinv.abs()).max()),
            8 * xt.shape[0] * EPS64 * a * a * float(kinv.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 31, 32, 33, 513, 544, 2048])
def test_posterior_fwd_rows_bitwise_at_any_batch_and_regime_on_card(cuda, n):
    """K1 over ragged chunks (64 rows of K⁻¹) and tiles (64 columns), the
    last 3 training rows _FAR pseudo-points (n > 1): row 0 is bitwise the
    same alone, in a batch of 10 that ends in repeated padding rows, and
    in a batch of 1000 (the walk regime from n = 513 on, the split regime
    below it); a second call repeats every bit; every batch is within the
    stated tolerances of the plain version."""
    d = 20
    gp = state(n, d, seed=n, device=cuda, n_pad=min(3, n - 1))
    args = args_of(gp)
    x = torch.tensor(np.random.default_rng(n).uniform(0, 1, (1000, d)),
                     device=cuda)
    x[1] = gp.x_train[0]                       # a query on a training point
    batches = {1: x[:1].contiguous(),
               10: torch.cat([x[:7], x[6:7].expand(3, d)]).contiguous(),
               1000: x}
    regimes = {q: K.plan(q, n, d).regime for q in batches}
    assert regimes[1] == regimes[10] == "split"
    assert regimes[1000] == ("walk" if n >= 513 else "split")
    K.reset_launch_counts()
    outs = {q: K.matern52_posterior_fwd(xq, *args)
            for q, xq in batches.items()}
    again = {q: K.matern52_posterior_fwd(xq, *args)
             for q, xq in batches.items()}
    torch.cuda.synchronize()
    assert K.launch_counts()["matern52_posterior_fwd"] == 6
    for q, xq in batches.items():
        for a, b in zip(outs[q], again[q]):
            assert torch.equal(a, b)                     # run to run
        for a, b in zip(outs[1], outs[q]):
            assert torch.equal(a[0], b[0])               # row 0 at any q
        m_r, v_r, t_r = matern52_posterior_fwd_ref(xq, *args)
        m_k, v_k, t_k = outs[q]
        tol_m, tol_t, tol_v = k1_tolerances(xq, gp)
        assert bool(torch.isfinite(t_k).all())
        assert float((m_k - m_r).abs().max()) <= tol_m
        assert float((t_k - t_r).abs().max()) <= tol_t
        assert float((v_k - v_r).abs().max()) <= tol_v
    for out in outs[10]:
        assert torch.equal(out[6], out[9])               # repeated rows


def k2_tolerance(xq, gp, t):
    """K2's stated tolerance against its plain version: 1e-11 of Σ|terms|
    of its sums, (Σ_j |c_ij| w_ij) |a_i| + Σ_j |c_ij| w_ij |b_j|, scaled
    by 1/ℓ, with w_ij = |α_j| + 2 |t_ij|."""
    xt, alpha, _, ils, amp = args_of(gp)
    a, b, d2 = _scaled_sq_dists(xq, xt, ils)
    r = torch.sqrt(d2 + 1e-36)
    cw = ((5.0 / 3.0) * amp * (1.0 + SQRT5 * r) * torch.exp(-SQRT5 * r)
          * (alpha.abs()[None, :] + 2.0 * t.abs()))
    return 1e-11 * float((ils * (cw.sum(-1, keepdim=True) * a.abs()
                                 + cw @ b.abs())).max())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 31, 63, 64, 65, 513, 544, 2048])
def test_posterior_bwd_rows_bitwise_at_any_batch_on_card(cuda, n):
    """K2 over ragged tiles (64 training points), the last 3 training
    rows _FAR pseudo-points (n > 1): row 0 of dxq is bitwise the same
    alone (a row a split block), in a batch of 10 that ends in repeated
    padding rows, and in a batch of 1000 (16 rows a block); a second call
    repeats every bit; every batch is within 1e-11 of Σ|terms| of the
    plain version.  Every batch reads the same t and var rows."""
    d = 20
    gp = state(n, d, seed=n, device=cuda, n_pad=min(3, n - 1))
    xt, alpha, _, ils, amp = args = args_of(gp)
    rng = np.random.default_rng(n)
    x = torch.tensor(rng.uniform(0, 1, (1000, d)), device=cuda)
    x[1] = gp.x_train[0]                       # a query on a training point
    _, var, t = matern52_posterior_fwd_ref(x, *args)
    gm = torch.tensor(rng.standard_normal(1000), device=cuda)
    gv = torch.tensor(rng.standard_normal(1000), device=cuda)
    rows = {1: [0], 10: [0, 1, 2, 3, 4, 5, 6, 6, 6, 6], 1000: range(1000)}
    batches = {q: tuple(v[torch.tensor(idx, device=cuda)].contiguous()
                        for v in (x, t, var, gm, gv))
               for q, idx in rows.items()}
    assert [K.bwd_plan(q, n, d).rows for q in batches] == [1, 1, 16]

    def bwd(xq, tq, vq, gmq, gvq):
        return K.matern52_posterior_bwd_xq(xq, xt, alpha, tq, vq, ils, amp,
                                           gmq, gvq)

    K.reset_launch_counts()
    outs = {q: bwd(*b) for q, b in batches.items()}
    again = {q: bwd(*b) for q, b in batches.items()}
    torch.cuda.synchronize()
    assert K.launch_counts()["matern52_posterior_bwd_xq"] == 6
    for q, (xq, tq, vq, gmq, gvq) in batches.items():
        assert torch.equal(outs[q], again[q])            # run to run
        assert torch.equal(outs[1][0], outs[q][0])       # row 0 at any q
        assert bool(torch.isfinite(outs[q]).all())
        ref = matern52_posterior_bwd_ref(xq, xt, alpha, tq, vq, ils, amp,
                                         gmq, gvq)
        assert float((outs[q] - ref).abs().max()) <= k2_tolerance(xq, gp, tq)
    assert torch.equal(outs[10][6], outs[10][9])         # repeated rows


@pytest.mark.cuda
@pytest.mark.parametrize("d", [100, 300, 1000])
@pytest.mark.parametrize("n", [33, 544])
def test_posterior_kernels_take_any_d_on_card(cuda, n, d):
    """K1 (split regime, D staged in pieces of 64) and K2 at D past what
    one block's shared memory held whole: within their stated tolerances
    of the plain versions, and row 0 bitwise the same at q = 1 and 10.
    The GP is fitted on the card (its gram by K3, D in pieces too)."""
    gp = state(n, d, seed=n + d, device=cuda)
    xt, alpha, _, ils, amp = args = args_of(gp)
    rng = np.random.default_rng(d)
    x = torch.tensor(rng.uniform(0, 1, (10, d)), device=cuda)
    x[1] = gp.x_train[0]
    gm = torch.tensor(rng.standard_normal(10), device=cuda)
    gv = torch.tensor(rng.standard_normal(10), device=cuda)
    outs = {}
    for q in (1, 10):
        xq = x[:q].contiguous()
        assert K.plan(q, n, d).regime == "split"
        m_k, v_k, t_k = K.matern52_posterior_fwd(xq, *args)
        g_k = K.matern52_posterior_bwd_xq(xq, xt, alpha, t_k, v_k, ils, amp,
                                          gm[:q], gv[:q])
        m_r, v_r, t_r = matern52_posterior_fwd_ref(xq, *args)
        g_r = matern52_posterior_bwd_ref(xq, xt, alpha, t_k, v_k, ils, amp,
                                         gm[:q], gv[:q])
        torch.cuda.synchronize()
        tol_m, tol_t, tol_v = k1_tolerances(xq, gp)
        assert bool(torch.isfinite(g_k).all())
        assert float((m_k - m_r).abs().max()) <= tol_m
        assert float((t_k - t_r).abs().max()) <= tol_t
        assert float((v_k - v_r).abs().max()) <= tol_v
        assert float((g_k - g_r).abs().max()) <= k2_tolerance(xq, gp, t_k)
        outs[q] = (m_k, v_k, t_k, g_k)
    for a, b in zip(outs[1], outs[10]):
        assert torch.equal(a[0], b[0])


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
    """x1, x2, 1/ℓ, σ_f², Ḡ; where n1 = n2, x1 is x2 (one tensor: the fit's
    call, K3/K4's symmetric path)."""
    rng = np.random.default_rng(seed + 31 * n1 + d)
    x1 = rng.uniform(0, 1, (n1, d))
    x2 = x1 if n1 == n2 else rng.uniform(0, 1, (n2, d))
    if far:
        x2 = x2.copy()
        x2[-far:] = 1e6 + np.arange(far)[:, None]
    ils = np.exp(rng.uniform(-1.0, 4.0, (r, d)))
    amp = np.exp(rng.uniform(-1.0, 1.0, r))
    g = rng.standard_normal((r, n1, n2))
    if far:          # as in the masked LML: no gradient into _FAR entries
        g[:, :, -far:] = 0.0
        if n1 == n2:
            g[:, -far:, :] = 0.0
    x1, x2, ils, amp, g = (torch.tensor(v, device=device)
                           for v in (x1, x2, ils, amp, g))
    return (x2 if n1 == n2 else x1), x2, ils, amp, g


def assert_gram_close(x1, x2, ils, amp, g, far, k_k, di_k, da_k):
    """K3 and K4's outputs within their stated tolerances of the plain
    versions (entries between two _FAR rows excepted for K3: cancellation
    noise in any expanded d², finite; the fit multiplies them by 0)."""
    n1, n2 = x1.shape[0], x2.shape[0]
    k_r = matern52_gram_ref(x1, x2, ils, amp)
    di_r, da_r = matern52_gram_bwd_theta_ref(x1, x2, ils, amp, g)
    assert bool(torch.isfinite(k_k).all())
    assert bool(torch.isfinite(di_k).all() and torch.isfinite(da_k).all())
    k_tol, il_tol, amp_tol = gram_tolerances(x1, x2, ils, amp, g)
    real = torch.ones((n1, n2), dtype=torch.bool, device=x1.device)
    if far and n1 == n2:
        real[-far:, -far:] = False
    assert bool(((k_k - k_r).abs() <= k_tol)[:, real].all())
    assert bool(((di_k - di_r).abs() <= il_tol).all())
    assert bool(((da_k - da_r).abs() <= amp_tol).all())


@pytest.mark.cuda
@pytest.mark.parametrize("n1,n2,d,r,far", [
    (32, 32, 5, 2, 0), (544, 544, 20, 2, 32), (1, 544, 20, 1, 32),
    (130, 250, 40, 1, 0), (77, 77, 3, 3, 9)])
def test_gram_kernels_match_plain_versions_on_card(cuda, n1, n2, d, r, far):
    x1, x2, ils, amp, g = gram_inputs(n1, n2, d, r, cuda, far)
    K.reset_launch_counts()
    k_k = K.matern52_gram_fwd(x1, x2, ils, amp)
    di_k, da_k = K.matern52_gram_bwd_theta(x1, x2, ils, amp, g)
    di_2, da_2 = K.matern52_gram_bwd_theta(x1, x2, ils, amp, g)
    torch.cuda.synchronize()
    assert K.launch_counts()["matern52_gram_fwd"] == 1
    assert K.launch_counts()["matern52_gram_bwd_theta"] == 2
    assert_gram_close(x1, x2, ils, amp, g, far, k_k, di_k, da_k)
    # fixed-order sums, no atomics: bitwise the same run to run
    assert torch.equal(di_k, di_2) and torch.equal(da_k, da_2)
    if n1 == n2:                       # K3 at x1 = x2: d² = 0 exactly
        assert torch.equal(torch.diagonal(k_k, dim1=-2, dim2=-1),
                           amp[:, None].expand(r, n1))


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,far", [(32, 5, 0), (77, 3, 9), (544, 20, 32),
                                     (1000, 40, 0)])
def test_gram_symmetric_path_bitwise_on_card(cuda, n, d, far):
    """x1 is x2 (the fit's call: the tiles I ≤ J only, each pair once)
    against x2 = x1.clone() (every tile): K3 gives the same bits, is
    bitwise symmetric with σ_f² exactly on its diagonal, and its n1 = 1
    column k(x_i, X) is bitwise row i; each θ row of K3 and K4 has the
    same bits at R = 1 as at R = 2, on both paths; K4 repeats its bits run
    to run; both paths are within tolerance of the plain versions."""
    x, _, ils, amp, g = gram_inputs(n, n, d, 2, cuda, far)
    xc = x.clone()
    assert K.same_points(x, x) and not K.same_points(x, xc)
    assert K.gram_plan(2, n, n, d, True).tiles < K.gram_plan(
        2, n, n, d, False).tiles or n <= 32
    K.reset_launch_counts()
    k_s = K.matern52_gram_fwd(x, x, ils, amp)
    k_c = K.matern52_gram_fwd(x, xc, ils, amp)
    bwd = {path: [K.matern52_gram_bwd_theta(x, x2, ils, amp, g)
                  for _ in range(2)] for path, x2 in (("same", x), ("copy", xc))}
    rows = {path: [(K.matern52_gram_fwd(x, x2, ils[i:i + 1].contiguous(),
                                        amp[i:i + 1].contiguous()),
                    K.matern52_gram_bwd_theta(x, x2, ils[i:i + 1].contiguous(),
                                              amp[i:i + 1].contiguous(),
                                              g[i:i + 1].contiguous()))
                   for i in range(2)] for path, x2 in (("same", x), ("copy", xc))}
    cols = {i: K.matern52_gram_fwd(x[i:i + 1], x, ils, amp)
            for i in (0, n // 2, n - 1)}
    torch.cuda.synchronize()
    assert K.launch_counts()["matern52_gram_fwd"] == 2 + 4 + 3
    assert K.launch_counts()["matern52_gram_bwd_theta"] == 4 + 4
    assert torch.equal(k_s, k_c)
    assert torch.equal(k_s, k_s.transpose(1, 2))
    assert torch.equal(torch.diagonal(k_s, dim1=-2, dim2=-1),
                       amp[:, None].expand(2, n))
    for i, col in cols.items():
        assert torch.equal(col[:, 0], k_s[:, i])
    for path, k in (("same", k_s), ("copy", k_c)):
        (di, da), (di2, da2) = bwd[path]
        assert torch.equal(di, di2) and torch.equal(da, da2)
        for i, (k1, (di1, da1)) in enumerate(rows[path]):
            assert torch.equal(k1[0], k[i])
            assert torch.equal(di1[0], di[i]) and torch.equal(da1[0], da[i])
        assert_gram_close(x, x, ils, amp, g, far, k, di, da)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [300, 1000])
@pytest.mark.parametrize("n1,n2", [(33, 33), (544, 544), (1, 544), (70, 45)])
def test_gram_kernels_take_any_d_on_card(cuda, n1, n2, d):
    """K3 and K4 stage D in pieces of 64 coordinates: D = 300 and 1000
    within the stated tolerances, the diagonal σ_f² exactly, K4 bitwise
    run to run."""
    far = 8 if n2 >= 544 else 0
    x1, x2, ils, amp, g = gram_inputs(n1, n2, d, 2, cuda, far)
    assert K.gram_plan(2, n1, n2, d, n1 == n2).pieces == -(-d // 64)
    k_k = K.matern52_gram_fwd(x1, x2, ils, amp)
    di_k, da_k = K.matern52_gram_bwd_theta(x1, x2, ils, amp, g)
    di_2, da_2 = K.matern52_gram_bwd_theta(x1, x2, ils, amp, g)
    torch.cuda.synchronize()
    assert_gram_close(x1, x2, ils, amp, g, far, k_k, di_k, da_k)
    assert torch.equal(di_k, di_2) and torch.equal(da_k, da_2)
    if n1 == n2:
        assert torch.equal(torch.diagonal(k_k, dim1=-2, dim2=-1),
                           amp[:, None].expand(2, n1))


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


def study_posterior_inputs(S, n, d, q, device):
    """S studies' K1/K2 inputs stacked: study s pads its n rows with
    3 + 7s _FAR pseudo-points (a different live count each), its own
    1/ℓ and σ_f², and q queries, the second on a training point."""
    gps = [state(n, d, seed=10 * s + n, device=device,
                 n_pad=min(3 + 7 * s, n - 2)) for s in range(S)]
    xt = torch.stack([gp.x_train for gp in gps])
    alpha = torch.stack([gp.alpha for gp in gps])
    kinv = torch.stack([gp.kinv for gp in gps])
    ils = torch.stack([torch.exp(-gp.params.log_lengthscale) * (1 + 0.1 * s)
                       for s, gp in enumerate(gps)])
    amp = torch.stack([gp.params.amplitude * (1 + 0.05 * s)
                       for s, gp in enumerate(gps)])
    xq = torch.tensor(np.random.default_rng(S + n).uniform(0, 1, (S, q, d)),
                      device=device)
    xq[:, 1] = xt[:, 0]
    return xq, xt, alpha, kinv, ils, amp


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 3, 8])
@pytest.mark.parametrize("n,d", [(33, 5), (544, 20)])
def test_posterior_study_axis_bitwise_solo_on_card(cuda, S, n, d):
    """K1 and K2 with a leading study axis: one launch each for the S
    studies, each study's slice bitwise its solo call, and within the
    stated tolerances of the plain versions."""
    xq, xt, alpha, kinv, ils, amp = study_posterior_inputs(S, n, d, 10, cuda)
    K.reset_launch_counts()
    m, v, t = K.matern52_posterior_fwd(xq, xt, alpha, kinv, ils, amp)
    gm, gv = torch.ones_like(m), -0.5 * torch.ones_like(m)
    g = K.matern52_posterior_bwd_xq(xq, xt, alpha, t, v, ils, amp, gm, gv)
    torch.cuda.synchronize()
    assert K.launch_counts()["matern52_posterior_fwd"] == 1
    assert K.launch_counts()["matern52_posterior_bwd_xq"] == 1
    assert m.shape == v.shape == (S, 10) and t.shape == (S, 10, n)
    m_r, v_r, t_r = matern52_posterior_fwd_ref(xq, xt, alpha, kinv, ils, amp)
    g_r = matern52_posterior_bwd_ref(xq, xt, alpha, t_r, v_r, ils, amp,
                                     gm, gv)
    for s in range(S):
        one = (xt[s], alpha[s], kinv[s], ils[s], amp[s])
        m1, v1, t1 = K.matern52_posterior_fwd(xq[s], *one)
        g1 = K.matern52_posterior_bwd_xq(xq[s], xt[s], alpha[s], t1, v1,
                                         ils[s], amp[s], gm[s], gv[s])
        for a, b in ((m1, m[s]), (v1, v[s]), (t1, t[s]), (g1, g[s])):
            assert torch.equal(a, b)
        a_s, kmax = float(amp[s]), float(kinv[s].abs().max())
        torch.testing.assert_close(m[s], m_r[s], rtol=1e-11, atol=1e-11)
        torch.testing.assert_close(t[s], t_r[s], rtol=1e-11, atol=1e-11)
        torch.testing.assert_close(v[s], v_r[s], rtol=0,
                                   atol=8 * n * EPS64 * a_s * a_s * kmax)
        torch.testing.assert_close(g[s], g_r[s], rtol=1e-10, atol=1e-10)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 3, 8])
@pytest.mark.parametrize("n,d", [(33, 5), (544, 20)])
def test_gram_study_axis_bitwise_solo_on_card(cuda, S, n, d):
    """K3 and K4 with a leading study axis, x (S, n, D) and θ rows
    (S, 2, D): one launch each for the S·2 rows; the symmetric path
    (x1 is x2), the cross path and the n1 = 1 column each give every
    study's slice bitwise its solo call, within the plain versions'
    tolerances; study s has 2 + 5s _FAR rows."""
    ins = [gram_inputs(n, n, d, 2, cuda, far=min(2 + 5 * s, n - 2), seed=s)
           for s in range(S)]
    x = torch.stack([i[0] for i in ins])
    ils = torch.stack([i[2] for i in ins])
    amp = torch.stack([i[3] for i in ins])
    g = torch.stack([i[4] for i in ins])
    xc, col = x.clone(), x[:, 3:4].contiguous()
    K.reset_launch_counts()
    k = K.matern52_gram_fwd(x, x, ils, amp)
    di, da = K.matern52_gram_bwd_theta(x, x, ils, amp, g)
    torch.cuda.synchronize()
    assert K.launch_counts()["matern52_gram_fwd"] == 1
    assert K.launch_counts()["matern52_gram_bwd_theta"] == 1
    assert k.shape == (S, 2, n, n) and di.shape == (S, 2, d)
    kc = K.matern52_gram_fwd(xc, x, ils, amp)
    dic, dac = K.matern52_gram_bwd_theta(xc, x, ils, amp, g)
    kcol = K.matern52_gram_fwd(col, x, ils, amp)
    assert torch.equal(kc, k) and torch.equal(kcol[:, :, 0], k[:, :, 3])
    for s in range(S):
        k1 = K.matern52_gram_fwd(x[s], x[s], ils[s], amp[s])
        d1, a1 = K.matern52_gram_bwd_theta(x[s], x[s], ils[s], amp[s], g[s])
        dc1, ac1 = K.matern52_gram_bwd_theta(xc[s], x[s], ils[s], amp[s],
                                             g[s])
        assert torch.equal(k1, k[s]) and torch.equal(d1, di[s])
        assert torch.equal(a1, da[s])
        assert torch.equal(dc1, dic[s]) and torch.equal(ac1, dac[s])
        far = min(2 + 5 * s, n - 2)
        assert_gram_close(x[s], x[s], ils[s], amp[s], g[s], far, k[s],
                          di[s], da[s])


@pytest.mark.cuda
def test_fleet_launches_and_bits_on_card(cuda):
    """On the card a fleet MSO round is one K1 and one K2 launch for all
    the studies of a block, a fit evaluation one K3 and one K4; solo ==
    company and slot permutation bitwise at a pinned width; within 1e-10
    of the solo fused sampler."""
    from repro_torch.bo.sampler import FleetSampler
    space = BoxSpace.cube(3, -1.0, 1.0)
    kw = dict(n_startup_trials=5, n_restarts=6, pad_multiple=8,
              mso_options=MsoOptions(maxiter=40, pgtol=1e-2),
              refit_interval=2)

    def drive(fs, rounds):
        out = []
        for _ in range(rounds):
            before = K.launch_counts()
            snap0 = fs.fleet.stats_snapshot()
            trials = fs.ask_all()
            after, snap = K.launch_counts(), fs.fleet.stats_snapshot()
            delta = {k: after[k] - before[k] for k in after}
            progs = {k: snap["n_block_programs"][k]
                     - snap0["n_block_programs"][k] for k in ("full", "incr")}
            rounds_ = snap["n_mso_rounds"] - snap0["n_mso_rounds"]
            evals = snap["n_fit_evals"] - snap0["n_fit_evals"]
            assert delta["matern52_posterior_fwd"] == rounds_
            assert delta["matern52_posterior_bwd_xq"] == rounds_
            assert delta["matern52_gram_bwd_theta"] == evals
            assert delta["matern52_gram_fwd"] == (evals + progs["full"]
                                                  + progs["incr"])
            out.append(np.array([t.x for t in trials]))
            for i, t in enumerate(trials):
                fs.tell(i, t.trial_id, _sphere(t.x))
        return np.array(out)

    company = drive(FleetSampler(space, n_studies=3, seed=4, slots=4, **kw),
                    10)
    solo = drive(FleetSampler(space, n_studies=1, seed=4, slots=4, **kw), 10)
    np.testing.assert_array_equal(solo[:, 0], company[:, 0])
    # against the solo pipeline in the cold-refit regime, as the
    # reference states it (warm starts carry last-ulp differences on)
    kw.update(refit_interval=1, warm_start=False)
    fleet = drive(FleetSampler(space, n_studies=3, seed=4, slots=4, **kw), 8)
    ref = GPSampler(space, strategy="dbe_vec", seed=4, **kw)
    xs = []
    for _ in range(8):
        tr = ref.ask()
        ref.tell(tr.trial_id, _sphere(tr.x))
        xs.append(tr.x)
    np.testing.assert_allclose(space.to_unit(fleet[:, 0]),
                               space.to_unit(np.array(xs)), rtol=0,
                               atol=1e-10)


@pytest.mark.cuda
def test_stacked_map_objective_bitwise_each_study_on_card(cuda):
    """One MAP-objective evaluation of an 8-study stack at the fleet's
    width (D=20, n=536 in the 544 bucket, R=2): value and θ-gradient of
    each study bitwise the study alone (the Cholesky, solves and sums run
    study by study; K3/K4 take the stack in one launch)."""
    from repro_torch.gp.fit import (_FAR, _neg_map_objective,
                                    standardize_masked, theta_init_grid)
    S, D, n, b = 8, 20, 536, 544
    rng = np.random.default_rng(3)
    x = np.full((S, b, D), _FAR) + np.arange(b)[None, :, None]
    x[:, :n] = rng.uniform(0, 1, (S, n, D))
    y = np.zeros((S, b))
    y[:, :n] = np.sin(5 * x[:, :n]).sum(-1)
    x, y = torch.tensor(x, device=cuda), torch.tensor(y, device=cuda)
    valid = torch.arange(b, device=cuda) < n
    valid = valid.expand(S, b)
    ys = standardize_masked(y, valid)[0]
    th = torch.stack([theta_init_grid(D, torch.float64, 2, s)
                      for s in range(S)]).to(cuda)

    def objective(t, *args):
        t = t.detach().requires_grad_(True)
        f = _neg_map_objective(t, *args, D, "matern52")
        (g,) = torch.autograd.grad(f.sum(), t)
        return f.detach(), g

    f_all, g_all = objective(th, x, ys, valid)
    for s in range(S):
        f1, g1 = objective(th[s], x[s], ys[s], valid[s])
        assert torch.equal(f_all[s], f1), s
        assert torch.equal(g_all[s], g1), s


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


# ------------------------------------------- slice 3: K6 flash, K5 kvp, serve
from repro_torch.kernels.flash import kernel as FK  # noqa: E402
from repro_torch.kernels.flash.ref import (flash_attention_bwd_ref,  # noqa: E402,E501
                                           flash_attention_fwd_ref,
                                           position_mask)
from repro_torch.kernels.kvp import kernel as VK  # noqa: E402
from repro_torch.kernels.kvp.ref import kvp_ref  # noqa: E402


def serving_inputs(b, sk, nh, kh, hd, dtype, device, seed=0):
    """A decode step's attention inputs as the serving engine leaves them:
    ragged per-row positions, empty slots (−1), the trash slot Sk−1 (−1),
    and an idle last row (query position −1)."""
    rng = np.random.default_rng(seed)
    kv_pos = np.full((b, sk), -1, np.int32)
    q_pos = np.full((b, 1), -1, np.int32)
    for r in range(b - 1):
        n = int(rng.integers(1, sk - 1))
        kv_pos[r, :n] = np.arange(n)
        q_pos[r, 0] = n - 1
    g = torch.Generator(device=device).manual_seed(seed)
    q, k, v = (torch.randn(sh, generator=g, device=device).to(dtype)
               for sh in ((b, 1, nh, hd), (b, sk, kh, hd), (b, sk, kh, hd)))
    return (q, k, v, torch.tensor(q_pos, device=device),
            torch.tensor(kv_pos, device=device))


def assert_flash_close(out, ref):
    """K6 and its plain version both sum in float32 and round the output
    once: within 2e-5 in float32; in bfloat16 the two roundings may also
    land on neighbouring values, one ulp (at most 2⁻⁷·|ref|) apart."""
    tol = 2e-5 + (2.0 ** -7 * ref.float().abs()
                  if ref.dtype == torch.bfloat16 else 0.0)
    assert bool(((out.float() - ref.float()).abs() <= tol).all())


@pytest.mark.cuda
@pytest.mark.parametrize("b,sk,nh,kh,hd,dtype", [
    (4, 300, 6, 2, 32, torch.float32), (8, 512, 24, 8, 128, torch.bfloat16),
    (3, 97, 4, 4, 64, torch.float32), (2, 64, 8, 1, 128, torch.bfloat16)])
def test_flash_kernel_matches_plain_version_on_card(cuda, b, sk, nh, kh, hd,
                                                    dtype):
    inputs = serving_inputs(b, sk, nh, kh, hd, dtype, cuda, seed=sk)
    FK.reset_launch_counts()
    out = FK.flash_attention_fwd(*inputs)
    ref = flash_attention_fwd_ref(*inputs)
    alone = FK.flash_attention_fwd(*(t[:1].contiguous() for t in inputs))
    torch.cuda.synchronize()
    assert FK.launch_counts() == {**dict.fromkeys(FK.LAUNCHES, 0),
                                  "flash_attention_fwd": 2}
    seen = position_mask(inputs[3], inputs[4], True, None).any(-1)
    assert_flash_close(out[seen], ref[seen])
    assert not out[~seen].any()                       # no visible key → 0
    assert torch.equal(alone[0], out[0])              # row independence


def assert_flash_matches_plain(inputs, causal=True, window=None):
    """K6 against its plain version on ``inputs``: rows that see a key
    within the limit, rows that see none exactly 0, row 0 alone bitwise."""
    out = FK.flash_attention_fwd(*inputs, causal=causal, window=window)
    ref = flash_attention_fwd_ref(*inputs, causal=causal, window=window)
    alone = FK.flash_attention_fwd(*(t[:1].contiguous() for t in inputs),
                                   causal=causal, window=window)
    torch.cuda.synchronize()
    seen = position_mask(inputs[3], inputs[4], causal, window).any(-1)
    assert_flash_close(out[seen], ref[seen])
    assert not out[~seen].any()
    assert torch.equal(alone[0], out[0])


@pytest.mark.cuda
@pytest.mark.parametrize("sk", [513, 4095])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_cache_not_a_multiple_of_the_split(cuda, sk, dtype):
    """The last split of each (row, KV head) holds fewer keys than the
    others."""
    inputs = serving_inputs(8, sk, 24, 8, 128, dtype, cuda, seed=sk)
    assert FK.n_splits(sk, FK.plan_of(inputs[0], inputs[1])[1]) > 1
    assert_flash_matches_plain(inputs)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [None, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_split_edges_on_card(cuda, window, dtype):
    """Row 0 sees keys of one split only (slots 70..110 of 512, splits of
    64), row 1 of the first split only, row 2 (a live query) no key in
    any split, row 3's keys end mid-split; the merge takes them all."""
    q, k, v, q_pos, kv_pos = serving_inputs(6, 512, 6, 2, 64, dtype, cuda,
                                            seed=21)
    kv_pos[:4] = -1
    kv_pos[0, 70:111] = torch.arange(41, dtype=torch.int32)
    kv_pos[1, :31] = torch.arange(31, dtype=torch.int32)
    kv_pos[3, :300] = torch.arange(300, dtype=torch.int32)
    q_pos[:4, 0] = torch.tensor([40, 30, 100, 299], dtype=torch.int32)
    assert FK.plan_of(q, k) == ("split", 64)
    assert_flash_matches_plain((q, k, v, q_pos, kv_pos), window=window)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("sq,nh,kh", [(63, 2, 2), (64, 2, 2), (65, 2, 2),
                                      (21, 6, 2), (22, 6, 2)])
def test_flash_rows_around_the_mma_threshold(cuda, hd, sq, nh, kh):
    """bf16 chunks of Sq·G = 63 / 64 / 65 rows (G=1) and 63 / 66 (G=3)
    continuing a cache of 40 positions: split path below 64 rows, the
    MMA path from 64 on, both within the limit."""
    g = torch.Generator(device=cuda).manual_seed(sq * hd + nh)
    sk = 40 + sq
    q, k, v = (torch.randn(sh, generator=g, device=cuda).to(torch.bfloat16)
               for sh in ((2, sq, nh, hd), (2, sk, kh, hd), (2, sk, kh, hd)))
    q_pos = (40 + torch.arange(sq, dtype=torch.int32, device=cuda)).expand(
        2, sq).contiguous()
    kv_pos = torch.arange(sk, dtype=torch.int32, device=cuda).expand(
        2, sk).contiguous()
    assert FK.plan_of(q, k)[0] == ("mma" if sq * nh // kh >= 64 else "split")
    assert_flash_matches_plain((q, k, v, q_pos, kv_pos))
    assert_flash_matches_plain((q, k, v, q_pos, kv_pos), window=24)


@pytest.mark.cuda
@pytest.mark.parametrize("s,dtype", [(512, torch.float32),
                                     (2048, torch.float32),
                                     (1024, torch.bfloat16),
                                     (2048, torch.bfloat16)])
def test_causal_prefill_flash_matches_plain_on_card(cuda, s, dtype):
    """Many rows a block, the causal tile skip and hd=128 at llama's 24
    heads; bf16 through the MMA path, f32 through one split of the whole
    cache (two spans of positions at S=2048)."""
    g = torch.Generator(device=cuda).manual_seed(s)
    q, k, v = (torch.randn((1, 24, s, 128), generator=g, device=cuda).to(
        dtype) for _ in range(3))
    out = FK.flash_attention_bhsd(q, k, v, causal=True)
    pos = torch.arange(s, dtype=torch.int32, device=cuda)[None]
    ref = flash_attention_fwd_ref(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), pos, pos).transpose(1, 2)
    assert_flash_close(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("sq,sk,h,causal,window", [
    (256, 256, 64, True, None), (128, 384, 64, True, None),
    (300, 300, 32, True, 128), (1, 513, 64, True, None),
    (200, 200, 128, False, None), (256, 256, 64, True, 0)])
def test_single_head_flash_matches_plain_on_card(cuda, sq, sk, h, causal,
                                                 window):
    g = torch.Generator(device=cuda).manual_seed(sq + sk)
    q, k, v = (torch.randn((s, h), generator=g, device=cuda)
               for s in (sq, sk, sk))
    out = FK.flash_attention(q, k, v, causal=causal, window=window)
    qp = torch.arange(sk - sq, sk, dtype=torch.int32, device=cuda)[None]
    kp = torch.arange(sk, dtype=torch.int32, device=cuda)[None]
    ref = flash_attention_fwd_ref(q[None, :, None], k[None, :, None],
                                  v[None, :, None], qp, kp, causal=causal,
                                  window=window)[0, :, 0]
    torch.testing.assert_close(out, ref, rtol=2e-5, atol=2e-5)
    if window is not None and window <= 0 and causal:
        assert not out.any()          # the Pallas rule: every key masked
    bh = FK.flash_attention_bhsd(q[None, None], k[None, None], v[None, None],
                                 causal=causal, window=window)
    assert torch.equal(bh[0, 0], out)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [2048, 300])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_head_dim_256_decode_on_card(cuda, window, dtype):
    """recurrentgemma-9b's local attention at a decode step: B=8, NH=16,
    KH=1 (MQA), hd=256, Sk=2048, its window 2048 and a window of 300
    that cuts the longer rows; the split path at hd 256."""
    inputs = serving_inputs(8, 2048, 16, 1, 256, dtype, cuda, seed=256)
    assert FK.plan_of(inputs[0], inputs[1])[0] == "split"
    assert_flash_matches_plain(inputs, window=window)


@pytest.mark.cuda
def test_flash_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    q, k, v, qp, kp = serving_inputs(2, 64, 4, 2, 32, torch.float32, cuda)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        FK.flash_attention_fwd(q.double(), k.double(), v.double(), qp, kp)
    with pytest.raises(TypeError, match="int32"):
        FK.flash_attention_fwd(q, k, v, qp.long(), kp)
    with pytest.raises(ValueError, match="head_dim"):
        FK.flash_attention_fwd(q[..., :16].contiguous(),
                               k[..., :16].contiguous(),
                               v[..., :16].contiguous(), qp, kp)
    with pytest.raises(ValueError, match="contiguous"):
        FK.flash_attention_fwd(q, k.transpose(0, 1).contiguous().transpose(
            0, 1), v, qp, kp)
    with pytest.raises(ValueError, match="shape"):
        FK.flash_attention_fwd(q, k, v[:, :-1].contiguous(), qp, kp)
    with pytest.raises(NotImplementedError, match="A12"):
        FK.attention(q.clone().requires_grad_(True), k, v, qp,
                     kp).sum().backward()


@pytest.mark.cuda
@pytest.mark.parametrize("q,n,d", [(10, 50, 5), (77, 500, 40), (10, 544, 20),
                                   (1000, 2048, 20)])
def test_kvp_kernel_matches_plain_version_on_card(cuda, q, n, d):
    rng = np.random.default_rng(q + n)
    xq, xt = rng.uniform(0, 1, (q, d)), rng.uniform(0, 1, (n, d))
    al = rng.standard_normal(n)
    xt[-3:] = 1e6 + np.arange(3)[:, None]              # _FAR rows
    al[-3:] = 0.0
    ils = np.exp(rng.uniform(-1.0, 2.0, d))
    args = tuple(torch.tensor(a, device=cuda)
                 for a in (xq, xt, al, ils, np.float64(1.7)))
    VK.reset_launch_counts()
    out = VK.kvp_fwd(*args)
    alone = VK.kvp_fwd(args[0][:1].contiguous(), *args[1:])
    ref = kvp_ref(*args)
    torch.cuda.synchronize()
    assert VK.launch_counts() == {"kvp_fwd": 2}
    scale = matern52_gram_ref(args[0], args[1], args[3], args[4]).abs() \
        @ args[2].abs()
    assert bool(((out - ref).abs() <= 1e-12 * scale).all())
    assert torch.equal(alone[0], out[0])
    from repro_torch.kernels.kvp.ops import gp_mean_kvp
    assert torch.equal(gp_mean_kvp(*args, backend="auto"), out)
    with pytest.raises(TypeError, match="float64"):
        VK.kvp_fwd(args[0].float(), *args[1:])
    with pytest.raises(ValueError, match="shape"):
        VK.kvp_fwd(args[0], args[1], args[2][:-1], *args[3:])


def kvp_args(q, n, d, device, far=32):
    """K5's inputs with _FAR rows at the end; past D = 40 the lengthscales
    grow with √D, as a fitted GP's do, so that k is not 0 almost
    everywhere."""
    rng = np.random.default_rng(q + n + d)
    xq, xt = rng.uniform(0, 1, (q, d)), rng.uniform(0, 1, (n, d))
    al = rng.standard_normal(n)
    xt[-far:] = 1e6 + np.arange(far)[:, None]
    al[-far:] = 0.0
    ils = np.exp(rng.uniform(-1.0, 2.0, d)) * min(1.0, math.sqrt(20 / d))
    return tuple(torch.tensor(a, device=device)
                 for a in (xq, xt, al, ils, np.float64(1.7)))


@pytest.mark.cuda
@pytest.mark.parametrize("q,n,d", [(10, 544, 20), (1000, 2048, 20),
                                   (10, 544, 300), (17, 2048, 300),
                                   (10, 544, 1000), (40, 544, 1000)])
def test_kvp_mean_is_k1_mean_bitwise_on_card(cuda, q, n, d):
    """K5 sums K1's products in K1's order (64-column tile trees, then the
    tiles in order), each entry by the shared Matérn entry: its mean is
    bitwise K1's, in either of K1's regimes (split at q ≤ 16, walk at
    q = 1000, n = 2048) and either of K5's geometries (8 or 32 queries a
    block), at D = 20, 300 and 1000, and within 1e-12 of Σ|terms| of the
    plain version."""
    args = kvp_args(q, n, d, cuda)
    xq, xt, al, ils, amp = args
    VK.reset_launch_counts()
    out = VK.kvp_fwd(*args)
    eye = torch.eye(n, dtype=torch.float64, device=cuda)
    k1 = K.matern52_posterior_fwd(xq, xt, al, eye, ils, amp)[0]
    ref = kvp_ref(*args)
    torch.cuda.synchronize()
    assert VK.launch_counts() == {"kvp_fwd": 1}
    assert torch.equal(out, k1)
    scale = matern52_gram_ref(xq, xt, ils, amp).abs() @ al.abs()
    assert bool(((out - ref).abs() <= 1e-12 * scale).all())
    assert float(ref.abs().max()) > 1e-3             # k is not 0 everywhere


@pytest.mark.cuda
@pytest.mark.parametrize("n,d", [(544, 20), (2048, 20), (544, 300)])
def test_kvp_rows_bitwise_at_any_q_on_card(cuda, n, d):
    """The first q rows of a batch of 1000 alone, at q = 1, 10, 17 and
    1000 (K5's blocks take 8 queries up to q = 16, 32 past it): the same
    bits, and a second call repeats every bit."""
    args = kvp_args(1000, n, d, cuda)
    full = VK.kvp_fwd(*args)
    geometries = set()
    for q in (1, 10, 17, 1000):
        geometries.add(VK.kvp_plan(q, n, d).rows)
        out = VK.kvp_fwd(args[0][:q].contiguous(), *args[1:])
        assert torch.equal(out, full[:q])
    assert geometries == {VK.FEW, VK.MANY}
    assert torch.equal(VK.kvp_fwd(*args), full)


def to_device(node, dev):
    """A parameter tree (dicts and lists of tensors) on ``dev``."""
    if isinstance(node, dict):
        return {k: to_device(v, dev) for k, v in node.items()}
    if isinstance(node, list):
        return [to_device(v, dev) for v in node]
    return node.to(dev)


@pytest.mark.cuda
def test_reduced_serve_engine_on_card(cuda):
    """The reduced llama3.2-3b served on the card in f32: one K6 launch per
    layer per step, one program, and the same greedy tokens as on the
    CPU."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.serve.engine import Request, ServeEngine
    cfg = get_config("llama3.2-3b").reduced().replace(dtype="float32")
    cpu = lm.init_params(cfg, torch.Generator().manual_seed(0))
    outs = {}
    for name, params in (("cpu", cpu), ("cuda", to_device(cpu, cuda))):
        eng = ServeEngine(params, cfg, slots=3, max_len=64)
        rng = np.random.default_rng(0)
        for i in range(7):
            eng.submit(Request(uid=i, prompt=rng.integers(
                0, cfg.vocab_size, 4 + (i % 3)).astype(np.int32),
                max_new_tokens=5))
        FK.reset_launch_counts()
        outs[name] = {r.uid: r.out_tokens for r in eng.run_until_drained()}
        want = cfg.n_layers * eng.stats["steps"] if name == "cuda" else 0
        assert FK.launch_counts()["flash_attention_fwd"] == want
        assert eng.stats["flash_launches"] == want
        assert eng.stats["compiles"] == 1
    assert outs["cuda"] == outs["cpu"]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "dbrx-132b",
                                  "chameleon-34b", "recurrentgemma-9b"])
def test_reduced_families_on_card(cuda, arch):
    """The reduced moe (published capacity factor: pairs drop), vlm and
    hybrid configs in f32 on the card against the CPU: forward logits
    within 1e-5 of max|logit|, and a ServeEngine's greedy tokens equal,
    with one K6 launch per attention layer per step.  Hybrid at max_len
    96 > its window of 64, so the ring wraps."""
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    from repro_torch.models import lm
    from repro_torch.serve.engine import Request, ServeEngine
    cfg = get_config(arch).reduced().replace(dtype="float32")
    cpu = lm.init_params(cfg, torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (2, 48),
                         generator=torch.Generator().manual_seed(7))
    logits, outs = {}, {}
    for name, params in (("cpu", cpu), ("cuda", to_device(cpu, cuda))):
        dev = "cpu" if name == "cpu" else cuda
        with torch.no_grad():
            hid, _ = lm.forward(params, cfg, toks.to(dev))
            logits[name] = L.lm_logits(params["embed"], cfg, hid).cpu()
        eng = ServeEngine(params, cfg, slots=3, max_len=96)
        rng = np.random.default_rng(0)
        for i in range(7):
            eng.submit(Request(uid=i, prompt=rng.integers(
                0, cfg.vocab_size, 40 + 7 * i).astype(np.int32),
                max_new_tokens=40))
        FK.reset_launch_counts()
        outs[name] = {r.uid: r.out_tokens for r in eng.run_until_drained()}
        want = lm.attention_layers(cfg) * eng.stats["steps"] \
            if name == "cuda" else 0
        assert FK.launch_counts()["flash_attention_fwd"] == want
        assert eng.stats["flash_launches"] == want
        assert eng.stats["compiles"] == 1
    ref = logits["cpu"]
    assert float((logits["cuda"] - ref).abs().max() / ref.abs().max()) \
        <= 1e-5
    assert outs["cuda"] == outs["cpu"]


@pytest.mark.cuda
def test_reduced_ssm_on_card(cuda):
    """The reduced xlstm-1.3b in f32 on the card against the CPU: forward
    logits over 64 tokens (two mLSTM chunks of 32) within 1e-5 of
    max|logit|, and a ServeEngine's greedy tokens equal, with no K6
    launch (the ssm family has no attention)."""
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    from repro_torch.models import lm
    from repro_torch.serve.engine import Request, ServeEngine
    cfg = get_config("xlstm-1.3b").reduced().replace(dtype="float32")
    cpu = lm.init_params(cfg, torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (2, 64),
                         generator=torch.Generator().manual_seed(7))
    logits, outs = {}, {}
    for name, params in (("cpu", cpu), ("cuda", to_device(cpu, cuda))):
        dev = "cpu" if name == "cpu" else cuda
        with torch.no_grad():
            hid, _ = lm.forward(params, cfg, toks.to(dev))
            logits[name] = L.lm_logits(params["embed"], cfg, hid).cpu()
        eng = ServeEngine(params, cfg, slots=3, max_len=64)
        rng = np.random.default_rng(0)
        for i in range(7):
            eng.submit(Request(uid=i, prompt=rng.integers(
                0, cfg.vocab_size, 4 + 3 * i).astype(np.int32),
                max_new_tokens=8))
        FK.reset_launch_counts()
        outs[name] = {r.uid: r.out_tokens for r in eng.run_until_drained()}
        assert FK.launch_counts()["flash_attention_fwd"] == 0
        assert eng.stats["flash_launches"] == 0
        assert eng.stats["compiles"] == 1
    ref = logits["cpu"]
    assert float((logits["cuda"] - ref).abs().max() / ref.abs().max()) \
        <= 1e-5
    assert outs["cuda"] == outs["cpu"]


@pytest.mark.cuda
def test_reduced_whisper_on_card(cuda):
    """The reduced whisper-base in f32 on the card against the CPU:
    encode, decode_train and 16 decode_step logits within 1e-5 of
    max|out|, with K6 launched once per encoder layer and twice per
    decoder layer (self, then cross-attention without the causal mask)."""
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    from repro_torch.models import whisper as WH
    cfg = get_config("whisper-base").reduced().replace(dtype="float32")
    cpu = WH.init_params(cfg, torch.Generator().manual_seed(0))
    frames = torch.randn((2, 100, cfg.d_model),
                         generator=torch.Generator().manual_seed(1))
    toks = torch.randint(0, cfg.vocab_size, (2, 16),
                         generator=torch.Generator().manual_seed(7))
    out = {}
    for name, params in (("cpu", cpu), ("cuda", to_device(cpu, cuda))):
        dev = "cpu" if name == "cpu" else cuda
        FK.reset_launch_counts()
        with torch.no_grad():
            enc = WH.encode(params, cfg, frames.to(dev))
            hid = WH.decode_train(params, cfg, enc, toks.to(dev))
            train = L.lm_logits(params["embed"], cfg, hid)
            cache = WH.init_cache(params, cfg, enc, 2, 16, device=dev)
            steps = torch.stack([WH.decode_step(
                params, cfg, toks[:, i:i + 1].to(dev), cache, i)[0]
                for i in range(16)], 1)
        want = cfg.n_enc_layers + 2 * cfg.n_dec_layers * 17 \
            if name == "cuda" else 0
        assert FK.launch_counts()["flash_attention_fwd"] == want
        out[name] = [t.cpu() for t in (enc, train, steps)]
    for a, b in zip(out["cuda"], out["cpu"]):
        assert float((a - b).abs().max() / b.abs().max()) <= 1e-5


# --------------------------------------------------- slice 9: training
@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,sk,nh,kh,hd,dtype,causal,window,path", [
    (2, 128, 128, 6, 2, 128, "bfloat16", True, None, "mma"),   # MMA forward
    (2, 100, 100, 4, 2, 64, "float32", True, 32, "fma"),        # split, window
    (1, 64, 64, 8, 1, 256, "bfloat16", True, 16, "fma"),        # hd 256, G = 8
    (2, 16, 90, 4, 4, 64, "bfloat16", False, None, "mma"),      # Sq ≠ Sk
    # slice 10: K7's MMA path at ragged tiles, a window, G = 8 and with
    # nothing visible
    (2, 300, 300, 6, 2, 128, "bfloat16", True, None, "mma"),
    (1, 1500, 1500, 8, 8, 64, "bfloat16", False, None, "mma"),
    (2, 200, 200, 4, 2, 64, "bfloat16", True, 48, "mma"),
    (1, 128, 128, 8, 1, 128, "bfloat16", True, None, "mma"),
    (2, 96, 96, 4, 2, 64, "bfloat16", True, 0, "mma"),
])
def test_flash_backward_matches_plain_version_on_card(cuda, b, sq, sk, nh,
                                                      kh, hd, dtype, causal,
                                                      window, path):
    """K7 against its plain version on the same CUDA tensors (K6's output
    and log-sum-exp as inputs): within 1e-4 of each gradient's largest
    entry, plus one bf16 rounding; bitwise from run to run; exact zeros
    for rows and keys no pair sees; the path bwd_plan names; K6's output
    bits the same with and without lse; one launch of each."""
    g = torch.Generator(device=cuda).manual_seed(sq)
    dt = getattr(torch, dtype)
    q, k, v, do = (torch.randn(sh, generator=g, device=cuda).to(dt)
                   for sh in ((b, sq, nh, hd), (b, sk, kh, hd),
                              (b, sk, kh, hd), (b, sq, nh, hd)))
    kp = torch.arange(sk, dtype=torch.int32, device=cuda).expand(b, sk)
    qp = kp[:, sk - sq:] if causal else torch.zeros(
        (b, sq), dtype=torch.int32, device=cuda)
    kp, qp = kp.contiguous(), qp.contiguous()
    kw = dict(causal=causal, window=window)
    assert FK.bwd_plan_of(q, k) == path
    FK.reset_launch_counts()
    out, lse = FK.flash_attention_fwd(q, k, v, qp, kp, return_lse=True,
                                      **kw)
    grads = FK.flash_attention_bwd(q, k, v, out, lse, do, qp, kp, **kw)
    assert FK.launch_counts() == {**dict.fromkeys(FK.LAUNCHES, 0),
                                  "flash_attention_fwd": 1,
                                  "flash_attention_bwd": 1}
    again = FK.flash_attention_bwd(q, k, v, out, lse, do, qp, kp, **kw)
    assert torch.equal(out, FK.flash_attention_fwd(q, k, v, qp, kp, **kw))
    refs = flash_attention_bwd_ref(q, k, v, out, lse, do, qp, kp, **kw)
    for got, ref, rep in zip(grads, refs, again):
        assert torch.equal(got, rep)
        d = (got.float() - ref.float()).abs()
        lim = 1e-4 * ref.float().abs().max() + (
            2.0 ** -7 * ref.float().abs() if dt == torch.bfloat16 else 0.0)
        assert bool((d <= lim).all())
    seen = position_mask(qp, kp, causal, window)
    rows, keys = seen.any(-1), seen.any(1)
    assert not grads[0][~rows].any()
    assert not grads[1][~keys].any() and not grads[2][~keys].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,hd,path", [
    ("bfloat16", 64, "fma"), ("bfloat16", 128, "fma"),
    ("float32", 64, "mma"), ("bfloat16", 256, "mma")])
def test_flash_backward_entry_takes_only_bwd_plans_path(cuda, dtype, hd,
                                                        path):
    """K7's C entry has one path for each (dtype, hd), bwd_plan's: asked
    for the other, it returns cudaErrorInvalidValue (1) and launches
    nothing."""
    dt = getattr(torch, dtype)
    assert FK.bwd_plan(dt, 64, 2, 2, hd, 64) != path
    q, k, v, o, do, dq, dk, dv = (torch.zeros((1, 64, 2, hd), dtype=dt,
                                              device=cuda) for _ in range(8))
    lse, dsum = (torch.zeros((1, 2, 64), device=cuda) for _ in range(2))
    pos = torch.arange(64, dtype=torch.int32, device=cuda)[None]
    dq.fill_(7)
    err = FK._lib().flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), pos.data_ptr(), pos.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), dsum.data_ptr(), 1, 64,
        64, 2, 2, hd, 1 if dt == torch.bfloat16 else 0, 1, 0, 0, hd ** -0.5,
        {"fma": 0, "mma": 1}[path], torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 1
    assert bool((dq == 7).all())


@pytest.mark.cuda
def test_reduced_train_step_card_matches_cpu(cuda):
    """One train step of the reduced llama3.2-3b in f32 on the card
    against the CPU from the same parameters and batch: loss and grad norm
    within 1e-5, K7 = 4 launches (one per layer) and K6 = 8 (under the
    default full remat each layer's forward runs again in the
    backward)."""
    from repro_torch.configs import get_config
    from repro_torch.data.synth import DataConfig, synth_batch
    from repro_torch.models import lm
    from repro_torch.train.optim import (OptimConfig, init_opt_state,
                                         tree_map)
    from repro_torch.train.step import train_step
    cfg = get_config("llama3.2-3b").reduced().replace(dtype="float32")
    cpu = lm.init_params(cfg, torch.Generator().manual_seed(0), stacked=True)
    card = tree_map(lambda t: t.to(cuda, copy=True), cpu)
    nb = synth_batch(cfg, DataConfig(global_batch=2, seq_len=64, seed=1), 0)
    oc = OptimConfig(warmup_steps=1, total_steps=4)
    out = {}
    for name, p, d in (("cpu", cpu, "cpu"), ("cuda", card, cuda)):
        FK.reset_launch_counts()
        _, _, m = train_step(p, init_opt_state(p, oc),
                             {k: torch.from_numpy(v).to(d)
                              for k, v in nb.items()}, cfg=cfg, opt_cfg=oc)
        out[name] = (float(m["loss"]), float(m["grad_norm"]))
        want = 4 if name == "cuda" else 0
        assert FK.launch_counts() == {**dict.fromkeys(FK.LAUNCHES, 0),
                                      "flash_attention_fwd": 2 * want,
                                      "flash_attention_bwd": want}
    for a, b in zip(out["cuda"], out["cpu"]):
        assert abs(a - b) <= 1e-5 * abs(b)


@pytest.mark.cuda
@pytest.mark.parametrize("b,length,nh,kh,d,dtype,window", [
    (8, 2048, 16, 1, 128, torch.bfloat16, 2048),     # recurrentgemma on 2
    (3, 100, 6, 2, 8, torch.float32, None),          # ragged L, G = 3
    (2, 64, 12, 2, 64, torch.float32, 7),
    (2, 130, 4, 1, 256, torch.bfloat16, None),       # hd 256 on one rank
    (8, 2048, 16, 1, 64, torch.bfloat16, 2048),      # recurrentgemma on 4
    (8, 512, 32, 2, 32, torch.bfloat16, None),       # chatglm3-6b on 4
    (8, 512, 48, 4, 16, torch.bfloat16, None),       # starcoder2-15b on 8
    (8, 2048, 16, 1, 128, torch.float32, 2048),      # (c) on the FMA path
    (3, 100, 6, 2, 24, torch.bfloat16, None),        # bf16 on the FMA path
    (2, 2048, 16, 1, 64, torch.bfloat16, 7),         # most MMA tiles unseen
    (2, 4100, 8, 2, 64, torch.bfloat16, None)])      # K9 blocks of 3 rounds
def test_split_decode_kernels_match_plain_versions_on_card(
        cuda, b, length, nh, kh, d, dtype, window):
    """K8 and K9 against their plain versions on decode_plan's path (MMA
    for bf16 at d % 16 == 0): K8's float32 sums within 1e-5 of max |s|,
    K9 within the flash limit on live rows and 0 on the idle row, both
    bitwise from run to run, one launch each a call."""
    from repro_torch.kernels.flash.ref import (flash_decode_pv_ref,
                                               flash_decode_scores_ref)
    q, k, v, q_pos, kv_pos = serving_inputs(b, length, nh, kh, d, dtype,
                                            cuda, seed=length)
    assert FK.decode_plan(dtype, nh, kh, d) == (
        "mma" if dtype == torch.bfloat16 and d % 16 == 0 else "fma")
    FK.reset_launch_counts()
    s = FK.flash_decode_scores(q, k)
    kw = dict(causal=True, window=window, scale=(2 * d) ** -0.5)
    out = FK.flash_decode_pv(s, v, q_pos, kv_pos, **kw)
    torch.cuda.synchronize()
    assert FK.launch_counts() == {**dict.fromkeys(FK.LAUNCHES, 0),
                                  "flash_decode_scores": 1,
                                  "flash_decode_pv": 1}
    s_ref = flash_decode_scores_ref(q, k)
    assert (s - s_ref).abs().max() <= 1e-5 * s_ref.abs().max()
    ref = flash_decode_pv_ref(s, v, q_pos, kv_pos, **kw)
    seen = position_mask(q_pos, kv_pos, True, window).any(-1)
    assert_flash_close(out[seen], ref[seen])
    assert not out[~seen].any()
    assert torch.equal(s, FK.flash_decode_scores(q, k))
    assert torch.equal(out, FK.flash_decode_pv(s, v, q_pos, kv_pos, **kw))

"""K3's and K4's launch plan (``repro_torch.kernels.matern.kernel.gram_plan``),
the check that x1 and x2 are the same points, and the gram wrappers' CPU
paths.  The plan picks which tiles blocks compute (every tile, or the
upper triangle where x1 is x2) and K4's scratch; K4's summation units are
the tiles, fixed by (n1, n2) and that choice, never by R or D (the bits
are checked on a card by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``)."""
import inspect
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.matern import kernel as K  # noqa: E402
from repro_torch.kernels.matern.ops import matern52_gram_op  # noqa: E402
from repro_torch.kernels.matern.ref import (  # noqa: E402
    matern52_gram_bwd_theta_ref, matern52_gram_ref)

NS = [1, 31, 32, 33, 64, 65, 524, 544, 2048]


def test_gram_plan_reads_shapes_only():
    assert list(inspect.signature(K.gram_plan).parameters) == [
        "r", "n1", "n2", "d", "symmetric"]
    for bad in ((0, 5, 5, 3), (2, 0, 5, 3), (2, 5, 0, 3), (2, 5, 5, 0)):
        for sym in (False, True):
            with pytest.raises(ValueError, match="empty"):
                K.gram_plan(*bad, sym)
    with pytest.raises(ValueError, match="square"):
        K.gram_plan(2, 5, 6, 3, True)


@pytest.mark.parametrize("n", NS)
def test_upper_triangle_tiles_cover_each_unordered_pair_once(n):
    """The symmetric plan's tiles are the (I, J), I ≤ J, of the
    ceil(n / 32)² tile grid, each once, row-major: every unordered pair
    of tiles is computed by exactly one block."""
    p = K.gram_plan(1, n, n, 20, True)
    tn = math.ceil(n / K.GRAM_TILE)
    tiles = [K.gram_tile(t, n, n, True) for t in range(p.tiles)]
    assert p.tiles == tn * (tn + 1) // 2
    assert all(i <= j < tn for i, j in tiles)
    assert len(set(tiles)) == len(tiles)
    assert {frozenset(t) for t in tiles} == {
        frozenset((i, j)) for i in range(tn) for j in range(tn)}
    assert tiles == sorted(tiles)


@pytest.mark.parametrize("n1,n2", [(1, 544), (33, 70), (544, 544),
                                   (2048, 32)])
def test_cross_tiles_cover_every_tile_once(n1, n2):
    p = K.gram_plan(1, n1, n2, 5, False)
    t1, t2 = math.ceil(n1 / K.GRAM_TILE), math.ceil(n2 / K.GRAM_TILE)
    tiles = [K.gram_tile(t, n1, n2, False) for t in range(p.tiles)]
    assert tiles == [(i, j) for i in range(t1) for j in range(t2)]


@pytest.mark.parametrize("sym", [False, True])
@pytest.mark.parametrize("r", [1, 2, 7])
@pytest.mark.parametrize("n,d", [(1, 1), (33, 5), (544, 20), (2048, 300)])
def test_scratch_and_blocks_follow_the_plan(n, d, r, sym):
    """K4's partials: D + 1 sums (1/ℓ, then σ_f²) for each tile of each θ
    row; a block per (tile, θ row); D in pieces of PIECE coordinates."""
    p = K.gram_plan(r, n, n, d, sym)
    assert p.symmetric is sym
    assert p.blocks == r * p.tiles
    assert p.scratch == r * (d + 1) * p.tiles
    assert p.pieces == math.ceil(d / K.PIECE)


@pytest.mark.parametrize("sym", [False, True])
@pytest.mark.parametrize("n", NS)
def test_summation_units_depend_on_n_not_r_or_d(n, sym):
    """The tiles, K4's summation units and their order, are the same at
    R = 1, 2, 5 and D = 1, 20, 1000, so a θ row has the same bits at any
    R; gram_tile takes neither R nor D."""
    plans = [K.gram_plan(r, n, n, d, sym) for r in (1, 2, 5)
             for d in (1, 20, 1000)]
    assert len({p.tiles for p in plans}) == 1
    assert list(inspect.signature(K.gram_tile).parameters) == [
        "t", "n1", "n2", "symmetric"]


@pytest.mark.parametrize("d", [1, 20, 63, 64, 65, 300, 446, 447, 1000,
                               4000])
def test_gram_plan_takes_any_d(d):
    """No shared-memory limit on D (the old kernels held D whole: K3 ≲ 446,
    K4 ≲ 397); a block stages ceil(D / 64) pieces."""
    for r, n1, n2, sym in ((2, 544, 544, True), (1, 1, 544, False),
                           (2, 2048, 2048, True)):
        p = K.gram_plan(r, n1, n2, d, sym)
        assert p.pieces == math.ceil(d / 64)
        assert p.scratch == r * (d + 1) * p.tiles


def test_fit_shape_fills_the_sms():
    """R = 2, n = 544: 153 upper-triangle tiles a θ row (289 without the
    symmetry), 306 blocks over the 132 SMs; the rank-one refit's column
    (n1 = 1) 17 tiles."""
    p = K.gram_plan(2, 544, 544, 20, True)
    assert (p.tiles, p.blocks) == (153, 306) and p.blocks >= K.N_SM
    assert K.gram_plan(2, 544, 544, 20, False).tiles == 289
    assert K.gram_plan(1, 1, 544, 20, False).tiles == 17
    assert K.gram_plan(2, 2048, 2048, 20, True).tiles == 64 * 65 // 2


def test_same_points_only_for_the_same_points():
    x = torch.tensor(np.random.default_rng(0).uniform(0, 1, (9, 9)))
    assert K.same_points(x, x)
    for view in (x[:], x.view(9, 9), x.detach(), x.contiguous(),
                 x.reshape(9, 9)):
        assert K.same_points(x, view) and K.same_points(view, x)
    for other in (x.clone(), x.t(), x[:8], x[1:], x.float(),
                  torch.tensor(x.numpy())):
        assert not K.same_points(x, other)
    assert not K.same_points(x[:8], x[1:])
    assert K.same_points(x[1:], x[1:])


def test_same_points_survives_autograd_saving():
    """The gram op's backward sees the tensors autograd saved: still the
    same points where the forward's x1 was x2, not where x2 was a copy."""
    seen = []

    class Probe(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x1, x2, w):
            ctx.save_for_backward(x1, x2)
            return w * 2.0

        @staticmethod
        def backward(ctx, g):
            x1, x2 = ctx.saved_tensors
            seen.append(K.same_points(x1, x2))
            return None, None, g * 2.0

    x = torch.rand(5, 3, dtype=torch.float64)
    w = torch.ones(2, dtype=torch.float64, requires_grad=True)
    Probe.apply(x, x, w).sum().backward()
    Probe.apply(x, x.clone(), w).sum().backward()
    assert seen == [True, False]


@pytest.mark.parametrize("n1,n2,same", [(17, 17, True), (17, 17, False),
                                        (1, 40, False), (40, 23, False)])
def test_cpu_gram_wrappers_take_the_plain_version_and_launch_nothing(
        n1, n2, same):
    rng = np.random.default_rng(n1 + n2)
    d, r = 4, 2
    x2 = torch.tensor(rng.uniform(0, 1, (n2, d)))
    x1 = x2 if same else (x2.clone() if n1 == n2 else
                          torch.tensor(rng.uniform(0, 1, (n1, d))))
    ils = torch.tensor(rng.uniform(0.5, 3, (r, d)))
    amp = torch.tensor(rng.uniform(0.5, 2, r))
    g = torch.tensor(rng.standard_normal((r, n1, n2)))
    K.reset_launch_counts()
    assert torch.equal(K.matern52_gram_fwd(x1, x2, ils, amp),
                       matern52_gram_ref(x1, x2, ils, amp))
    for a, b in zip(K.matern52_gram_bwd_theta(x1, x2, ils, amp, g),
                    matern52_gram_bwd_theta_ref(x1, x2, ils, amp, g)):
        assert torch.equal(a, b)
    il = ils.clone().requires_grad_(True)
    matern52_gram_op(x1, x2, il, amp).sum().backward()
    assert il.grad is not None and bool(torch.isfinite(il.grad).all())
    assert K.launch_counts() == dict.fromkeys(K.LAUNCHES, 0)
    assert _build._LIB is None                    # nothing built or loaded


def test_library_name_follows_the_headers(tmp_path, monkeypatch):
    """The library's name hashes the shared header too, so an edited
    matern.cuh is rebuilt rather than a stale library reused."""
    assert any(h.name == "matern.cuh" for h in _build.HEADERS)
    header = tmp_path / "matern.cuh"
    header.write_text("// one\n")
    monkeypatch.setattr(_build, "HEADERS", (header,))
    before = _build.lib_path()
    header.write_text("// two\n")
    assert _build.lib_path() != before


# ------------------------------------------------------------ study axis
@pytest.mark.parametrize("S", [1, 3, 8])
@pytest.mark.parametrize("n,d,sym", [(544, 20, True), (33, 5, True),
                                     (1, 20, False)])
def test_study_axis_changes_only_blocks_and_scratch(S, n, d, sym):
    """S studies of R = 2 θ rows are S·R rows of one launch: the same
    tiles a row (K4's summation units), S times the blocks and scratch."""
    one = K.gram_plan(2, n, 544 if not sym else n, d, sym)
    many = K.gram_plan(2 * S, n, 544 if not sym else n, d, sym)
    assert (many.tiles, many.pieces, many.symmetric) == (
        one.tiles, one.pieces, one.symmetric)
    assert (many.blocks, many.scratch) == (S * one.blocks, S * one.scratch)


@pytest.mark.parametrize("S", [1, 3])
def test_gram_plain_versions_take_a_leading_study_axis(S):
    """K3's and K4's plain versions on x (S, n, D) with θ rows (S, R, D)
    equal the per-study calls (to 1e-13: a batched product may round
    otherwise), each study with its own points and _FAR rows; the CPU
    wrappers take them, and x1 is x2 stays the same points."""
    rng = np.random.default_rng(S)
    n, d, r = 20, 3, 2
    x = rng.uniform(0, 1, (S, n, d))
    for s in range(S):
        x[s, n - 1 - s:] = 1e6 + np.arange(1 + s)[:, None]
    x = torch.tensor(x)
    ils = torch.tensor(np.exp(rng.uniform(-1, 1, (S, r, d))))
    amp = torch.tensor(np.exp(rng.uniform(-1, 1, (S, r))))
    g = torch.tensor(rng.standard_normal((S, r, n, n)))
    assert K.same_points(x, x) and not K.same_points(x, x.clone())
    k = K.matern52_gram_fwd(x, x, ils, amp)
    di, da = K.matern52_gram_bwd_theta(x, x, ils, amp, g)
    assert k.shape == (S, r, n, n) and di.shape == (S, r, d)
    for s in range(S):
        k1 = matern52_gram_ref(x[s], x[s], ils[s], amp[s])
        d1, a1 = matern52_gram_bwd_theta_ref(x[s], x[s], ils[s], amp[s],
                                             g[s])
        for a, b in ((k1, k[s]), (d1, di[s]), (a1, da[s])):
            torch.testing.assert_close(a, b, rtol=1e-13, atol=1e-13)

"""K1's launch plan (``repro_torch.kernels.matern.kernel.plan``), K2's
(``bwd_plan``) and the wrappers' CPU paths.  A plan picks which blocks
compute (K1: split or walk regime; K2: query rows a block; scratch); the
summation order is fixed by n alone, so a row has the same bits in any
geometry and at any q (checked on a card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``)."""
import inspect
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.matern import kernel as K  # noqa: E402
from repro_torch.kernels.matern.ref import (  # noqa: E402
    matern52_posterior_bwd_ref, matern52_posterior_fwd_ref)

NS = [1, 31, 32, 33, 513, 544, 2048]


@pytest.mark.parametrize("n", NS)
def test_chunks_partition_n_by_n_alone(n):
    """ceil(n / CHUNK) chunks of CHUNK rows of K⁻¹ cover [0, n), the last
    one ragged, with the same length and count at q = 1, 10 and 1000."""
    plans = [K.plan(q, n, 20) for q in (1, 10, 1000)]
    assert len({p.chunks for p in plans}) == 1
    s = plans[0].chunks
    assert s == math.ceil(n / K.CHUNK)
    assert (s - 1) * K.CHUNK < n <= s * K.CHUNK
    starts = [c * K.CHUNK for c in range(s)]
    stops = [min(n, c + K.CHUNK) for c in starts]
    assert starts[0] == 0 and stops[-1] == n
    assert all(a == b for a, b in zip(stops[:-1], starts[1:]))


@pytest.mark.parametrize("n", [32, 130, 512, 544, 2048])
@pytest.mark.parametrize("q", [1, 2, 4, 8, 10])
def test_split_regime_at_the_main_paths_batches(q, n):
    """The MSO's evaluator buckets take the split regime: one block per
    (column tile, chunk, query tile), partials in scratch."""
    p = K.plan(q, n, 20)
    assert p.regime == "split"
    assert p.scratch == (p.chunks + 1) * q * n
    assert p.blocks == (math.ceil(n / K.TILE) * p.chunks
                        * math.ceil(q / K.SPLIT_ROWS))


def test_main_shape_spreads_k_inverse_over_the_sms():
    """q = 10, n = 544: 9 column tiles × 9 chunks = 81 blocks, each
    reading one 64 × 64 tile of K⁻¹ (32 KB) once for all 10 rows."""
    p = K.plan(10, 544, 20)
    assert (p.regime, p.chunks, p.blocks) == ("split", 9, 81)
    assert p.scratch * 8 == 10 * 10 * 544 * 8


@pytest.mark.parametrize("d", [5, 20, 40])
def test_walk_regime_at_the_pool_shape(d):
    """q = 1000, n = 2048: the split partials would take 540 MB, so each
    block of WALK_ROWS queries × WALK_COLS columns walks every chunk
    itself, with no scratch."""
    p = K.plan(1000, 2048, d)
    assert p.regime == "walk"
    assert p.scratch == 0
    assert p.blocks == math.ceil(1000 / K.WALK_ROWS) * math.ceil(
        2048 / K.WALK_COLS)
    assert 8 * (p.chunks + 1) * 1000 * 2048 > K.MAX_SCRATCH


@pytest.mark.parametrize("q", range(1, 17))
def test_scratch_within_32_mb_up_to_16_queries(q):
    """Split scratch is (S + 1)·q·n doubles (the chunks' partials and
    k*), at most 8.7 MB at q = 16 and n = 2048; the walk regime takes
    none."""
    for n in list(range(1, 70)) + [127, 128, 129, 511, 513, 544, 1000,
                                   1024, 2047, 2048]:
        p = K.plan(q, n, 20)
        if p.regime == "split":
            assert p.scratch == (p.chunks + 1) * q * n
            assert 8 * p.scratch <= 32 * 2 ** 20
        else:
            assert p.scratch == 0
    assert 8 * K.plan(16, 2048, 20).scratch == 33 * 16 * 2048 * 8


def test_large_batches_walk_when_the_split_scratch_would_be_large():
    """Past MAX_SCRATCH bytes of partials the walk regime runs even where
    its blocks do not fill the SMs; where the walk fits, no plan takes more
    scratch."""
    for q, n in ((100, 2048), (64, 4096), (33, 2048), (2000, 64)):
        p = K.plan(q, n, 8)
        assert 8 * p.scratch <= K.MAX_SCRATCH
        if 8 * (p.chunks + 1) * q * n > K.MAX_SCRATCH:
            assert p.regime == "walk" and p.scratch == 0


def test_plan_reads_shapes_only_and_refuses_what_does_not_fit():
    """Only empty inputs are refused: the split regime stages D in pieces,
    so it takes any D (D = 4000 too)."""
    assert list(inspect.signature(K.plan).parameters) == ["q", "n", "d"]
    for bad in ((0, 10, 3), (4, 0, 3), (4, 10, 0)):
        with pytest.raises(ValueError, match="empty"):
            K.plan(*bad)
    p = K.plan(1000, 2048, 4000)
    assert p.regime == "split" and p.scratch == (p.chunks + 1) * 1000 * 2048
    # past the walk's D the split regime runs, whatever its scratch
    d_max = max(d for d in range(1, 400) if K._walk_smem(d) <= K.MAX_SMEM)
    assert K.plan(1000, 2048, d_max).regime == "walk"
    p = K.plan(1000, 2048, d_max + 1)
    assert p.regime == "split" and p.scratch == (p.chunks + 1) * 1000 * 2048


@pytest.mark.parametrize("d", [1, 20, 64, 65, 100, 295, 296, 300, 1000,
                               4000])
def test_split_regime_stages_any_d_in_pieces(d):
    """The split kernel's shared memory is one piece of at most PIECE
    coordinates: D whole up to PIECE, the same size past it."""
    assert K._split_smem(d) == K._split_smem(min(d, K.PIECE)) <= K.MAX_SMEM
    for q, n in ((1, 33), (10, 544), (1000, 2048)):
        p = K.plan(q, n, d)
        if d > 81:
            assert p.regime == "split"
        assert p.chunks == math.ceil(n / K.CHUNK)


BWD_NS = [1, 31, 32, 33, 63, 64, 65, 513, 544, 2048]


@pytest.mark.parametrize("n", BWD_NS)
def test_bwd_tiles_partition_n_by_n_alone(n):
    """K2's ceil(n / TILE) column tiles of TILE training points cover
    [0, n), the last one ragged, with the same tiles at q = 1, 10 and
    1000: the order of its sums depends on n alone."""
    plans = [K.bwd_plan(q, n, 20) for q in (1, 10, 1000)]
    assert len({p.tiles for p in plans}) == 1
    s = plans[0].tiles
    assert s == math.ceil(n / K.TILE)
    assert (s - 1) * K.TILE < n <= s * K.TILE


def test_bwd_plan_reads_shapes_only():
    assert list(inspect.signature(K.bwd_plan).parameters) == ["q", "n", "d"]
    for bad in ((0, 10, 3), (4, 0, 3), (4, 10, 0)):
        with pytest.raises(ValueError, match="empty"):
            K.bwd_plan(*bad)


@pytest.mark.parametrize("q,rows", [(1, 1), (2, 1), (4, 1), (8, 1), (10, 1),
                                    (16, 1), (17, 16), (129, 16),
                                    (1000, 16)])
def test_bwd_rows_per_block(q, rows):
    """A row a block at the evaluator's buckets (q ≤ 16); BWD_ROWS rows
    past that, so that a tile's training rows are staged once per 16
    queries; one split block per (tile, rows)."""
    p = K.bwd_plan(q, 544, 20)
    assert p.rows == rows
    assert p.blocks == p.tiles * math.ceil(q / rows)


@pytest.mark.parametrize("q", [1, 10, 1000])
@pytest.mark.parametrize("n,d", [(33, 5), (544, 20), (2048, 20), (544, 300)])
def test_bwd_scratch_is_tiles_q_d_plus_one(q, n, d):
    """D partials Σ_j c_ij b_jk and one Σ_j c_ij for each (tile, row)."""
    p = K.bwd_plan(q, n, d)
    assert p.scratch == p.tiles * q * (d + 1)


def test_bwd_main_shape_spreads_over_the_sms():
    """q = 10, n = 544: 9 tiles × 10 rows = 90 blocks (the one block a row
    before); q = 1000, n = 2048: 32 tiles × 63 row groups."""
    p = K.bwd_plan(10, 544, 20)
    assert (p.rows, p.tiles, p.blocks) == (1, 9, 90) and p.blocks >= 90
    p = K.bwd_plan(1000, 2048, 20)
    assert (p.rows, p.tiles, p.blocks) == (16, 32, 32 * 63)
    assert 8 * p.scratch == 32 * 1000 * 21 * 8


@pytest.mark.parametrize("q,n,d", [(10, 100_000, 20), (1000, 50_000, 20),
                                   (10, 544, 1000), (1000, 2048, 4000)])
def test_bwd_plan_refuses_no_large_n_or_d(q, n, d):
    """No shared-memory limit on n (the old kernel held a row's n
    weights in shared memory, n ≲ 29k) or on D (pieces)."""
    p = K.bwd_plan(q, n, d)
    assert p.tiles == math.ceil(n / K.TILE)
    assert p.scratch == p.tiles * q * (d + 1)


def test_cpu_wrapper_takes_the_plain_version_and_launches_nothing():
    rng = np.random.default_rng(0)
    n, d, q = 40, 3, 7
    xt = torch.tensor(rng.uniform(0, 1, (n, d)))
    kinv = torch.tensor(rng.standard_normal((n, n)))
    args = (xt, torch.tensor(rng.standard_normal(n)), kinv + kinv.T,
            torch.tensor(rng.uniform(1, 3, d)), torch.tensor(1.3,
                                                             dtype=torch.float64))
    xq = torch.tensor(rng.uniform(0, 1, (q, d)))
    K.reset_launch_counts()
    got = K.matern52_posterior_fwd(xq, *args)
    want = matern52_posterior_fwd_ref(xq, *args)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert K.launch_counts() == dict.fromkeys(K.LAUNCHES, 0)
    assert _build._LIB is None                    # nothing built or loaded


def test_cpu_bwd_wrapper_takes_the_plain_version_and_launches_nothing():
    rng = np.random.default_rng(1)
    n, d, q = 70, 4, 5
    f64 = torch.float64
    xq = torch.tensor(rng.uniform(0, 1, (q, d)))
    args = (torch.tensor(rng.uniform(0, 1, (n, d))),
            torch.tensor(rng.standard_normal(n)),
            torch.tensor(rng.standard_normal((q, n))),
            torch.tensor(rng.uniform(0, 1, q)),
            torch.tensor(rng.uniform(1, 3, d)), torch.tensor(1.3, dtype=f64),
            torch.tensor(rng.standard_normal(q)),
            torch.tensor(rng.standard_normal(q)))
    K.reset_launch_counts()
    got = K.matern52_posterior_bwd_xq(xq, *args)
    assert torch.equal(got, matern52_posterior_bwd_ref(xq, *args))
    assert got.shape == (q, d)
    assert K.launch_counts() == dict.fromkeys(K.LAUNCHES, 0)
    assert _build._LIB is None                    # nothing built or loaded


# ------------------------------------------------------------ study axis
@pytest.mark.parametrize("S", [1, 3, 8])
@pytest.mark.parametrize("q,n,d", [(10, 544, 20), (1, 33, 5), (1000, 2048, 20),
                                   (10, 544, 300)])
def test_study_axis_changes_only_blocks_and_scratch(S, q, n, d):
    """A call on S stacked studies keeps the solo call's regime, chunks
    (K1) and rows and tiles (K2), which fix the order of every sum, and
    takes S times its blocks and scratch."""
    for one in (K.plan(q, n, d), K.bwd_plan(q, n, d)):
        many = one.studies(S)
        assert many._replace(blocks=one.blocks, scratch=one.scratch) == one
        assert (many.blocks, many.scratch) == (S * one.blocks,
                                               S * one.scratch)


@pytest.mark.parametrize("S", [1, 3])
def test_plain_versions_take_a_leading_study_axis(S):
    """K1's and K2's plain versions on S stacked studies equal the
    per-study calls (to 1e-14 of the terms: a batched product may round
    otherwise than one study's), each study with its own θ and its own
    _FAR padding; the CPU wrappers take them."""
    rng = np.random.default_rng(S)
    n, d, q = 24, 3, 5
    xt = rng.uniform(0, 1, (S, n, d))
    for s in range(S):
        xt[s, n - 2 - s:] = 1e6 + np.arange(2 + s)[:, None]
    args = [torch.tensor(v) for v in (
        rng.uniform(0, 1, (S, q, d)), xt, rng.standard_normal((S, n)),
        rng.standard_normal((S, n, n)), np.exp(rng.uniform(-1, 1, (S, d))),
        np.exp(rng.uniform(-1, 1, (S,))))]
    m, v, t = K.matern52_posterior_fwd(*args)
    gm, gv = torch.ones_like(m), -0.5 * torch.ones_like(m)
    g = K.matern52_posterior_bwd_xq(args[0], args[1], args[2], t, v,
                                    args[4], args[5], gm, gv)
    assert m.shape == v.shape == (S, q) and g.shape == (S, q, d)
    for s in range(S):
        one = [a[s] for a in args]
        m1, v1, t1 = matern52_posterior_fwd_ref(*one)
        g1 = matern52_posterior_bwd_ref(one[0], one[1], one[2], t1, v1,
                                        one[4], one[5], gm[s], gv[s])
        for a, b in ((m1, m[s]), (v1, v[s]), (t1, t[s]), (g1, g[s])):
            torch.testing.assert_close(a, b, rtol=1e-13, atol=1e-13)

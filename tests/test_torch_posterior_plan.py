"""K1's launch plan (``repro_torch.kernels.matern.kernel.plan``) and the
wrapper's CPU path.  The plan picks which blocks compute (split or walk
regime, scratch); the summation order is fixed by n alone, so a row has
the same bits in either regime and at any q (checked on a card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``)."""
import inspect
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.matern import kernel as K  # noqa: E402
from repro_torch.kernels.matern.ref import \
    matern52_posterior_fwd_ref  # noqa: E402

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
    assert list(inspect.signature(K.plan).parameters) == ["q", "n", "d"]
    for bad in ((0, 10, 3), (4, 0, 3), (4, 10, 0)):
        with pytest.raises(ValueError, match="empty"):
            K.plan(*bad)
    with pytest.raises(ValueError, match="shared memory"):
        K.plan(1000, 2048, 4000)
    # past the walk's D the split regime runs, whatever its scratch
    d_max = max(d for d in range(1, 400) if K._walk_smem(d) <= K.MAX_SMEM)
    assert K.plan(1000, 2048, d_max).regime == "walk"
    p = K.plan(1000, 2048, d_max + 1)
    assert p.regime == "split" and p.scratch == (p.chunks + 1) * 1000 * 2048


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

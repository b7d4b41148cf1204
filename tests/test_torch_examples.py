"""The port's twins of the paper's examples (``examples/*_torch.py``) run
on the CPU at their own sizes; the paper twin holds C3 within the port and
agrees with the reference's ``examples/paper_repro.py``."""
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402,F401  (x64 comes from conftest)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "examples"))

import paper_repro  # noqa: E402
import paper_repro_torch  # noqa: E402
import quickstart_torch  # noqa: E402
import serve_batched_torch  # noqa: E402
from repro.core.mso import MsoOptions as JOpts  # noqa: E402
from repro.core.mso import maximize_acqf as j_maximize  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread a test process, so that parallel test workers
    do not oversubscribe the cores (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_paper_twin_c3_c2_and_the_reference():
    out = paper_repro_torch.main(["--device", "cpu"])
    res = out["results"]
    assert out["c3"]                              # D-BE == SEQ, bitwise
    assert out["c2_inflation"] > 2.0              # C-BE inflates QN iters
    assert res["dbe"].n_rounds * 3 < res["seq"].n_rounds
    x0 = np.random.default_rng(0).uniform(0, 3, (10, 5))
    opts = JOpts(m=10, maxiter=200, pgtol=1e-8)
    for s in paper_repro_torch.STRATEGIES:
        ref = j_maximize(paper_repro.neg_rosen, x0, 0.0, 3.0,
                         acq_state=None, strategy=s, options=opts)
        assert abs(res[s].best_acq - ref.best_acq) <= 1e-6, s
        if s == "cbe":
            # one shared QN state over B·D = 50 coordinates: the
            # reference's jitted evaluator rounds ~1e-12 off its own eager
            # values, which the port reproduces bitwise, and C-BE's 150+
            # iterations carry that into its count (ROADMAP C16)
            assert len(set(res[s].n_iters)) == 1
            continue
        np.testing.assert_array_equal(res[s].n_iters, np.asarray(ref.n_iters))


def test_quickstart_twin_on_the_cpu(capsys):
    s = quickstart_torch.main(["--device", "cpu"])
    assert len(s.trials) == 40 and s.stats.n_gp_fits == 30
    assert np.isfinite(s.best().y)
    assert len(s.stats.acqf_rounds) == 30 and min(s.stats.acqf_rounds) > 0
    assert "best value" in capsys.readouterr().out


def test_serve_twin_on_the_cpu(capsys):
    eng = serve_batched_torch.main(["--device", "cpu"])
    assert eng.stats["tokens"] == 10 * 12
    assert eng.stats["compiles"] == 1
    assert eng.stats["flash_launches"] == 0        # the CPU launches none
    assert "served 10 requests" in capsys.readouterr().out

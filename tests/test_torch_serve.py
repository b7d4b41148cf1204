"""Parity of the port's ``ServeEngine`` with the JAX package's on the
traffic of ``tests/test_runtime.py`` (reduced llama3.2-3b, float32, JAX's
parameters carried across): greedy tokens equal token by token under
continuous batching, staggered admission, chunked prefill and slot reuse,
with one program signature in steady state.  The same for the reduced
qwen3-moe-30b-a3b (published capacity factor: pairs drop), chameleon-34b
and recurrentgemma-9b (a recurrent tail, a ring that wraps), where
staggered admission is held to JAX's tokens, not to solo runs: in the
reference an idle row's dummy token advances a live slot's recurrent
state (ROADMAP C17), and capacity makes a MoE row depend on its batch.
Also: an engine owns its cache, and the CLI serves on the CPU when
asked."""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.distributed.sharding import unbox  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JServeEngine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402


@pytest.fixture(scope="module")
def tiny():
    jcfg = jax_get_config("llama3_2_3b").reduced().replace(dtype="float32",
                                                           attn_chunk=16)
    jparams = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    cfg = get_config("llama3_2_3b").reduced().replace(dtype="float32")
    params = lm_params_from_numpy(jax.tree.map(np.asarray, unbox(jparams)),
                                  device="cpu")
    return (jcfg, jparams), (cfg, params)


def engines(tiny, **kw):
    (jcfg, jparams), (cfg, params) = tiny
    return JServeEngine(jparams, jcfg, **kw), ServeEngine(params, cfg, **kw)


def outputs(done):
    return {r.uid: r.out_tokens for r in done}


def submit_both(pair, uid, prompt, n):
    pair[0].submit(JRequest(uid=uid, prompt=prompt, max_new_tokens=n))
    pair[1].submit(Request(uid=uid, prompt=prompt, max_new_tokens=n))


def test_continuous_batching_matches_jax(tiny):
    pair = engines(tiny, slots=3, max_len=64)
    rng = np.random.default_rng(0)
    vocab = tiny[1][0].vocab_size
    for i in range(7):
        submit_both(pair, i, rng.integers(0, vocab, 4 + (i % 3)).astype(
            np.int32), 5)
    done = [outputs(e.run_until_drained()) for e in pair]
    assert len(done[1]) == 7
    assert all(len(t) == 5 for t in done[1].values())
    assert done[1] == done[0]
    jax_eng, eng = pair
    assert eng.stats["steps"] == jax_eng.stats["steps"]
    assert eng.stats["tokens"] == jax_eng.stats["tokens"] == 35
    assert eng.stats["compiles"] == 1
    assert eng.stats["flash_launches"] == 0       # CPU: the plain version


def test_stats_readable_before_first_step(tiny):
    _, eng = engines(tiny, slots=2, max_len=64)
    assert eng.stats["compiles"] == 0
    eng.submit(Request(uid=0, prompt=np.arange(4, dtype=np.int32),
                       max_new_tokens=2))
    eng.run_until_drained()
    assert eng.stats["compiles"] == 1


def test_staggered_admission_and_chunked_prefill_match_solo_and_jax(tiny):
    vocab = tiny[1][0].vocab_size
    rng = np.random.default_rng(2)
    pa = rng.integers(0, vocab, 9).astype(np.int32)
    pb = rng.integers(0, vocab, 5).astype(np.int32)

    solo = {}
    for uid, prompt in ((0, pa), (1, pb)):
        pair = engines(tiny, slots=2, max_len=64)
        submit_both(pair, uid, prompt, 6)
        jax_out, out = (e.run_until_drained()[0].out_tokens for e in pair)
        assert out == jax_out
        solo[uid] = out

    pair = engines(tiny, slots=2, max_len=64)
    submit_both(pair, 0, pa, 6)
    for e in pair:
        for _ in range(3):              # A decodes alone for a few steps
            e.step()
    submit_both(pair, 1, pb, 6)
    assert [outputs(e.run_until_drained()) for e in pair] == [solo, solo]

    pair = engines(tiny, slots=2, max_len=64, prefill_chunk=2)
    submit_both(pair, 0, pa, 6)
    for e in pair:
        e.step()                        # A prefills 2 of 8 prompt steps
        assert e._prefilling == {0} and e.positions[0] == 2
    submit_both(pair, 1, pb, 6)
    assert [outputs(e.run_until_drained()) for e in pair] == [solo, solo]
    assert pair[1].stats["compiles"] == 1


def test_slot_isolation_matches_jax(tiny):
    vocab = tiny[1][0].vocab_size
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, vocab, 6).astype(np.int32)
    first = rng.integers(0, vocab, 9).astype(np.int32)

    pair = engines(tiny, slots=1, max_len=64)
    submit_both(pair, 0, prompt, 4)
    ref = [e.run_until_drained()[0].out_tokens for e in pair]

    pair = engines(tiny, slots=1, max_len=64)
    submit_both(pair, 0, first, 4)
    submit_both(pair, 1, prompt, 4)
    second = [outputs(e.run_until_drained())[1] for e in pair]
    assert second == ref and ref[0] == ref[1]


def test_an_engine_owns_its_cache(tiny):
    _, (cfg, params) = tiny
    a = ServeEngine(params, cfg, slots=2, max_len=32)
    b = ServeEngine(params, cfg, slots=2, max_len=32)
    for name in ("k", "v", "pos"):
        assert a.cache[name].data_ptr() != b.cache[name].data_ptr()
    before = {k: v.clone() for k, v in b.cache.items()}
    a.submit(Request(uid=0, prompt=np.arange(5, dtype=np.int32),
                     max_new_tokens=3))
    a.run_until_drained()
    assert torch.any(a.cache["pos"] >= 0)
    assert all(torch.equal(b.cache[k], before[k]) for k in before)


def test_cli_serves_on_the_cpu_when_asked(capsys):
    eng = launch_serve.main(["--arch", "llama3.2-3b", "--reduced",
                             "--device", "cpu", "--requests", "3",
                             "--slots", "2", "--max-len", "32",
                             "--prompt-len", "5", "--max-new", "4"])
    assert eng.stats["tokens"] == 12 and eng.stats["compiles"] == 1
    assert "3 requests, 12 tokens" in capsys.readouterr().out
    if not torch.cuda.is_available():   # the default device is the card
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            launch_serve.main(["--arch", "llama3.2-3b", "--reduced"])


# ---------------------------------------------------------------------------
# moe, vlm and hybrid families
# ---------------------------------------------------------------------------

FAMILIES = ("qwen3_moe_30b_a3b", "chameleon_34b", "recurrentgemma_9b")


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    """A family's reduced config on both sides, float32; hybrid with a
    recurrent tail (5 layers) and a window of 8 that the traffic wraps."""
    kw = dict(n_layers=5, window=8) if request.param == "recurrentgemma_9b" \
        else {}
    jcfg = jax_get_config(request.param).reduced().replace(
        dtype="float32", attn_chunk=16, **kw)
    jparams = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    cfg = get_config(request.param).reduced().replace(dtype="float32", **kw)
    params = lm_params_from_numpy(jax.tree.map(np.asarray, unbox(jparams)),
                                  device="cpu")
    return (jcfg, jparams), (cfg, params)


def test_family_continuous_batching_matches_jax(family):
    pair = engines(family, slots=3, max_len=64)
    rng = np.random.default_rng(0)
    vocab = family[1][0].vocab_size
    for i in range(7):
        submit_both(pair, i, rng.integers(0, vocab, 4 + (i % 3)).astype(
            np.int32), 5)
    done = [outputs(e.run_until_drained()) for e in pair]
    assert len(done[1]) == 7 and done[1] == done[0]
    jax_eng, eng = pair
    assert eng.stats["steps"] == jax_eng.stats["steps"]
    assert eng.stats["compiles"] == 1 and eng.stats["flash_launches"] == 0
    assert eng.stats["cache_bytes"] == sum(
        np.asarray(a).nbytes for a in jax.tree.leaves(jax_eng.cache))


def test_family_staggered_and_chunked_schedules_match_jax(family):
    """Staggered admission and chunked prefill, token for token with JAX;
    for the hybrid family staggered admission moves request 0's tokens
    off its solo run in both packages (C17)."""
    vocab = family[1][0].vocab_size
    rng = np.random.default_rng(2)
    pa = rng.integers(0, vocab, 9).astype(np.int32)
    pb = rng.integers(0, vocab, 5).astype(np.int32)
    pair = engines(family, slots=2, max_len=64)
    submit_both(pair, 0, pa, 6)
    solo = [e.run_until_drained()[0].out_tokens for e in pair]
    assert solo[1] == solo[0]

    pair = engines(family, slots=2, max_len=64)
    submit_both(pair, 0, pa, 6)
    for e in pair:
        for _ in range(3):
            e.step()
    submit_both(pair, 1, pb, 6)
    stag = [outputs(e.run_until_drained()) for e in pair]
    assert stag[1] == stag[0]
    if family[1][0].family == "hybrid":
        assert stag[1][0] != solo[1]

    pair = engines(family, slots=2, max_len=64, prefill_chunk=2)
    submit_both(pair, 0, pa, 6)
    for e in pair:
        e.step()
        assert e._prefilling == {0} and e.positions[0] == 2
    submit_both(pair, 1, pb, 6)
    chunk = [outputs(e.run_until_drained()) for e in pair]
    assert chunk[1] == chunk[0] and pair[1].stats["compiles"] == 1


@pytest.mark.parametrize("arch", ("qwen3-moe-30b-a3b", "recurrentgemma-9b",
                                  "chameleon-34b"))
def test_cli_serves_the_families_on_the_cpu(arch, capsys):
    eng = launch_serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                             "--requests", "3", "--slots", "2",
                             "--max-len", "32", "--prompt-len", "5",
                             "--max-new", "4"])
    assert eng.stats["tokens"] == 12 and eng.stats["compiles"] == 1
    assert "3 requests, 12 tokens" in capsys.readouterr().out

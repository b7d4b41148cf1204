"""The port's dry run (``repro_torch.launch.dryrun``, ``launch.hlo_cost``,
``launch.mesh``) and K6/K7's cost (``kernels.flash.cost``), on the CPU.

FLOP parity with the JAX package: the reduced configs' train (remat none
and full), prefill and decode steps, counted on meta tensors, against
``repro.launch.hlo_cost.analyze`` of the JAX step compiled on a 1×1 smoke
mesh (XLA's own ``cost_analysis()`` counts a scanned layer body once, so
it is not the yardstick).  Every count is within 2 % of JAX's; the gaps
above 0.1 %, each named by the op that causes it:

* dense (llama3.2-3b), moe (qwen3-moe-30b-a3b), hybrid
  (recurrentgemma-9b) and encdec (whisper-base) train steps, none and
  full: the port counts one attention score product more per attention
  call, 2·B·NH·Sq·Sk·hd, exactly: K7's plain version recomputes S = QKᵀ
  from q and k, where XLA's autodiff keeps the forward's P (dense at
  B=4, S=32: 4,194,304 FLOPs, 0.83 % and 0.68 %).  The test holds these
  to JAX's count plus that product, exactly.
* ssm (xlstm-1.3b) train step, none (−4,653,056, −0.93 %): in the
  mLSTM chunk scan JAX's ``lax.scan`` transposes the chunk-final state's
  product C = Σ w·kᵀ·v (its dK and dV, 2·2·B·H·L·dk·dv a chunk) though
  the final state gets no cotangent, and counts the normalizer's
  contractions q·n and Σ w·k as dots (2·B·H·L·dk each, and their
  transposes), where the port's autograd skips the unused state and
  sums elementwise; the port also computes that state's forward product,
  which XLA drops; and in the sLSTM scan the port takes no gradient
  through the zero initial h (four recurrent products of 2·B·H·wh² fewer
  a layer).  Under full remat the gap is −524,288 (−0.08 %).
* prefill and decode: equal.

Also: the dry run's records (``run_cell``, the CLI), prefill_32k's
memory term (linear in S once the kernels' bytes replace the plain
attention's) and working set, the working set's peak, the hybrid and
ssm cells' quadratic reading against a full count, and K6/K7's
closed-form pair count against the mask-summing one.
"""
import json

import jax
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.launch import shapes as JS  # noqa: E402
from repro.launch.hlo_cost import analyze  # noqa: E402
from repro.launch.mesh import make_smoke_mesh, use_mesh  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.flash import cost as FC  # noqa: E402
from repro_torch.kernels.flash.ref import position_mask  # noqa: E402
from repro_torch.distributed.sharding import get_abstract_mesh  # noqa: E402
from repro_torch.launch import dryrun, mesh  # noqa: E402
from repro_torch.kernels.flash import kernel as FK  # noqa: E402
from repro_torch.launch import hlo_cost  # noqa: E402
from repro_torch.launch.hlo_cost import count_cell  # noqa: E402
from repro_torch.launch.shapes import ShapeCell, build_cell  # noqa: E402
from repro_torch.train.optim import OptimConfig, tree_leaves  # noqa: E402
from repro_torch.train.step import compute_grads  # noqa: E402

B, S = 4, 32
ATTENTION = ("llama3.2-3b", "qwen3-moe-30b-a3b", "recurrentgemma-9b",
             "whisper-base")
CASES = ([(a, "train", r) for a in ATTENTION + ("xlstm-1.3b",)
          for r in ("none", "full")]
         + [(a, k, "full") for a in ("llama3.2-3b", "recurrentgemma-9b")
            for k in ("prefill", "decode")])


def jax_flops(arch, kind, remat, seq):
    jcfg = jax_get_config(arch).reduced().replace(
        dtype="float32", attn_chunk=16, remat=remat)
    m = make_smoke_mesh((1, 1), ("data", "model"))
    with use_mesh(m):
        step, args, shards, outs, donate = JS.build_cell(
            jcfg, JS.ShapeCell("mini", kind, seq, B), m, grad_accum=1)
        text = jax.jit(step, in_shardings=shards, out_shardings=outs,
                       donate_argnums=donate).lower(*args).compile().as_text()
    return analyze(text)["flops"]


@pytest.mark.parametrize("arch,kind,remat", CASES)
def test_flops_match_jax_hlo_cost(arch, kind, remat):
    seq = 64 if kind == "decode" else S
    cfg = get_config(arch).reduced().replace(dtype="float32", remat=remat)
    got = count_cell(cfg, ShapeCell("mini", kind, seq, B), grad_accum=1)
    want = jax_flops(arch, kind, remat, seq)
    gap = got["flops"] - want
    assert abs(gap) <= 0.02 * want, (gap, want)
    if kind != "train":
        assert gap == 0
    elif arch in ATTENTION:
        # one score product a K7 call: what its plain version recomputes
        att = got["attention"]
        runs = 2 if remat == "full" else 1      # K6 runs again under remat
        assert att["k7_calls"] > 0
        assert att["k6_calls"] == runs * att["k7_calls"]
        # every call at its shape P = B·NH·Sq·Sk·hd: the plain forward
        # does 4·P a run, the plain backward 10·P, of which the recomputed
        # score product is 2·P
        assert att["plain_flops"] % (4 * runs + 10) == 0
        assert gap == 2 * att["plain_flops"] // (4 * runs + 10)


def test_run_cell_record_and_skips(tmp_path):
    rec = dryrun.run_cell("llama3.2-3b", "train_4k")
    keys = {"arch", "shape", "mesh", "family", "status", "skip_reason",
            "n_chips", "flops_per_device", "bytes_per_device", "collectives",
            "t_compute", "t_memory", "t_collective", "bottleneck", "memory",
            "live_bytes_per_device", "fits_hbm", "count_s", "remat",
            "grad_accum", "attention_plain_flops", "attention_kernel_flops",
            "attention_plain_bytes", "attention_kernel_bytes",
            "k6_calls", "k7_calls", "counted_at"}
    assert keys <= set(rec), keys - set(rec)
    assert rec["status"] == "ok" and rec["mesh"] == "single"
    assert rec["n_chips"] == 1 and rec["collectives"] == {}
    assert rec["t_collective"] == 0 and rec["remat"] == "full"
    assert rec["grad_accum"] == 256 and rec["count_s"] < 60
    mem = rec["memory"]
    assert set(mem) == {"param_bytes", "opt_bytes", "grad_bytes",
                        "cache_bytes", "saved_bytes", "work_bytes"}
    assert rec["live_bytes_per_device"] == sum(mem[k]
                                               for k in dryrun.LIVE_KEYS)
    n = 3_606_752_256                       # every leaf, norms included
    assert mem["param_bytes"] == 2 * n
    assert mem["opt_bytes"] == 8 * n
    assert mem["grad_bytes"] == 2 * n + 4 * n
    # the working set holds the gradients and the accumulator at once,
    # and more (the update's float32 temporaries)
    assert mem["work_bytes"] > mem["grad_bytes"] > mem["saved_bytes"] > 0
    assert rec["fits_hbm"] == (rec["live_bytes_per_device"] <= mesh.HBM_BYTES)
    # 28 layers × 256 microbatches: K6 twice (remat), K7 once
    assert (rec["k6_calls"], rec["k7_calls"]) == (2 * 28 * 256, 28 * 256)
    assert rec["attention_kernel_flops"] < rec["attention_plain_flops"]
    assert rec["t_compute"] == pytest.approx(
        (rec["flops_per_device"] - rec["attention_plain_flops"]
         + rec["attention_kernel_flops"]) / mesh.PEAK_FLOPS_BF16)
    assert rec["t_memory"] == pytest.approx(
        (rec["bytes_per_device"] - rec["attention_plain_bytes"]
         + rec["attention_kernel_bytes"]) / mesh.HBM_BW)
    skip = dryrun.run_cell("llama3.2-3b", "long_500k")
    assert skip["status"] == "skipped" and skip["skip_reason"] == \
        JS.cell_supported(jax_get_config("llama3.2-3b"),
                          JS.SHAPES["long_500k"])[1]


def test_prefill_memory_term_is_linear_in_s_and_counts_the_working_set():
    """prefill_32k: the plain attention's S² bytes are kept apart and
    replaced by K6's, so the memory term doubles with S (the plain bytes
    quadruple); the working set (one MLP activation at B=32 is 17 GB)
    does not fit in the card."""
    full = dryrun.run_cell("llama3.2-3b", "prefill_32k")
    half = dryrun.cell_record(get_config("llama3.2-3b"),
                              ShapeCell("half", "prefill", 16384, 32))
    assert full["attention_plain_bytes"] > 3.9 * half["attention_plain_bytes"]
    assert full["t_memory"] <= 2 * half["t_memory"]
    assert full["t_memory"] * mesh.HBM_BW == \
        pytest.approx(full["bytes_with_kernels"])
    assert full["memory"]["work_bytes"] > 2 * 32 * 32768 * 8192 * 2
    assert full["fits_hbm"] is False


def test_work_bytes_is_the_peak_of_storages_alive_at_once():
    """Freed storages leave the working set; in-place ops and views add
    none; a flash call adds its outputs alone."""
    c = hlo_cost.Counts()
    with c.run():
        a = torch.empty(100, device="meta")           # 400 B
        b = a + 1                                     # 800
        del a
        b.mul_(2)                                     # in place: 400
        v = b.view(10, 10)
        c2 = v * 2                                    # 800
        del b, v, c2
    assert c.live.peak == 800 and c.live.now == 0
    q = torch.empty((1, 64, 2, 32), device="meta")
    k = torch.empty((1, 64, 1, 32), device="meta")
    pos = torch.empty((1, 64), dtype=torch.int32, device="meta")
    c = hlo_cost.Counts()
    with c.run():
        out = FK.flash_attention_fwd(q, k, k, pos, pos)
    assert c.live.peak == out.numel() * 4
    assert c.attention_bytes > 64 * 64 * 2 * 4 and len(c.attention) == 1
    # with the saved-tensor hooks on, what the forward saved is freed by
    # the backward: the loss and the gradients alone outlive it
    for remat in ("none", "full"):
        cfg = get_config("llama3.2-3b").reduced().replace(remat=remat)
        _, (params, _, batch) = build_cell(cfg, ShapeCell("mini", "train",
                                                          32, 2))
        c = hlo_cost.Counts(params)
        with c.run(saving=True):
            loss, grads = compute_grads(params, cfg, batch)
        assert c.saved_bytes > 0
        assert c.live.now == loss.element_size() + sum(
            g.numel() * g.element_size() for g in tree_leaves(grads))


def test_cli_writes_one_json_a_cell_and_refuses_a_mesh(tmp_path):
    dryrun.main(["--arch", "whisper-base", "--shape", "decode_32k",
                 "--out", str(tmp_path), "--set", "remat=none"])
    (path,) = tmp_path.glob("*.json")
    assert path.name == "whisper-base__decode_32k__single.json"
    rec = json.loads(path.read_text())
    assert rec["status"] == "ok" and rec["remat"] == "none"
    assert rec["memory"]["cache_bytes"] > 0 and rec["k7_calls"] == 0
    with pytest.raises(NotImplementedError, match="9b"):
        dryrun.main(["--sweep", "--mesh", "multi", "--out", str(tmp_path)])
    # the LM's meshes are ported: they need an initialized process group
    # (never falling back), and use_mesh installs the ambient mesh
    with pytest.raises(RuntimeError, match="initialized process group"):
        mesh.make_smoke_mesh(device="cpu")
    with pytest.raises(ValueError, match="256 ranks"):
        mesh.make_production_mesh()
    with mesh.use_mesh(None) as m:
        assert m is None and get_abstract_mesh() is None
    # the fleet's mesh is ported: CPU entries only when asked for, and
    # never more cards than are visible
    assert mesh.make_fleet_mesh(3, device="cpu").devices == \
        (torch.device("cpu"),) * 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            mesh.make_fleet_mesh(1)
    else:
        with pytest.raises(ValueError, match="visible devices"):
            mesh.make_fleet_mesh(torch.cuda.device_count() + 1)
    assert (mesh.HBM_BYTES, mesh.HBM_BW, mesh.PEAK_FLOPS_BF16) == \
        (80e9, 3.35e12, 989e12)


@pytest.mark.parametrize("arch", ("recurrentgemma-9b", "xlstm-1.3b"))
def test_scan_families_read_off_the_quadratic_exactly(arch):
    """A cell of five units counted at 2, 3 and 4 and read off the
    quadratic equals its full count, every counter."""
    cfg = get_config(arch).reduced().replace(dtype="float32", mlstm_chunk=4,
                                             n_layers=3 if arch.startswith(
                                                 "recurrent") else 2)
    unit = 16 if cfg.family == "hybrid" else 4
    cell = ShapeCell("mini", "train", 5 * unit, 2)
    a = count_cell(cfg, cell, grad_accum=1)
    b = hlo_cost._count(cfg, cell, OptimConfig(), 1, None)
    assert a["counted_at"] == [2 * unit, 3 * unit, 4 * unit]
    assert a["work_bytes"] is None
    assert a == dict(hlo_cost.summary(b, None), grad_accum=1,
                     counted_at=a["counted_at"])


MASKS = [  # (B, Sq, Sk, causal, window)
    (2, 16, 16, True, None), (1, 7, 19, True, None), (2, 16, 16, True, 5),
    (1, 5, 40, True, 8), (2, 12, 9, False, None), (1, 10, 30, False, 4),
    (1, 6, 6, True, 0), (1, 1, 33, True, None), (3, 20, 20, True, 64)]


@pytest.mark.parametrize("b,sq,sk,causal,window", MASKS)
def test_closed_form_cost_equals_the_mask_count(b, sq, sk, causal, window):
    """Queries suffix-aligned (position Sk − Sq + i), keys at 0..Sk−1: the
    closed form equals the (B, Sq, Sk) mask's count, K6's and K7's."""
    nh, kh, hd = 4, 2, 32
    q_pos = torch.arange(sk - sq, sk, dtype=torch.int32).expand(b, sq)
    kv_pos = torch.arange(sk, dtype=torch.int32).expand(b, sk)
    mask = position_mask(q_pos, kv_pos, causal, window)
    assert b * FC.visible_pairs(sq, sk, causal, window) == int(mask.sum())
    assert b * FC.keys_seen(sq, sk, causal, window) == \
        int(mask.any(1).sum())
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.zeros((b, sq, nh, hd), dtype=dtype)
        k = torch.zeros((b, sk, kh, hd), dtype=dtype)
        for masked, closed in ((FC.flash_cost, FC.fwd_cost),
                               (FC.flash_bwd_cost, FC.bwd_cost)):
            assert masked(q, k, q_pos, kv_pos, causal, window) == \
                closed(dtype, b, sq, sk, nh, kh, hd, causal, window)


def test_mask_count_keeps_data_dependent_positions():
    """With values (empty slots at −1, ragged rows) the count is the
    mask's, as chip_smoke.py's bounds need."""
    kv = torch.tensor([[0, 1, 2, -1, -1], [0, 1, -1, -1, -1]],
                      dtype=torch.int32)
    qp = torch.tensor([[2], [1]], dtype=torch.int32)
    q = torch.zeros((2, 1, 2, 32))
    k = torch.zeros((2, 5, 1, 32))
    nbytes, ops, rate = FC.flash_cost(q, k, qp, kv)
    assert ops == 4 * 5 * 2 * 32 and rate == mesh.PEAK_FLOPS_F32
    assert nbytes == 2 * 2 * 2 * 32 * 4 + 2 * 5 * 32 * 4 + 4 * (2 + 10)
    assert FC.flash_bwd_cost(q, k, qp, kv)[1] == 10 * 5 * 2 * 32

"""The port's training launcher, its async checkpoints and the HPO example
twins, on the CPU.

* ``CheckpointManager``: ``save`` copies to the host at once and writes in
  the background (a tensor updated in place right after is saved as it
  was), ``wait`` joins (and raises what a background write raised),
  reads join first, ``block=True`` writes before it returns,
  ``save_flat`` waits for the save in flight; bfloat16 leaves and the
  optimizer state (a NamedTuple with a host step) round-trip bitwise.
* ``launch/train.main --device cpu``: 6 steps with checkpoints every 3
  equal (bitwise) a run resumed from the step-3 checkpoint; SIGTERM
  checkpoints and exits; ``--mesh`` raises naming ROADMAP item 9b; the
  loss falls over the reference's example run.
* ``examples/hpo_train_torch.py`` and ``hpo_service_torch.py`` with
  ``--device cpu`` at a few trials: finite losses, the sampler and the
  service serve every trial.
"""
import os
import shutil
import signal
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.ckpt import manager as M  # noqa: E402
from repro_torch.ckpt.manager import CheckpointManager  # noqa: E402
from repro_torch.launch import train as T  # noqa: E402
from repro_torch.train.optim import (AdamState, OptimConfig,  # noqa: E402
                                     init_opt_state, tree_leaves)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "examples"))

import hpo_service_torch  # noqa: E402
import hpo_train_torch  # noqa: E402

COMMON = ["--arch", "llama3.2-3b", "--reduced", "--device", "cpu",
          "--batch", "2", "--seq", "32", "--log-every", "100"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_async_save_copies_now_and_writes_in_the_background(tmp_path,
                                                           monkeypatch):
    gate = threading.Event()
    real = CheckpointManager._write

    def slow_write(self, step, flat):
        gate.wait(5)
        real(self, step, flat)
    monkeypatch.setattr(CheckpointManager, "_write", slow_write)
    mgr = CheckpointManager(str(tmp_path), keep=2)
    x = torch.arange(6, dtype=torch.float32)
    mgr.save(1, {"x": x})
    x.add_(100)                         # the caller steps on in place
    assert mgr._thread is not None and mgr._thread.is_alive()
    assert mgr.all_steps() == []        # not written yet
    gate.set()
    mgr.wait()
    assert mgr._thread is None and mgr.all_steps() == [1]
    got = mgr.restore(1, {"x": torch.zeros(6)})
    assert torch.equal(got["x"], torch.arange(6, dtype=torch.float32))
    mgr.save(2, {"x": x}, block=True)   # written before it returns
    assert mgr._thread is None and mgr.all_steps() == [1, 2]
    mgr.save(3, {"x": x})
    mgr.save_flat(4, {"y": np.ones(2)})  # waits for step 3 first
    assert mgr.all_steps() == [3, 4]     # keep=2
    assert mgr.latest_step() == 4


def test_a_failed_background_write_raises_at_wait(tmp_path, monkeypatch):
    def broken(self, step, flat):
        raise OSError("disk full")
    monkeypatch.setattr(CheckpointManager, "_write", broken)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"x": torch.ones(2)})
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    mgr.wait()                          # raised once


def test_bf16_leaves_and_the_optimizer_state_round_trip(tmp_path):
    rng = np.random.default_rng(0)
    p = {"w": torch.from_numpy(rng.standard_normal((3, 4)).astype(
        np.float32)).to(torch.bfloat16), "b": torch.ones(4)}
    st = init_opt_state(p, OptimConfig(grad_compression="int8_ef"))
    st = st._replace(step=torch.tensor(7, dtype=torch.int32))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(7, {"params": p, "opt": st})
    template = {"params": {k: torch.zeros_like(v) for k, v in p.items()},
                "opt": init_opt_state(p, OptimConfig(
                    grad_compression="int8_ef"))}
    got = mgr.restore(7, template)
    assert isinstance(got["opt"], AdamState) and int(got["opt"].step) == 7
    for a, b in zip(tree_leaves(got), tree_leaves({"params": p, "opt": st})):
        assert a.dtype == b.dtype and torch.equal(a, b)
    with pytest.raises(ValueError, match="dtype mismatch"):
        mgr.restore(7, {"params": {k: torch.zeros(v.shape) for k, v in
                                   p.items()}, "opt": template["opt"]})
    assert M._to_numpy(p["w"]).dtype == np.uint16


def test_launcher_resumes_bitwise(tmp_path):
    a_dir, b_dir = str(tmp_path / "a"), str(tmp_path / "b")
    args = COMMON + ["--steps", "6", "--ckpt-every", "3"]
    a = T.main(args + ["--ckpt-dir", a_dir])
    assert CheckpointManager(a_dir).all_steps() == [3, 6]
    os.makedirs(b_dir)
    shutil.copy(os.path.join(a_dir, "ckpt_0000000003.npz"), b_dir)
    b = T.main(args + ["--ckpt-dir", b_dir])
    assert all(torch.equal(x, y)
               for x, y in zip(tree_leaves(a), tree_leaves(b)))
    c = T.main(args + ["--ckpt-dir", a_dir])   # at its end: no step runs
    assert all(torch.equal(x, y)
               for x, y in zip(tree_leaves(a), tree_leaves(c)))


def test_sigterm_checkpoints_and_exits(tmp_path, monkeypatch, capsys):
    real = T.make_train_step

    def step_then_signal(*a, **kw):
        fn = real(*a, **kw)
        calls = []

        def step(*args):
            out = fn(*args)
            calls.append(1)
            if len(calls) == 2:
                os.kill(os.getpid(), signal.SIGTERM)
            return out
        return step
    monkeypatch.setattr(T, "make_train_step", step_then_signal)
    old = signal.getsignal(signal.SIGTERM), signal.getsignal(signal.SIGUSR1)
    try:
        T.main(COMMON + ["--steps", "6", "--ckpt-every", "100",
                         "--ckpt-dir", str(tmp_path)])
    finally:
        signal.signal(signal.SIGTERM, old[0])
        signal.signal(signal.SIGUSR1, old[1])
    assert CheckpointManager(str(tmp_path)).all_steps() == [2]
    assert "preempted at step 2" in capsys.readouterr().out


def test_mesh_raises_and_the_loss_falls(capsys):
    with pytest.raises(NotImplementedError, match="item 9b"):
        T.main(COMMON + ["--mesh", "smoke"])
    T.main(["--arch", "llama3.2-3b", "--reduced", "--device", "cpu",
            "--steps", "12", "--batch", "4", "--seq", "32", "--lr", "3e-3",
            "--log-every", "1", "--dtype", "float32"])
    losses = [float(line.split("loss=")[1].split()[0])
              for line in capsys.readouterr().out.splitlines()
              if "loss=" in line]
    assert len(losses) == 12 and losses[-1] < losses[0]


def test_hpo_train_twin_on_cpu():
    s = hpo_train_torch.main(["--device", "cpu", "--trials", "7",
                              "--steps", "3", "--seq", "32"])
    ys = [t.y for t in s.trials]
    assert len(ys) == 7 and all(np.isfinite(ys))
    assert s.best().y == min(ys)


def test_hpo_service_twin_on_cpu():
    svc = hpo_service_torch.main(["--device", "cpu", "--trials", "5",
                                  "--steps", "2", "--seq", "32"])
    snap = svc.stats_snapshot()
    assert snap["svc_completed"] == 10
    for sampler in svc.fs.samplers:
        assert np.isfinite(sampler.best().y)

"""The port stands alone: ``repro_torch``, ``chip_smoke.py``,
``flash_ab.py``, ``gram_ab.py``, ``kvp_ab.py``, ``fleet_bits_probe.py``
and the example twins ``examples/*_torch.py`` import neither jax nor
anything of the JAX package ``repro``."""
import glob
import os
import pkgutil
import re
import subprocess
import sys
import textwrap

import pytest

pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "src", "repro_torch")
TWINS = sorted(glob.glob(os.path.join(REPO, "examples", "*_torch.py")))


def _sources():
    files = [os.path.join(REPO, f)
             for f in ("chip_smoke.py", "flash_ab.py", "gram_ab.py",
                       "kvp_ab.py", "fleet_bits_probe.py")] + TWINS
    for root, _, names in os.walk(PKG):
        files += [os.path.join(root, f) for f in names
                  if f.endswith((".py", ".cu", ".cuh"))]
    return files


def test_importing_every_module_loads_no_jax_and_no_repro():
    code = textwrap.dedent(f"""
        import importlib, pkgutil, sys
        REPO = {REPO!r}
        import repro_torch
        names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch.")]
        for name in names:
            importlib.import_module(name)
        sys.path.insert(0, REPO)
        import chip_smoke, flash_ab, gram_ab, kvp_ab  # noqa: F401
        import fleet_bits_probe  # noqa: F401
        sys.path.insert(0, REPO + "/examples")
        twins = {[os.path.basename(f)[:-3] for f in TWINS]!r}
        for name in twins:
            importlib.import_module(name)
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith(("jax.", "jaxlib"))
                     or m == "repro" or m.startswith("repro."))
        print(len(names), bad)
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    n, bad = out.stdout.strip().split(" ", 1)
    assert int(n) >= 20 and bad == "[]", out.stdout
    assert len(TWINS) == 5, TWINS


def test_no_source_names_jax_or_repro():
    pattern = re.compile(r"^\s*(import\s+(jax|repro)\b|from\s+(jax|repro)"
                         r"(\.|\s+import))", re.MULTILINE)
    offenders = []
    for path in _sources():
        with open(path, encoding="utf-8") as f:
            text = f.read()
        if pattern.search(text) or "import repro." in text \
                or "from repro." in text:
            offenders.append(os.path.relpath(path, REPO))
    assert not offenders, offenders
    assert len(_sources()) >= 20


def test_walk_finds_the_kernel_modules():
    import repro_torch
    names = {m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                  "repro_torch.")}
    assert {"repro_torch.kernels.matern.kernel",
            "repro_torch.kernels.matern.ops",
            "repro_torch.engine.engine",
            "repro_torch.bo.sampler",
            "repro_torch.kernels.flash.kernel",
            "repro_torch.kernels.kvp.ops",
            "repro_torch.models.lm",
            "repro_torch.models.moe",
            "repro_torch.models.rglru",
            "repro_torch.models.xlstm",
            "repro_torch.models.whisper",
            "repro_torch.serve.engine",
            "repro_torch.launch.serve",
            "repro_torch.engine.fleet",
            "repro_torch.bo.journal",
            "repro_torch.ckpt.manager",
            "repro_torch.core.acquisition",
            "repro_torch.core.lbfgsb",
            "repro_torch.core.mso",
            "repro_torch.gp.gpr",
            "repro_torch.data.synth",
            "repro_torch.train.optim",
            "repro_torch.train.step",
            "repro_torch.launch.train",
            "repro_torch.launch.shapes",
            "repro_torch.launch.dryrun",
            "repro_torch.launch.hlo_cost",
            "repro_torch.launch.mesh",
            "repro_torch.kernels.flash.cost"} <= names

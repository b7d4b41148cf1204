import os
import subprocess
import sys
import textwrap

import jax
import pytest

# BO-side numerics (GP Cholesky, L-BFGS-B trajectories) need f64; model
# tests pass explicit dtypes throughout so this is safe globally.
# NOTE: the 512-device dry-run flag is deliberately NOT set here — tests
# that need a mesh spawn subprocesses via the ``run_sub`` fixture below.
jax.config.update("jax_enable_x64", True)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_sub(code: str, devices: int = 8, timeout: int = 420) -> str:
    """Run ``code`` in a fresh interpreter with ``devices`` virtual CPU
    devices.  Mesh-requiring tests use this so the host-device-count flag
    never leaks into the rest of the suite (the dry-run isolation
    requirement); asserts a clean exit and returns captured stdout."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         capture_output=True, text=True, env=env,
                         timeout=timeout)
    assert out.returncode == 0, out.stderr[-4000:]
    return out.stdout


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips without one")


@pytest.fixture(name="run_sub")
def run_sub_fixture():
    """Fixture handle on :func:`run_sub` for mesh subprocess tests."""
    return run_sub

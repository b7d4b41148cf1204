"""The card's constants for the dry run's roofline, and the meshes.

Counterpart of ``repro/launch/mesh.py``.  The port runs on one card, so
its constants are those of one NVIDIA H100 80GB HBM3 (SXM) at its 700 W
power limit, from NVIDIA's data sheet (dense rates, no sparsity): the
numbers ``PERF.md`` §2 and ``chip_smoke.py``'s bounds use.  A card set
below 700 W runs slower under load; ``nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader`` says which.

The reference's meshes (``make_production_mesh``, ``make_smoke_mesh``,
``make_fleet_mesh``, ``use_mesh``) place a program on several devices;
the port has one card until ROADMAP queue A item 9b, so each raises.
"""
from __future__ import annotations

HBM_BYTES = 80e9                 # 80 GB of device memory
HBM_BW = 3.35e12                 # B/s
PEAK_FLOPS_BF16 = 989e12         # FLOP/s, tensor cores, dense
PEAK_FLOPS_F32 = 67e12           # FLOP/s outside the tensor cores


def _no_mesh(name: str):
    def fn(*args, **kwargs):
        raise NotImplementedError(
            f"{name}: the port runs on one card; meshes are ROADMAP queue "
            f"A item 9b")
    fn.__name__ = name
    fn.__doc__ = f"Raises: {name} waits for ROADMAP queue A item 9b."
    return fn


make_production_mesh = _no_mesh("make_production_mesh")
make_smoke_mesh = _no_mesh("make_smoke_mesh")
make_fleet_mesh = _no_mesh("make_fleet_mesh")
use_mesh = _no_mesh("use_mesh")

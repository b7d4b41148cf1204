"""The card's constants for the dry run's roofline, and the meshes.

Counterpart of ``repro/launch/mesh.py``.  The constants are those of one
NVIDIA H100 80GB HBM3 (SXM) at its 700 W power limit, from NVIDIA's data
sheet (dense rates, no sparsity): the numbers ``PERF.md`` §2 and
``chip_smoke.py``'s bounds use.  A card set below 700 W runs slower under
load; ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
says which.

A :class:`Mesh` is a flat list of ``torch.device``s with its axis names,
the counterpart of ``jax.sharding.Mesh``.  :func:`make_fleet_mesh` gives
the fleet's 1-D ``"study"`` mesh over the visible cards (or, asked with
``device="cpu"``, over virtual entries of the CPU, as the reference's
tests use forced host devices).  A mesh built directly may repeat a
card: one card then runs the sharded path with several shards.

The reference's LM meshes (``make_production_mesh``, ``make_smoke_mesh``,
``use_mesh``) place a model's tensor- and data-parallel program across
cards; they are the LM half of ROADMAP queue A item 9b, so each raises.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

HBM_BYTES = 80e9                 # 80 GB of device memory
HBM_BW = 3.35e12                 # B/s
PEAK_FLOPS_BF16 = 989e12         # FLOP/s, tensor cores, dense
PEAK_FLOPS_F32 = 67e12           # FLOP/s outside the tensor cores


class Mesh:
    """Devices laid out on named axes.  ``devices`` is flat, row-major
    over ``shape`` (default: one axis of ``len(devices)``); an entry may
    repeat a device."""

    def __init__(self, devices: Sequence, axis_names: Sequence[str] = (
            "study",), shape: Optional[Sequence[int]] = None):
        self.devices = tuple(torch.device(d) for d in devices)
        self.axis_names = tuple(axis_names)
        self.shape = ((len(self.devices),) if shape is None
                      else tuple(int(s) for s in shape))
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        if (len(self.shape) != len(self.axis_names)
                or math.prod(self.shape) != len(self.devices)):
            raise ValueError(
                f"mesh shape {self.shape} over axes {self.axis_names} does "
                f"not hold {len(self.devices)} devices")

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return (f"Mesh({[str(d) for d in self.devices]}, "
                f"axis_names={self.axis_names}, shape={self.shape})")


def make_fleet_mesh(n_devices: Optional[int] = None, axis: str = "study",
                    device=None) -> Mesh:
    """1-D mesh for the fleet ask plane: the study axis is embarrassingly
    parallel, so the fleet shards slot blocks over a single ``axis``
    spanning ``n_devices`` cards (default: every visible card).  A
    1-device fleet mesh is valid and bit for bit equal to running
    unsharded: the placement-independence invariant.

    ``device`` is the kind of device: ``None`` or ``"cuda"`` takes the
    first ``n_devices`` of ``torch.cuda.device_count()`` cards and raises
    without CUDA (never falling back to the CPU); ``"cpu"`` gives
    ``n_devices`` (default 1) virtual entries of the CPU."""
    kind = torch.device("cuda" if device is None else device).type
    if kind == "cpu":
        n = 1 if n_devices is None else int(n_devices)
        if n < 1:
            raise ValueError(f"fleet mesh needs n_devices >= 1, got {n}")
        return Mesh([torch.device("cpu")] * n, (axis,))
    if kind != "cuda":
        raise ValueError(f"fleet mesh over {kind!r} devices: use 'cuda' "
                         f"or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' for a "
                           "mesh of the CPU")
    count = torch.cuda.device_count()
    n = count if n_devices is None else int(n_devices)
    if not 1 <= n <= count:
        raise ValueError(f"fleet mesh needs 1 <= n_devices <= {count} "
                         f"visible devices, got {n}")
    return Mesh([torch.device("cuda", i) for i in range(n)], (axis,))


def _no_mesh(name: str):
    def fn(*args, **kwargs):
        raise NotImplementedError(
            f"{name}: the LM's meshes are the LM half of ROADMAP queue A "
            f"item 9b")
    fn.__name__ = name
    fn.__doc__ = f"Raises: {name} waits for ROADMAP queue A item 9b."
    return fn


make_production_mesh = _no_mesh("make_production_mesh")
make_smoke_mesh = _no_mesh("make_smoke_mesh")
use_mesh = _no_mesh("use_mesh")

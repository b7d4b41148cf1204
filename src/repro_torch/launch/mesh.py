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

The LM's meshes are a :class:`ProcessMesh`: the ranks of an initialized
``torch.distributed`` world laid out row-major over named axes ("data",
"model", and "pod" for the multi-pod layout), one process a rank, each
holding its own slice of every tensor on its own device.
:func:`make_smoke_mesh` builds one of any shape over the world,
:func:`make_production_mesh` the reference's (16, 16) and (2, 16, 16)
layouts, and :func:`use_mesh` installs one as the ambient mesh (the
counterpart of ``jax.set_mesh``) that the LM's layers, loss, train step
and optimizer read.  :func:`collective_backend` picks the backend from
the layout: NCCL with one rank a card, gloo where ranks share a card
(NCCL refuses two ranks of one communicator on one card) and on the CPU.
"""
from __future__ import annotations

import contextlib
import itertools
import math
import os
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import _MESH

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


def collective_backend(device=None, local_world: Optional[int] = None
                       ) -> str:
    """The backend a layout takes: "gloo" on the CPU and where more ranks
    of this host share its cards than it has cards (``local_world``:
    ``LOCAL_WORLD_SIZE``, else ``WORLD_SIZE``), "nccl" with one rank a
    card at most.  Never chosen by catching a failure."""
    kind = torch.device("cuda" if device is None else device).type
    if kind == "cpu":
        return "gloo"
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' for a "
                           "mesh of the CPU")
    if local_world is None:
        local_world = int(os.environ.get(
            "LOCAL_WORLD_SIZE", os.environ.get("WORLD_SIZE", "1")))
    return "nccl" if local_world <= torch.cuda.device_count() else "gloo"


def rank_device(device=None) -> torch.device:
    """This rank's device: ``cuda:(LOCAL_RANK % cards)`` (made current),
    or the CPU when asked with ``device="cpu"``; raises without CUDA
    otherwise, never falling back to the CPU."""
    kind = torch.device("cuda" if device is None else device).type
    if kind == "cpu":
        return torch.device("cpu")
    if kind != "cuda":
        raise ValueError(f"a mesh over {kind!r} devices: use 'cuda' or "
                         f"'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' for a "
                           "mesh of the CPU")
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    idx = local % torch.cuda.device_count()
    torch.cuda.set_device(idx)
    return torch.device("cuda", idx)


class ProcessMesh:
    """The ranks of the initialized ``torch.distributed`` world laid out
    row-major over ``shape`` with ``axis_names``; this process is rank
    ``rank`` at ``coords`` (axis → index) on ``device``.  ``groups[a]``
    is the process group of the ranks that differ from this one along
    axis ``a`` only (an axis of one rank has none).  Every rank builds
    every group, in the same order, members or not, as ``new_group``
    asks; a rank that skipped one would hang the others."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 device=None):
        if not dist.is_initialized():
            raise RuntimeError("a process mesh needs an initialized process "
                               "group (torch.distributed.init_process_group)")
        self.shape = tuple(int(s) for s in shape)
        self.axis_names = tuple(axis_names)
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.shape} over axes "
                             f"{self.axis_names}")
        world = dist.get_world_size()
        if math.prod(self.shape) != world:
            raise ValueError(f"mesh shape {self.shape} needs "
                             f"{math.prod(self.shape)} ranks; the world "
                             f"has {world}")
        self.rank = dist.get_rank()
        self.backend = str(dist.get_backend())
        self.device = rank_device(device)
        flat = list(itertools.product(*(range(s) for s in self.shape)))
        self.coords: Dict[str, int] = dict(zip(self.axis_names,
                                               flat[self.rank]))
        self.groups: Dict[str, object] = {}
        self.members: Dict[str, Tuple[int, ...]] = {}
        for i, a in enumerate(self.axis_names):
            if self.shape[i] == 1:
                continue
            rest = [range(s) if j != i else range(1)
                    for j, s in enumerate(self.shape)]
            for base in itertools.product(*rest):
                ranks = []
                for k in range(self.shape[i]):
                    c = list(base)
                    c[i] = k
                    ranks.append(flat.index(tuple(c)))
                group = dist.new_group(ranks)
                if self.rank in ranks:
                    self.groups[a], self.members[a] = group, tuple(ranks)

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def sizes(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.shape))

    @property
    def axis_sizes(self) -> Tuple[int, ...]:
        return self.shape

    @property
    def empty(self) -> bool:
        return False

    def axis_size(self, axis: str) -> int:
        """Ranks along ``axis``; 1 for an axis the mesh lacks."""
        return self.sizes.get(axis, 1)

    def __repr__(self) -> str:
        return (f"ProcessMesh(shape={self.shape}, axes={self.axis_names}, "
                f"rank={self.rank}, coords={self.coords}, "
                f"device={self.device}, backend={self.backend})")


def make_smoke_mesh(shape=(2, 2), axes=("data", "model"), device=None
                    ) -> ProcessMesh:
    """A mesh of ``shape`` over ``axes`` spanning the whole initialized
    world (whose size must be ``prod(shape)``): the smoke and test
    meshes, on the card (one device a rank, ``cuda:(LOCAL_RANK %
    cards)``) or, with ``device="cpu"``, on the CPU."""
    return ProcessMesh(shape, axes, device)


def make_production_mesh(multi_pod: bool = False, device=None
                         ) -> ProcessMesh:
    """The reference's layouts: one pod (16, 16) over ("data", "model"),
    256 ranks; multi-pod (2, 16, 16) over ("pod", "data", "model"), 512
    ranks, "pod" extending data parallelism.  Raises a ValueError naming
    the world's size on any other world."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    world = dist.get_world_size() if dist.is_initialized() else None
    if world != math.prod(shape):
        raise ValueError(f"make_production_mesh(multi_pod={multi_pod}) "
                         f"needs a world of {math.prod(shape)} ranks; it "
                         f"has {world}")
    return ProcessMesh(shape, axes, device)


@contextlib.contextmanager
def use_mesh(mesh: Optional[ProcessMesh]):
    """Install ``mesh`` as the ambient mesh for the block (None: no
    mesh), the counterpart of ``jax.set_mesh``; every thread of the
    process sees it (autograd's device threads included)."""
    outer, _MESH[0] = _MESH[0], mesh
    try:
        yield mesh
    finally:
        _MESH[0] = outer

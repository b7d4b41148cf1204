"""Checkpointing: atomic, synchronous saves of flat arrays.

Counterpart of ``repro/ckpt/manager.py``, host-only.  The reference walks
a ``jax.tree_util`` tree; this one walks nested dicts, lists and tuples of
tensors, numpy arrays and scalars, and writes the same flat ``.npz`` zip
under the same keys (a dict key ``k`` is ``['k']``, a sequence index
``i`` is ``[i]``, joined with ``/``), so either package reads the
other's checkpoints.

* **Atomic** — write to ``<dir>/.tmp_<step>_<pid>`` then ``os.replace``
  into place; a crash mid-save never corrupts the latest checkpoint, and
  the leftover tmp file is swept at the next start.
* **Checked** — a restore refuses a shape or dtype that differs from its
  template; :meth:`CheckpointManager.latest_step` skips corrupt files.
* **Preemption** — :func:`install_sigterm_handler` flips a flag the
  caller polls at a safe boundary.
"""
from __future__ import annotations

import os
import re
import signal
import threading
import warnings
import zipfile
from typing import Any, Dict, List, Optional

import numpy as np
import torch


def _key(part) -> str:
    return f"[{part!r}]" if isinstance(part, str) else f"[{part}]"


def _walk(tree, prefix: str, out: Dict[str, Any]) -> None:
    if isinstance(tree, dict):
        items = sorted(tree.items())
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    else:
        out[prefix] = tree
        return
    for k, v in items:
        _walk(v, _join(prefix, k), out)


def _join(prefix: str, part) -> str:
    return _key(part) if not prefix else f"{prefix}/{_key(part)}"


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten(tree) -> Dict[str, np.ndarray]:
    leaves: Dict[str, Any] = {}
    _walk(tree, "", leaves)
    return {k: _to_numpy(v) for k, v in leaves.items()}


def _unflatten_into(template, flat: Dict[str, np.ndarray], prefix: str = ""):
    """``template``'s structure with its leaves read from ``flat``: a
    tensor leaf comes back as a tensor on the template's device."""
    if isinstance(template, dict):
        return {k: _unflatten_into(v, flat, _join(prefix, k))
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        vals = [_unflatten_into(v, flat, _join(prefix, i))
                for i, v in enumerate(template)]
        return type(template)(vals)
    if prefix not in flat:
        raise KeyError(f"checkpoint missing leaf {prefix}")
    val = flat[prefix]
    ref = _to_numpy(template)
    if tuple(val.shape) != tuple(ref.shape):
        raise ValueError(f"shape mismatch at {prefix}: ckpt {val.shape} vs "
                         f"template {ref.shape}")
    if val.dtype != ref.dtype:
        # a silent cast (f64 into an f32 template or back) would break
        # the bit-exactness the fleet's recovery relies on: refuse
        raise ValueError(f"dtype mismatch at {prefix}: ckpt {val.dtype} vs "
                         f"template {ref.dtype}")
    if isinstance(template, torch.Tensor):
        return torch.from_numpy(np.array(val)).to(template.device)
    return val


class CheckpointManager:
    """Saves are synchronous (the reference's background thread has no
    caller here): a step is on disk when ``save`` returns."""

    def __init__(self, directory: str, *, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        # a crash mid-save leaves a .tmp_* behind (the os.replace never
        # ran); it is garbage by construction: sweep it
        for f in os.listdir(directory):
            if f.startswith(".tmp_"):
                try:
                    os.remove(os.path.join(directory, f))
                except OSError:
                    pass

    # ------------------------------------------------------------- paths
    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"ckpt_{step:010d}.npz")

    def all_steps(self) -> List[int]:
        out = []
        for f in os.listdir(self.dir):
            m = re.match(r"ckpt_(\d+)\.npz$", f)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def _is_valid(self, step: int) -> bool:
        """A checkpoint counts only if its zip container is intact."""
        try:
            with np.load(self._path(step)) as z:
                z.files
            return True
        except (OSError, ValueError, zipfile.BadZipFile, EOFError):
            return False

    def latest_step(self) -> Optional[int]:
        """Newest restorable step: corrupt or partial checkpoints are
        skipped with a warning instead of poisoning recovery."""
        for step in reversed(self.all_steps()):
            if self._is_valid(step):
                return step
            warnings.warn(f"skipping corrupt checkpoint {self._path(step)}")
        return None

    # -------------------------------------------------------------- save
    def save(self, step: int, tree) -> None:
        """Save ``tree`` (nested dicts/lists/tuples of tensors, arrays or
        scalars) under the reference's flat keys."""
        self.save_flat(step, _flatten(tree))

    def _gc(self):
        for s in self.all_steps()[:-self.keep]:
            try:
                os.remove(self._path(s))
            except OSError:
                pass

    # ------------------------------------------------------- flat dicts
    def save_flat(self, step: int, flat: Dict[str, np.ndarray]) -> None:
        """Save a flat ``{name: array}`` dict (no template needed to load
        it back: the study-journal snapshot path)."""
        tmp = os.path.join(self.dir, f".tmp_{step}_{os.getpid()}")
        with open(tmp, "wb") as f:
            np.savez(f, **{k: np.asarray(v) for k, v in flat.items()})
        os.replace(tmp, self._path(step))
        self._gc()

    def load_flat(self, step: int) -> Dict[str, np.ndarray]:
        with np.load(self._path(step)) as z:
            return {k: z[k] for k in z.files}

    # ----------------------------------------------------------- restore
    def restore(self, step: int, template):
        """Restore into ``template``'s structure (shapes and dtypes must
        match; tensors land on the template's devices)."""
        return _unflatten_into(template, self.load_flat(step))


# ---------------------------------------------------------------------------
# preemption handling
# ---------------------------------------------------------------------------

class PreemptionFlag:
    def __init__(self):
        self._evt = threading.Event()

    def set(self, *_):
        self._evt.set()

    @property
    def triggered(self) -> bool:
        return self._evt.is_set()


def install_sigterm_handler() -> PreemptionFlag:
    flag = PreemptionFlag()
    signal.signal(signal.SIGTERM, flag.set)
    signal.signal(signal.SIGUSR1, flag.set)
    return flag

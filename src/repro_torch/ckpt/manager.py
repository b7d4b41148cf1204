"""Checkpointing: atomic, async saves of flat arrays.

Counterpart of ``repro/ckpt/manager.py``.  The reference walks
a ``jax.tree_util`` tree; this one walks nested dicts, lists and tuples of
tensors, numpy arrays and scalars, and writes the same flat ``.npz`` zip
under the same keys (a dict key ``k`` is ``['k']``, a sequence index
``i`` is ``[i]``, joined with ``/``), so either package reads the
other's float and integer checkpoints (a bfloat16 tensor is saved as its
raw bits, uint16, and restored into a bfloat16 template).

* **Atomic** — write to ``<dir>/.tmp_<step>_<pid>`` then ``os.replace``
  into place; a crash mid-save never corrupts the latest checkpoint, and
  the leftover tmp file is swept at the next start.
* **Async** — :meth:`CheckpointManager.save` copies the tree to the host
  synchronously (device tensors included: the caller may overwrite them
  in place right after) and writes the file on a daemon thread, so the
  training loop keeps stepping; one save is in flight at a time,
  :meth:`~CheckpointManager.wait` joins it (so do ``latest_step``,
  ``load_flat`` and ``restore``: a read sees every save made before it),
  and ``block=True`` (or ``async_save=False``) writes before returning.
  :meth:`save_flat` (the fleet journal's snapshots) waits first and
  writes synchronously.
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
    """A host copy of ``leaf`` (a tensor's never shares its storage, so
    the caller may update the tensor in place while a save is in flight);
    a bfloat16 tensor as its raw 16 bits (uint16), which numpy holds."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(leaf)


def _spec(leaf):
    """(shape, numpy dtype) a leaf is saved with, without copying it."""
    if isinstance(leaf, torch.Tensor):
        dt = (np.dtype(np.uint16) if leaf.dtype == torch.bfloat16 else
              torch.empty(0, dtype=leaf.dtype).numpy().dtype)
        return tuple(leaf.shape), dt
    a = np.asarray(leaf)
    return a.shape, a.dtype


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
        # a NamedTuple (the optimizer state) takes its fields positionally
        return (type(template)(*vals) if hasattr(template, "_fields")
                else type(template)(vals))
    if prefix not in flat:
        raise KeyError(f"checkpoint missing leaf {prefix}")
    val = flat[prefix]
    shape, dtype = _spec(template)
    if tuple(val.shape) != shape:
        raise ValueError(f"shape mismatch at {prefix}: ckpt {val.shape} vs "
                         f"template {shape}")
    if val.dtype != dtype:
        # a silent cast (f64 into an f32 template or back) would break
        # the bit-exactness the fleet's recovery relies on: refuse
        raise ValueError(f"dtype mismatch at {prefix}: ckpt {val.dtype} vs "
                         f"template {dtype}")
    if isinstance(template, torch.Tensor):
        arr = np.array(val)
        t = (torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
             if template.dtype == torch.bfloat16 else torch.from_numpy(arr))
        return t.to(template.device)
    return val


class CheckpointManager:
    """A directory of ``ckpt_<step>.npz`` files, the newest ``keep`` kept.
    ``save`` writes on a background thread unless ``async_save`` is False
    or the call blocks (the training launcher's saves); ``save_flat``
    always writes before it returns."""

    def __init__(self, directory: str, *, keep: int = 3,
                 async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None
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
        """Newest restorable step (after the save in flight): corrupt or
        partial checkpoints are skipped with a warning instead of
        poisoning recovery."""
        self.wait()
        for step in reversed(self.all_steps()):
            if self._is_valid(step):
                return step
            warnings.warn(f"skipping corrupt checkpoint {self._path(step)}")
        return None

    # -------------------------------------------------------------- save
    def save(self, step: int, tree, *, block: bool = False) -> None:
        """Save ``tree`` (nested dicts/lists/tuples of tensors, arrays or
        scalars) under the reference's flat keys: copied to the host now,
        written on a daemon thread (after any save still in flight) unless
        ``block`` or the manager is synchronous."""
        flat = _flatten(tree)            # sync device→host copy
        self.wait()                      # one in-flight save at a time
        if self.async_save and not block:
            self._thread = threading.Thread(target=self._write_caught,
                                            args=(step, flat), daemon=True)
            self._thread.start()
        else:
            self._write(step, flat)

    def wait(self) -> None:
        """Join the save in flight, if any, and raise what its write
        raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _write_caught(self, step: int, flat: Dict[str, np.ndarray]) -> None:
        try:
            self._write(step, flat)
        except Exception as e:          # raised again by wait()
            self._error = e

    def _write(self, step: int, flat: Dict[str, np.ndarray]) -> None:
        tmp = os.path.join(self.dir, f".tmp_{step}_{os.getpid()}")
        with open(tmp, "wb") as f:
            np.savez(f, **{k: np.asarray(v) for k, v in flat.items()})
        os.replace(tmp, self._path(step))
        self._gc()

    def _gc(self):
        for s in self.all_steps()[:-self.keep]:
            try:
                os.remove(self._path(s))
            except OSError:
                pass

    # ------------------------------------------------------- flat dicts
    def save_flat(self, step: int, flat: Dict[str, np.ndarray]) -> None:
        """Synchronously save a flat ``{name: array}`` dict (no template
        needed to load it back: the study-journal snapshot path), after
        any save in flight."""
        self.wait()
        self._write(step, flat)

    def load_flat(self, step: int) -> Dict[str, np.ndarray]:
        """The flat arrays of ``step``, after the save in flight."""
        self.wait()
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

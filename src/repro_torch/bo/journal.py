"""The write-ahead study journal — durable ask/tell history for the fleet.

Counterpart of ``repro/bo/journal.py``, host-only and kept byte for byte
in its on-disk format, so a journal written by either package replays in
the other.  The fleet serves untrusted, long-lived traffic (ROADMAP item 3): clients
die mid-trial, processes get preempted mid-suggest, and a crash must not
lose the studies it was serving.  This module is the durability layer
under :class:`repro_torch.bo.sampler.FleetSampler`:

* **append-only** — one record per line, written before the state change
  it describes takes effect (WAL discipline: an ask is journaled before
  the suggestion is handed out, a tell before it enters GP data);
* **fsync'd** — every append flushes and fsyncs by default, so a crash
  loses at most the record being written, never an acknowledged one;
* **checksummed** — each line carries a CRC-32 of its JSON payload plus a
  monotonically increasing sequence number; on open, the tail is scanned
  and the first corrupt, partial, or out-of-sequence record (the
  signature of a crash mid-append) truncates the file there — the same
  "atomic or absent" semantics :mod:`repro_torch.ckpt.manager` gives whole
  checkpoints via tmp-file + ``os.replace``.

Recovery (:meth:`FleetSampler.recover`) replays the journal through the
normal sampler/scheduler paths: completed tells re-enter via the existing
out-of-order observation sync, studies re-admit through the slot
scheduler, and device factors are rebuilt by the first post-recovery full
refit — exactly like a post-migration suggest, so recovery adds NO new
compiled programs.  :class:`repro_torch.ckpt.manager.CheckpointManager`
snapshots (``save_flat``) bound how much journal has to be replayed.

Record payloads are plain dicts with an ``"op"`` key; the journal is
schema-agnostic (the sampler owns the vocabulary).  A fault injector (see
``tests/faults.py``) may hook ``append`` to simulate a crash at an exact
journal offset — it writes a *partial* record and raises
:class:`InjectedCrash`, which is precisely the on-disk state a real kill
mid-append leaves behind.
"""
from __future__ import annotations

import json
import os
import warnings
import zlib
from typing import Any, Dict, List, Optional

from repro_torch.obs.trace import get as _obs_get

JOURNAL_NAME = "journal.log"


class InjectedCrash(RuntimeError):
    """Raised by a fault injector to simulate a process kill at an exact
    journal offset (after a deliberately partial record write)."""


class StudyJournal:
    """Append-only, fsync'd, checksummed per-fleet study journal."""

    def __init__(self, directory: str, *, sync: bool = True,
                 fault_injector: Optional[Any] = None):
        self.dir = directory
        self.sync = sync
        self.fault_injector = fault_injector
        os.makedirs(directory, exist_ok=True)
        self.path = os.path.join(directory, JOURNAL_NAME)
        # resume-safe: scan any existing log (truncating a torn tail) so
        # appends continue the sequence instead of corrupting it
        records, truncated = self._scan_and_truncate(self.path)
        self.seq = records[-1]["seq"] + 1 if records else 0
        self.truncated_bytes = truncated
        self._f = open(self.path, "ab")

    # ------------------------------------------------------------- append
    def append(self, record: Dict[str, Any]) -> int:
        """Durably append one record; returns its sequence number.

        The record is on disk (flushed + fsync'd) before this returns —
        callers rely on WAL ordering: journal first, then mutate state.
        """
        if self._f is None:
            raise ValueError("journal is closed")
        seq = self.seq
        payload = json.dumps({"seq": seq, **record},
                             separators=(",", ":"))
        data = self._encode(payload)
        fi = self.fault_injector
        if fi is not None and fi.should_kill(seq):
            # a real kill mid-append leaves a torn record: write a
            # prefix, make it durable, and die
            self._f.write(data[: max(1, len(data) // 2)])
            self._f.flush()
            os.fsync(self._f.fileno())
            raise InjectedCrash(f"injected crash at journal seq {seq}")
        tr = _obs_get()
        t0 = tr.now_us() if tr is not None else 0.0
        self._f.write(data)
        self._f.flush()
        if self.sync:
            os.fsync(self._f.fileno())
        if tr is not None:
            # the durability cost of WAL discipline, per record: write +
            # flush (+ fsync when sync=True) as one timeline span
            tr.record_span("journal.append", t0, tr.now_us() - t0,
                           op=record.get("op", "?"), seq=seq,
                           n_bytes=len(data), fsync=self.sync)
        self.seq = seq + 1
        return seq

    @staticmethod
    def _encode(payload: str) -> bytes:
        crc = zlib.crc32(payload.encode())
        return f"{crc:08x} {payload}\n".encode()

    def close(self) -> None:
        if self._f is not None:
            self._f.flush()
            os.fsync(self._f.fileno())
            self._f.close()
            self._f = None

    # ------------------------------------------------------------- replay
    def replay(self) -> List[Dict[str, Any]]:
        """All intact records, in order (the truncation already happened
        at open time; this is a pure read)."""
        records, _ = self._scan_and_truncate(self.path, truncate=False)
        return records

    @staticmethod
    def _scan_and_truncate(path: str, truncate: bool = True
                           ) -> "tuple[List[Dict[str, Any]], int]":
        """Read records up to the first corrupt/partial/out-of-sequence
        line; truncate the file there (a crash mid-append must look like
        the append never happened).  Returns (records, bytes_dropped)."""
        if not os.path.exists(path):
            return [], 0
        records: List[Dict[str, Any]] = []
        good_end = 0
        with open(path, "rb") as f:
            data = f.read()
        pos = 0
        while pos < len(data):
            nl = data.find(b"\n", pos)
            if nl < 0:
                break                            # partial tail record
            line = data[pos:nl]
            rec = StudyJournal._decode(line, expect_seq=len(records))
            if rec is None:
                break                            # corrupt from here on
            records.append(rec)
            good_end = nl + 1
            pos = nl + 1
        dropped = len(data) - good_end
        if dropped and truncate:
            warnings.warn(
                f"journal {path}: dropping {dropped} bytes of "
                f"corrupt/partial tail after record {len(records) - 1}")
            with open(path, "r+b") as f:
                f.truncate(good_end)
        return records, dropped

    @staticmethod
    def _decode(line: bytes, expect_seq: int) -> Optional[Dict[str, Any]]:
        try:
            crc_hex, payload = line.split(b" ", 1)
            if int(crc_hex, 16) != zlib.crc32(payload):
                return None
            rec = json.loads(payload)
        except (ValueError, json.JSONDecodeError):
            return None
        if rec.get("seq") != expect_seq:
            return None                # a rewind/gap is corruption too
        return rec

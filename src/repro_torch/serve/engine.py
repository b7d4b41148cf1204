"""Batched serving engine: greedy decode with continuous batching.

Counterpart of ``repro/serve/engine.py``, with the same slot logic: a
fixed batch of decode slots; when a sequence finishes (EOS or max length)
its slot is refilled from the queue at the next step boundary.  Every step
is ONE decode step over the full slot batch with *per-slot positions*:
idle slots carry position −1 and their cache writes land in the reserved
trash slot, so heterogeneous slot progress never corrupts live entries.
Prompts are fed one token a step through the same decode step, each slot
from its own offset; ``prefill_chunk`` caps the prefill steps a ``step()``
call may run.

The engine owns its decode cache (a KV cache; for the hybrid family
recurrent states and local-window rings; for ssm the mLSTM and sLSTM
states), preallocated on the parameters' device; ``stats["cache_bytes"]`` is its size, every nested leaf.  The
step is a :class:`~repro_torch.engine.cache.CountingJit` program, so
``stats["compiles"]`` counts its input signatures and must stay 1 in
steady state.  ``stats["flash_launches"]`` counts the flash-attention
kernel launches the steps made (one per attention layer per step on the
card, so 0 for ssm, and 0 on the CPU).  The encoder-decoder (whisper) is
refused, as in the reference: it runs through ``models/whisper.py``.  The greedy argmax runs on the device; only the slots' next
token ids come back to the host.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.engine.cache import CountingJit
from repro_torch.kernels.flash import kernel as flash
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig


@dataclass
class Request:
    uid: int
    prompt: np.ndarray               # (prompt_len,) int32
    max_new_tokens: int = 32
    out_tokens: List[int] = field(default_factory=list)
    done: bool = False


class ServeEngine:
    def __init__(self, params, cfg: ModelConfig, *, slots: int = 8,
                 max_len: int = 512, eos_id: int = -1,
                 prefill_chunk: Optional[int] = None):
        if cfg.family == "encdec":
            raise NotImplementedError(
                "engine serves decoder-only archs; whisper uses "
                "whisper.decode_step directly")
        self.params = params
        self.cfg = cfg
        self.slots = slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.prefill_chunk = prefill_chunk
        self.device = params["embed"]["tok"].device
        self.cache = lm.init_cache(cfg, slots, max_len, device=self.device)
        self.positions = np.zeros((slots,), np.int64)
        self.active: List[Optional[Request]] = [None] * slots
        self.queue: List[Request] = []
        # the parameters are fixed for the engine's life, so the program's
        # signature is that of (tokens, cache, positions)
        self._step_fn = CountingJit(
            lambda t, c, i: lm.decode_step(params, cfg, t, c, i),
            name="decode_step")
        self._prefilling: set = set()     # slots mid-prefill (per-slot pos)
        self.stats: Dict[str, Any] = {"steps": 0, "tokens": 0, "wall": 0.0,
                                      "compiles": 0, "flash_launches": 0,
                                      "cache_bytes": lm.cache_bytes(
                                          self.cache)}

    # ---------------------------------------------------------------- api
    def submit(self, req: Request):
        self.queue.append(req)

    def _batched_step(self, toks: np.ndarray, pos: np.ndarray) -> np.ndarray:
        """One decode step; pos < 0 marks idle rows (trash-slot writes).
        Returns each slot's greedy next token."""
        t0 = time.perf_counter()
        ids = torch.from_numpy(np.concatenate([toks[:, 0], pos]).astype(
            np.int32)).to(self.device)
        launched = flash.LAUNCHES["flash_attention_fwd"]
        with torch.no_grad():
            logits, self.cache = self._step_fn(
                ids[:self.slots, None], self.cache, ids[self.slots:])
            nxt = torch.argmax(logits, -1).cpu().numpy()
        self.stats["wall"] += time.perf_counter() - t0
        self.stats["steps"] += 1
        self.stats["compiles"] = self._step_fn.n_compiles
        self.stats["flash_launches"] += (flash.LAUNCHES["flash_attention_fwd"]
                                         - launched)
        return nxt

    def _fill_slots(self):
        """Admit queued requests, then advance prefill for every slot
        still prefilling — each from its own per-slot offset
        (``positions[s]``), so slots admitted at different step
        boundaries share prefill steps without anyone restarting at
        token 0 (idle/established slots ride along masked).  With
        ``prefill_chunk`` set, at most that many prefill steps run per
        call and unfinished slots stay in ``self._prefilling``, resuming
        from their offsets at the next boundary."""
        for s in range(self.slots):
            if self.active[s] is None and self.queue:
                req = self.queue.pop(0)
                self.active[s] = req
                self.positions[s] = 0
                self.cache = lm.reset_slot(self.cfg, self.cache, s)
                if len(req.prompt) > 1:
                    self._prefilling.add(s)
        budget = self.prefill_chunk
        while self._prefilling and (budget is None or budget > 0):
            toks = np.zeros((self.slots, 1), np.int32)
            pos = np.full((self.slots,), -1, np.int64)
            done = []
            for s in self._prefilling:
                prompt = self.active[s].prompt
                i = int(self.positions[s])          # per-slot offset
                toks[s, 0] = int(prompt[i])
                pos[s] = i
                self.positions[s] = i + 1
                if i + 1 >= len(prompt) - 1:        # last prompt token is
                    done.append(s)                  # fed by the decode step
            self._batched_step(toks, pos)
            for s in done:
                self._prefilling.discard(s)
            if budget is not None:
                budget -= 1

    def step(self) -> int:
        """One synchronized decode step over all ready slots (mid-prefill
        slots keep prefilling instead); returns #tokens."""
        self._fill_slots()
        act = [s for s in range(self.slots)
               if self.active[s] is not None and s not in self._prefilling]
        if not act:
            return 0
        toks = np.zeros((self.slots, 1), np.int32)
        pos = np.full((self.slots,), -1, np.int64)
        for s in act:
            req = self.active[s]
            toks[s, 0] = req.out_tokens[-1] if req.out_tokens else \
                int(req.prompt[-1])
            pos[s] = self.positions[s]
        nxt = self._batched_step(toks, pos)
        emitted = 0
        for s in act:
            req = self.active[s]
            req.out_tokens.append(int(nxt[s]))
            self.positions[s] += 1
            emitted += 1
            if (len(req.out_tokens) >= req.max_new_tokens
                    or int(nxt[s]) == self.eos_id
                    or self.positions[s] >= self.max_len - 1):
                req.done = True
                self.active[s] = None
        self.stats["tokens"] += emitted
        return emitted

    def run_until_drained(self, max_steps: int = 10_000) -> List[Request]:
        finished: List[Request] = []
        for _ in range(max_steps):
            if not self.queue and all(a is None for a in self.active):
                break
            before = list(self.active)
            self.step()
            for a in before:
                if a is not None and a.done:
                    finished.append(a)
        return finished

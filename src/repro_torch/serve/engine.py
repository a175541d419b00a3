"""Serving engine: batched decode with CONTINUOUS BATCHING — requests
join/leave slots at step boundaries; per-slot positions flow into the
decode step (scalar-or-(B,) position support in the attention caches).

The port of ``repro.serve.engine``. The engine drives ``decode_step``;
prefill feeds prompt tokens through the same cached path (functionally
exact), and the admit / co-advance / commit logic is the JAX engine's line
for line. It runs on the card unless ``device="cpu"`` is given, and raises
where there is no card. The multi-tenant fleet and ``collective_report``
(the autotuner's) wait for later slices.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.models import model as M


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray          # (len,) int32
    max_new_tokens: int
    out: list = dataclasses.field(default_factory=list)
    done: bool = False


class Engine:
    def __init__(self, cfg, params, batch_slots: int, max_seq: int, device="cuda"):
        device = M._device(device)
        where = params["embed"]["table"].device
        if where.type != device.type or device.index not in (None, where.index):
            raise ValueError(f"the parameters lie on {where}, not on the engine's {device}")
        self.device = where
        self.cfg = cfg
        self.params = params
        self.slots = batch_slots
        self.max_seq = max_seq
        self.cache = M.init_cache(cfg, batch_slots, max_seq, dtype=torch.float32,
                                  device=self.device)
        self.positions = np.zeros(batch_slots, np.int32)  # next write index
        self.pending_tok = np.zeros(batch_slots, np.int32)
        self.slot_req: dict[int, Request] = {}
        self.steps_run = 0
        self.tokens_out = 0  # decoded (committed) tokens, for tokens/s

    @property
    def free_slots(self):
        return [s for s in range(self.slots) if s not in self.slot_req]

    # ------------------------------------------------------------- admit
    def admit(self, req: Request) -> bool:
        """Seat ``req`` in a free slot and prefill its prompt.

        CO-ADVANCE SEMANTICS (as in the JAX engine): prefill feeds the
        prompt through the same batched decode path, one engine step per
        prompt token, and every OTHER active slot DECODES during those
        steps — continuous batching has no prefill stall, so the tokens the
        other slots emit while a prompt streams in are real output,
        identical to what they would have produced solo, and they count
        against those requests' ``max_new_tokens`` budgets exactly like any
        decoded token (a request can even finish mid-prefill; its slot
        frees for the next ``admit``). Prefill steps are NOT charged to the
        admitted request's budget — its ``out`` stays empty until the first
        decode step after admission.

        A prompt longer than ``max_seq`` raises ``ValueError`` before
        anything changes: its cache writes would fall past the cache. (The
        JAX engine drops those writes and answers all the same.)
        """
        if len(req.prompt) > self.max_seq:
            raise ValueError(f"request {req.rid}: a prompt of {len(req.prompt)} tokens does not "
                             f"fit the engine's max_seq of {self.max_seq}")
        free = self.free_slots
        if not free:
            return False
        slot = free[0]
        self.slot_req[slot] = req
        self.positions[slot] = 0
        # prefill: feed prompt tokens through the cached decode path; the
        # other slots advance with their own pending tokens (no stalls).
        for tok in req.prompt[:-1]:
            self.pending_tok[slot] = int(tok)
            self._advance(decode_slots=[s for s in self.slot_req if s != slot])
        self.pending_tok[slot] = int(req.prompt[-1])
        return True

    # -------------------------------------------------------------- step
    def _forward(self) -> np.ndarray:
        """One batched model forward over all slots. Returns host logits
        (slots, vocab) in float32 and updates ``self.cache``."""
        batch = {"token": torch.from_numpy(self.pending_tok).to(self.device)}
        positions = torch.from_numpy(self.positions).to(self.device)
        logits, self.cache = M.decode_step(self.params, self.cache, batch, positions, self.cfg)
        return logits.float().cpu().numpy()

    def _advance(self, decode_slots):
        return self._commit(self._forward(), decode_slots)

    def _commit(self, logits, decode_slots):
        """Book one forward's results: bump positions, argmax-append for the
        decoding slots, retire finished requests and free their slots."""
        self.steps_run += 1
        self.positions[list(self.slot_req)] += 1
        for slot in decode_slots:
            req = self.slot_req[slot]
            nxt = int(np.argmax(logits[slot]))
            req.out.append(nxt)
            self.tokens_out += 1
            self.pending_tok[slot] = nxt
            if len(req.out) >= req.max_new_tokens or self.positions[slot] >= self.max_seq - 1:
                req.done = True
                del self.slot_req[slot]
        return logits

    def step(self):
        """One decode step for every active slot (batched)."""
        if not self.slot_req:
            return
        self._advance(decode_slots=list(self.slot_req))

    def run_to_completion(self, max_steps=4096):
        for _ in range(max_steps):
            if not self.slot_req:
                break
            self.step()

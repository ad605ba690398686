"""Batched LM serving engine: prefill + decode with continuous-batching-lite.

The port of ``src/repro/serve/engine.py``, with its behaviour: slots hold
independent requests; when a slot finishes, every live request is
left-padded with token 0 (no attention mask for the pads) and re-prefilled
into a fresh cache together with the newly admitted ones, then decoding
resumes. Sampling is greedy ``argmax`` whatever a request's
``temperature``.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.model import Model, decode_step, init_cache, prefill


@dataclasses.dataclass
class Request:
    """One prompt and its generated tokens."""
    prompt: np.ndarray            # (S,) int32
    max_new_tokens: int = 32
    temperature: float = 0.0
    out_tokens: list = dataclasses.field(default_factory=list)
    done: bool = False


class ServeEngine:
    """Runs requests through ``batch_slots`` slots of one ``Model`` on
    ``device`` (``None``: the CUDA device; raises without one). The model
    is moved there if it is elsewhere."""

    def __init__(self, model: Model, batch_slots: int = 4,
                 max_len: int = 512, eos_id: int | None = None,
                 device=None):
        if model.cfg.embed_inputs:
            raise ValueError("serve engine drives token models")
        self.device = resolve_device(device)
        self.cfg = model.cfg
        self.model = model.to(self.device)
        self.slots = batch_slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.last_stats: dict = {}

    def generate(self, requests: list[Request]) -> list[Request]:
        """Run all requests to completion with continuous slot refill."""
        queue = list(requests)
        active: list[Request | None] = [None] * self.slots
        t_start = time.perf_counter()
        stats = {"prefills": 0, "decode_steps": 0}

        while any(a is not None and not a.done for a in active) or queue:
            # Refill empty slots: batch the pending prompts together.
            for idx in range(self.slots):
                if active[idx] is None or active[idx].done:
                    active[idx] = queue.pop(0) if queue else None
            live = [r for r in active if r is not None and not r.done]
            if not live:
                break
            # (Re)prefill: pad prompts of the live set to one length.
            max_prompt = max(len(r.prompt) + len(r.out_tokens) for r in live)
            toks = np.zeros((self.slots, max_prompt), np.int32)
            for idx, req in enumerate(active):
                if req is None or req.done:
                    continue
                seqline = np.concatenate([req.prompt,
                                          np.asarray(req.out_tokens, np.int32)])
                toks[idx, -len(seqline):] = seqline  # left-pad
            cache = init_cache(self.cfg, self.slots, self.max_len,
                               device=self.device)
            logits, cache = prefill(
                self.model, torch.from_numpy(toks).to(self.device), cache)
            stats["prefills"] += 1

            # Decode until every live slot finishes (then refill loop re-runs).
            last = self._sample(logits[:, -1])
            for _ in range(max(r.max_new_tokens - len(r.out_tokens)
                               for r in live)):
                for idx, req in enumerate(active):
                    if req is None or req.done:
                        continue
                    tok = int(last[idx])
                    req.out_tokens.append(tok)
                    if (self.eos_id is not None and tok == self.eos_id) or \
                            len(req.out_tokens) >= req.max_new_tokens:
                        req.done = True
                if all(r is None or r.done for r in active):
                    break
                logits, cache = decode_step(
                    self.model, torch.from_numpy(last).to(self.device), cache)
                stats["decode_steps"] += 1
                last = self._sample(logits[:, 0])
        stats["wall_s"] = time.perf_counter() - t_start
        self.last_stats = stats
        return requests

    @staticmethod
    def _sample(logits) -> np.ndarray:
        """Greedy: the first largest logit of each row, int32 on the
        host."""
        return torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()

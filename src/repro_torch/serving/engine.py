"""Preemption-safe batched serving engine.

The decode loop is a SONIC loop nest at request granularity:

  * the generation cursor (tokens emitted so far per request) is committed
    durably after every decode step -- one tiny atomic write (loop
    continuation);
  * committed tokens are the recovery state: after preemption the engine
    re-prefills prompt+committed tokens (idempotent, deterministic) and
    resumes at the cursor, so at most ONE token of decode work is redone;
  * KV-cache pages persisted to the paged store use the two-phase
    read/write-cursor protocol (sparse undo-logging) -- see kvstore.py.

The JAX package jits ``decode_step``; here it runs eagerly, with the cache
on the parameters' device, and advances the cache in place.  The re-prefill
runs the same ``decode_step`` calls as the original run, so on one device
a resumed run gives the uninterrupted run's tokens bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path

import torch

from ..checkpoint import Cursor
from ..models import get_model


@dataclass
class Request:
    rid: str
    prompt: list
    max_new: int
    generated: list = field(default_factory=list)

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.max_new


class ServeEngine:
    def __init__(self, cfg, params, state_dir: str | Path,
                 max_len: int = 256):
        self.cfg = cfg
        self.api = get_model(cfg)
        self.params = params
        self.max_len = max_len
        self.state_dir = Path(state_dir)
        self.state_dir.mkdir(parents=True, exist_ok=True)
        self.device = params["embed"].device

    def _decode(self, params, cache, tok, pos):
        return self.api.decode_step(self.cfg, params, cache, tok, pos)

    def _cursor(self, rid: str) -> Cursor:
        return Cursor(self.state_dir / f"{rid}.json")

    def submit(self, req: Request) -> None:
        cur = self._cursor(req.rid)
        c = cur.read()
        if not c:
            cur.commit(prompt=list(map(int, req.prompt)),
                       max_new=req.max_new, generated=[])
        elif c.get("max_new") != req.max_new:
            # resubmission with a new budget: the durable cursor must track
            # it, or recover() resurrects the stale value and the request
            # stops (or overruns) at the wrong length
            cur.commit(max_new=req.max_new)

    def recover(self, rid: str) -> Request:
        """Rebuild a request from its durable cursor (post-preemption)."""
        c = self._cursor(rid).read()
        return Request(rid, c["prompt"], c["max_new"],
                       list(c.get("generated", [])))

    def run(self, requests: list[Request], greedy: bool = True,
            fail_after_tokens: int | None = None) -> dict:
        """Decode a batch of same-length-prompt requests to completion.

        ``fail_after_tokens`` simulates preemption for tests: the engine
        raises after committing that many tokens; a fresh engine instance
        resumes from the cursors."""
        for r in requests:
            self.submit(r)
        requests = [self.recover(r.rid) for r in requests]
        b = len(requests)
        plens = {len(r.prompt) for r in requests}
        if len(plens) > 1:
            raise ValueError(
                f"batch prompts must be equal length, got lengths "
                f"{sorted(plens)}: the lockstep prefill would silently "
                f"truncate longer prompts to the shortest")
        need = max((len(r.prompt) + r.max_new for r in requests), default=0)
        if need > self.max_len:
            raise ValueError(
                f"prompt+max_new needs {need} KV slots but max_len is "
                f"{self.max_len}; decode would overrun the cache")
        # idempotent re-prefill of prompt + committed tokens
        done_tokens = [r.prompt + r.generated for r in requests]
        min_done = min(len(t) for t in done_tokens)
        assert min_done > 0, "requests must have non-empty prompts"
        cache = self.api.init_cache(self.cfg, b, self.max_len,
                                    device=self.device)
        last_logits = None
        for pos in range(min_done):
            tok = torch.tensor([t[pos] for t in done_tokens],
                               dtype=torch.long, device=self.device)
            last_logits, cache = self._decode(self.params, cache, tok, pos)
        emitted = 0
        pos = min_done - 1           # position of the last token fed
        while not all(r.done for r in requests):
            nxt = torch.argmax(last_logits, -1)
            nxt_np = nxt.cpu().numpy()
            for i, r in enumerate(requests):
                if not r.done:
                    r.generated.append(int(nxt_np[i]))
                    # loop-continuation commit: one atomic cursor write
                    self._cursor(r.rid).commit(generated=r.generated)
            emitted += 1
            if fail_after_tokens is not None and emitted >= fail_after_tokens:
                raise RuntimeError("preempted")
            pos += 1                 # the new token occupies the next slot
            last_logits, cache = self._decode(self.params, cache, nxt, pos)
        return {r.rid: r.generated for r in requests}

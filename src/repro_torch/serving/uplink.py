"""Host-side uplink aggregator: the basestation end of the co-simulation.

Devices transmit at-least-once: a send torn by a power failure is retried
with the *same* sequence number after the reboot (the device's send row
rolls back atomically, so the seq cursor never advanced).  The host
therefore dedups by per-device monotone sequence number and keeps only the
newest classifier verdict per device -- the fleet's state of the world is
one class id (plus optional top-k logits) per device, not a message log.

Durability rides the same cursor protocol as the serving engine: each
accepted message is one atomic per-device :class:`~repro_torch.checkpoint.Cursor`
commit, so a preempted host recovers exactly (replayed messages dedup
against the committed seq, at most one message of work is redone).

A copy of the JAX package's ``serving/uplink.py`` (numpy and the port's
own checkpoint store).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from ..checkpoint import Cursor

#: Wire message kinds, mirroring the device's send/compress decision
#: (``runtime.radio``): a decisive inference ships its argmax class, an
#: unsure one ships top-k logits for the host to disambiguate.
MSG_KINDS = ("class", "topk")


@dataclass(frozen=True)
class UplinkMessage:
    """One decoded uplink frame.

    ``seq`` is the device's send counter -- it advances only when the
    device's send row commits, so a retry of a torn transmission reuses
    the old value and the host can discard the duplicate.
    """

    device: str
    seq: int
    kind: str                        # one of MSG_KINDS
    payload: tuple = ()              # "class": (class_id,); "topk": logits
    conf: float = 0.0

    def __post_init__(self):
        if self.kind not in MSG_KINDS:
            raise ValueError(f"unknown message kind {self.kind!r}; "
                             f"expected one of {MSG_KINDS}")
        if not self.payload:
            raise ValueError("uplink message payload is empty")


class UplinkAggregator:
    """Per-device last-class state with at-least-once dedup.

    ``ingest`` returns True when the message advanced the device's state
    and False for a duplicate (a retried send the host already committed).
    A message's class is its payload for ``kind="class"`` and the argmax
    of the shipped logits for ``kind="topk"``.
    """

    def __init__(self, state_dir: str | Path):
        self.state_dir = Path(state_dir)
        self.state_dir.mkdir(parents=True, exist_ok=True)
        self._cache: dict[str, dict] = {}
        self.n_accepted = 0
        self.n_duplicates = 0

    def _cursor(self, device: str) -> Cursor:
        return Cursor(self.state_dir / f"{device}.json")

    def _state(self, device: str) -> dict:
        if device not in self._cache:
            self._cache[device] = self._cursor(device).read()
        return self._cache[device]

    def ingest(self, msg: UplinkMessage) -> bool:
        st = self._state(msg.device)
        last = st.get("seq")
        if last is not None and msg.seq <= last:
            self.n_duplicates += 1
            return False
        if msg.kind == "class":
            cls = int(msg.payload[0])
            topk = None
        else:
            topk = [float(v) for v in msg.payload]
            cls = int(np.argmax(topk))
        # one atomic commit per accepted message: the recovery point
        self._cursor(msg.device).commit(seq=int(msg.seq), last_class=cls,
                                        topk=topk, conf=float(msg.conf))
        self._cache[msg.device] = dict(seq=int(msg.seq), last_class=cls,
                                       topk=topk, conf=float(msg.conf))
        self.n_accepted += 1
        return True

    def last_class(self, device: str):
        """Newest committed class verdict for ``device`` (None if the
        device has never been heard from)."""
        return self._state(device).get("last_class")

    def last_seq(self, device: str):
        return self._state(device).get("seq")

    def devices(self) -> list[str]:
        """Devices with durable state -- survives host restart."""
        on_disk = {p.stem for p in self.state_dir.glob("*.json")}
        return sorted(on_disk | {d for d, s in self._cache.items() if s})

    def snapshot(self) -> dict:
        """``{device: last_class}`` across every known device."""
        return {d: self.last_class(d) for d in self.devices()}

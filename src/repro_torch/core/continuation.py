"""Loop continuation (Sec. 6.2.1): resumable loops with NV cursors.

A :class:`ResumableLoop` keeps its control variable directly in non-volatile
memory and never resets it on reboot; combined with an idempotent body, the
loop resumes at the interrupted iteration with zero redo-logging and zero
task-transition overhead.  A power failure during or after the cursor update
may re-run one iteration but never skips one.

The same abstraction drives both the paper-scale device simulator (cursor in
simulated FRAM) and the fleet-scale trainer (cursor in the checkpoint store),
via the minimal ``read_scalar``/``write_scalar`` store interface.
"""

from __future__ import annotations

from typing import Callable

from .nvstore import NVStore


class ResumableLoop:
    """``for i in range(n)`` whose index survives power failures."""

    def __init__(self, nv: NVStore, name: str, n: int,
                 recover: Callable[[], None] | None = None):
        self.nv = nv
        self.cursor = f"{name}/i"
        self.n = n
        self.recover = recover
        if self.cursor not in nv:
            nv.write_scalar(self.cursor, 0)

    def __iter__(self):
        # Reboot path: run idempotence recovery before touching data.
        if self.recover is not None:
            self.recover()
        while True:
            i = int(self.nv.read_scalar(self.cursor))
            if i >= self.n:
                return
            yield i
            # Commit progress: one atomic NV word write per iteration.  A
            # failure before this line re-runs iteration i (idempotent body);
            # a failure after it proceeds to i+1.  No iteration is skipped.
            self.nv.write_scalar(self.cursor, i + 1)

    def reset(self) -> None:
        self.nv.write_scalar(self.cursor, 0)

    @property
    def done(self) -> bool:
        return int(self.nv.read_scalar(self.cursor)) >= self.n


def run_intermittent(device, fn: Callable[[], None], max_reboots: int = 10_000_000):
    """Drive ``fn`` to completion across power failures.

    ``fn`` must be written against NV state (ResumableLoop et al.) so that
    re-invocation continues rather than restarts.  Returns device stats.
    """
    from .energy import PowerFailure

    while True:
        try:
            fn()
            return device.stats
        except PowerFailure:
            device.reboot()
            if device.stats.reboots > max_reboots:
                raise RuntimeError("intermittent execution did not converge")

"""Task-based intermittent execution baseline (Alpaca [52] analogue).

This is the state-of-the-art system the paper compares against.  A program is
a chain of *tasks*; each task executes atomically: writes to task-shared NV
data are privatized into a redo log and committed (copied to their real
locations) at the task boundary, followed by a task transition.  After a power
failure the *current task restarts from its beginning*, discarding the log.

``TiledLoopTask`` splits a loop into fixed tiles of ``k`` iterations per task
(Fig. 6's Tile-k): small k wastes energy on transitions and commits, large k
risks non-termination when one tile exceeds the energy buffer.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from .energy import Device, PowerFailure
from .nvstore import NVStore


class RedoLog:
    """Write privatization buffer for one task execution (volatile)."""

    def __init__(self, nv: NVStore, device: Device):
        self.nv = nv
        self.device = device
        self._log: dict[tuple, np.ndarray] = {}

    def read(self, name: str, idx=slice(None)) -> np.ndarray:
        key = (name, repr(idx))
        if key in self._log:                      # read-your-writes
            if self.device is not None:
                self.device.charge("sram_read", np.size(self._log[key]))
            return np.array(self._log[key])
        return self.nv.read(name, idx)

    def write(self, name: str, value, idx=slice(None)) -> None:
        # Dynamic privatization: the value lands in the volatile log plus an
        # NV shadow entry (Alpaca logs to NV so commit survives failures); we
        # charge the paper-calibrated per-word redo-log cost.
        value = np.asarray(value)
        if self.device is not None:
            self.device.charge("redo_log", np.size(value))
        self._log[(name, repr(idx))] = np.array(value)

    def commit(self) -> None:
        """Walk the log and apply every entry to its true NV location."""
        for (name, idx_r), value in self._log.items():
            idx = eval(idx_r)  # noqa: S307 - reprs of slices/ints we created
            self.nv.write(name, value, idx)
        self._log.clear()


class TaskRunner:
    """Executes a chain of tasks with Alpaca semantics."""

    def __init__(self, nv: NVStore, device: Device):
        self.nv = nv
        self.device = device
        # Task index is kept in NV so the chain resumes at the failed task.
        if "task/pc" not in nv:
            nv.write_scalar("task/pc", 0)

    def run(self, tasks: list[Callable[[RedoLog], None]],
            max_reboots: int = 1_000_000) -> None:
        while True:
            try:
                while True:
                    pc = int(self.nv.read_scalar("task/pc"))
                    if pc >= len(tasks):
                        return
                    log = RedoLog(self.nv, self.device)
                    tasks[pc](log)
                    log.commit()
                    # Task transition: commit bookkeeping + dispatch.
                    self.device.charge("task_transition")
                    self.nv.write_scalar("task/pc", pc + 1)
            except PowerFailure:
                self.device.reboot()
                if self.device.stats.reboots > max_reboots:
                    raise RuntimeError("task chain did not converge")


def tile_loop(n: int, k: int, body: Callable[[RedoLog, int], None]
              ) -> list[Callable[[RedoLog], None]]:
    """Split ``for i in range(n)`` into ceil(n/k) tasks of k iterations."""
    tasks = []
    for start in range(0, n, k):
        hi = min(start + k, n)

        def task(log: RedoLog, lo=start, hi=hi):
            for i in range(lo, hi):
                body(log, i)

        tasks.append(task)
    return tasks

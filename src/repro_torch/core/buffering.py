"""SONIC's idempotence mechanisms (Sec. 6.2.2).

Loop continuation lets a loop resume at the interrupted iteration, so every
iteration must be *idempotent*: re-executing a partially-completed iteration
must produce the same final state.  Two mechanisms provide this:

``LoopOrderedBuffer``
    Double buffering for dense data (convolutions, dense FC).  An iteration
    reads the *front* buffer and writes the *back* buffer; no location is both
    read and written in one iteration (WAR-freedom by construction), so a torn
    back-buffer write is simply overwritten on re-execution.  The commit is a
    single atomic NV pointer swap.

``SparseUndoLog``
    Two-phase in-place update for sparse data (pruned FC layers).  Before
    modifying ``buf[i]`` the original value is copied to a canonical slot and
    the *read* cursor is bumped; after the write the *write* cursor is bumped.
    On reboot, ``read > write`` means the update may be torn and the slot is
    restored first.  Space overhead is O(1) and work scales with the number of
    modifications, not the buffer size.
"""

from __future__ import annotations

import numpy as np

from .nvstore import NVStore


class LoopOrderedBuffer:
    """A/B double buffer with an atomic NV front-pointer."""

    def __init__(self, nv: NVStore, name: str, shape, dtype=np.float32):
        self.nv = nv
        self.name = name
        self._a, self._b = f"{name}/A", f"{name}/B"
        self._ptr = f"{name}/front"
        if self._ptr not in nv:
            nv.alloc(self._a, shape, dtype)
            nv.alloc(self._b, shape, dtype)
            nv.write_scalar(self._ptr, 0)

    # front = committed data; back = scratch for the current iteration
    def _front_name(self) -> str:
        return self._a if self.nv.read_scalar(self._ptr) == 0 else self._b

    def _back_name(self) -> str:
        return self._b if self.nv.read_scalar(self._ptr) == 0 else self._a

    def read_front(self, idx=slice(None)) -> np.ndarray:
        return self.nv.read(self._front_name(), idx)

    def write_back(self, value, idx=slice(None)) -> None:
        self.nv.write(self._back_name(), value, idx)

    def swap(self) -> None:
        """Commit: single-word atomic pointer flip."""
        cur = self.nv.read_scalar(self._ptr)
        self.nv.write_scalar(self._ptr, 1 - cur)

    # -- test/inspection helpers (no energy accounting) ---------------------
    def front_raw(self) -> np.ndarray:
        return self.nv.raw(self._front_name())

    def back_raw(self) -> np.ndarray:
        return self.nv.raw(self._back_name())


class SparseUndoLog:
    """Two-phase undo log guarding in-place updates of one NV array."""

    def __init__(self, nv: NVStore, target: str):
        self.nv = nv
        self.target = target
        base = f"{target}/undo"
        self._slot_val = f"{base}/val"     # canonical saved value
        self._slot_idx = f"{base}/idx"     # which element is saved
        self._read = f"{base}/read"        # phase-1 cursor
        self._write = f"{base}/write"      # phase-2 cursor
        for k, v in ((self._slot_val, 0.0), (self._slot_idx, -1),
                     (self._read, 0), (self._write, 0)):
            if k not in nv:
                nv.write_scalar(k, v)

    def recover(self) -> None:
        """Run after every reboot: roll back a possibly-torn update.

        Invariant: ``read == write`` (quiescent) or ``read == write + 1``
        (update k = ``write`` in flight).  A torn in-flight update is undone
        from the canonical slot and the read cursor rolled back, so the loop
        resumes at iteration ``write`` and redoes it from scratch.  recover()
        is itself idempotent: re-running it after a failure mid-recovery
        restores the same saved value again.
        """
        r = self.nv.read_scalar(self._read)
        w = self.nv.read_scalar(self._write)
        if r > w:  # interrupted between phase 1 and phase 2
            idx = int(self.nv.read_scalar(self._slot_idx))
            if idx >= 0:
                val = self.nv.read_scalar(self._slot_val)
                self.nv.write(self.target, val, idx)
            self.nv.write_scalar(self._read, w)  # iteration w will be redone

    @property
    def completed(self) -> int:
        """Number of fully committed updates (the loop-continuation cursor)."""
        return int(self.nv.read_scalar(self._write))

    def update(self, idx: int, new_value) -> None:
        """Idempotently replace ``target[idx]`` with ``new_value``."""
        # Phase 1: persist the original, then bump the read cursor.
        orig = self.nv.read(self.target, idx)
        self.nv.write_scalar(self._slot_idx, idx)
        self.nv.write_scalar(self._slot_val, orig)
        self.nv.write_scalar(self._read, self.nv.read_scalar(self._read) + 1)
        # Phase 2: in-place write, then bump the write cursor.
        self.nv.write(self.target, new_value, idx)
        self.nv.write_scalar(self._write, self.nv.read_scalar(self._write) + 1)

    def accumulate(self, idx: int, delta) -> None:
        """Idempotent read-modify-write (the pruned-FC inner op)."""
        orig = self.nv.read(self.target, idx)
        self.nv.write_scalar(self._slot_idx, idx)
        self.nv.write_scalar(self._slot_val, orig)
        self.nv.write_scalar(self._read, self.nv.read_scalar(self._read) + 1)
        self.nv.write(self.target, orig + delta, idx)
        self.nv.write_scalar(self._write, self.nv.read_scalar(self._write) + 1)

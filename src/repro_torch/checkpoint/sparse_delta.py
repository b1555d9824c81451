"""Sparse delta checkpoints: the paper's sparse undo-logging at file scale.

Large, sparsely-mutated state (embedding rows, MoE expert slices, KV-cache
pages) is updated in place; each mutation is guarded by the two-phase
read/write cursor protocol so an interrupted update rolls back from the
canonical saved copy.  Work (and bytes written) scales with the number of
modifications, not the state size -- exactly Sec. 6.2.2's argument.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from .store import atomic_write_bytes, atomic_write_json


class SparseDeltaFile:
    """In-place mutable array file with crash-safe sparse row updates."""

    def __init__(self, path: str | Path, shape=None, dtype=np.float32):
        self.path = Path(path)
        self.meta_path = self.path.with_suffix(".meta.json")
        self.undo_path = self.path.with_suffix(".undo.npz")
        self.cursor_path = self.path.with_suffix(".cursors.json")
        if not self.path.exists():
            assert shape is not None
            arr = np.zeros(shape, dtype)
            with open(self.path, "wb") as f:
                np.save(f, arr)
            atomic_write_json(self.meta_path,
                              {"shape": list(shape), "dtype": str(dtype)})
            atomic_write_json(self.cursor_path, {"read": 0, "write": 0})

    # -- cursors --------------------------------------------------------------
    def _cursors(self) -> dict:
        return json.loads(self.cursor_path.read_text())

    def _set_cursors(self, read: int, write: int) -> None:
        atomic_write_json(self.cursor_path, {"read": read, "write": write})

    @property
    def completed(self) -> int:
        return self._cursors()["write"]

    # -- protocol ---------------------------------------------------------------
    def recover(self) -> None:
        """Roll back a torn in-place update (run after every restart)."""
        c = self._cursors()
        if c["read"] > c["write"] and self.undo_path.exists():
            undo = np.load(self.undo_path)
            arr = np.load(self.path, mmap_mode="r+")
            arr[undo["rows"]] = undo["values"]
            arr.flush()
            self._set_cursors(c["write"], c["write"])

    def update_rows(self, rows: np.ndarray, values: np.ndarray) -> None:
        """Idempotent in-place row update.

        Phase 1: persist originals + bump read cursor.
        Phase 2: write new rows in place + bump write cursor."""
        rows = np.asarray(rows)
        arr = np.load(self.path, mmap_mode="r+")
        orig = np.array(arr[rows])
        with open(self.undo_path.with_suffix(".tmp"), "wb") as f:
            np.savez(f, rows=rows, values=orig)
        import os
        os.replace(self.undo_path.with_suffix(".tmp"), self.undo_path)
        c = self._cursors()
        self._set_cursors(c["read"] + 1, c["write"])
        # phase 2: in-place mutation (may tear; recover() undoes it)
        arr[rows] = values
        arr.flush()
        c = self._cursors()
        self._set_cursors(c["read"], c["write"] + 1)

    def read(self) -> np.ndarray:
        return np.array(np.load(self.path, mmap_mode="r"))

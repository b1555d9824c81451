"""Paged KV-cache persistence with sparse undo-logging.

Disaggregated serving keeps KV pages in a durable tier (host DRAM/NVMe) so
decode replicas can migrate or restart without re-prefill.  A KV append is
an in-place sparse row update of a big array -- precisely the access pattern
the paper guards with sparse undo-logging: two-phase (save original rows +
read cursor, write rows + write cursor), constant space, work proportional
to rows touched.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..checkpoint import SparseDeltaFile


class PagedKVStore:
    """One durable (layers, max_len, kv_heads*hd*2) array per sequence."""

    def __init__(self, root: str | Path, layers: int, max_len: int,
                 kv_width: int):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.layers = layers
        self.max_len = max_len
        self.kv_width = kv_width

    def _file(self, seq_id: str) -> SparseDeltaFile:
        return SparseDeltaFile(self.root / f"{seq_id}.npy",
                               shape=(self.max_len,
                                      self.layers * self.kv_width),
                               dtype=np.float32)

    def recover(self, seq_id: str) -> int:
        """Post-restart: roll back a torn append; returns committed length."""
        f = self._file(seq_id)
        f.recover()
        return f.completed

    def append(self, seq_id: str, pos: int, kv_rows: np.ndarray) -> None:
        """Append one token's K/V across all layers at position ``pos``.

        kv_rows: (layers * kv_width,).  Idempotent under re-execution."""
        f = self._file(seq_id)
        f.update_rows(np.asarray([pos]),
                      kv_rows.reshape(1, -1).astype(np.float32))

    def read(self, seq_id: str) -> np.ndarray:
        return self._file(seq_id).read()

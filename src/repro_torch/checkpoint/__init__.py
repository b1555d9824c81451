"""Fleet-scale SONIC: crash-safe checkpointing with the paper's mechanisms
(A/B slots = loop-ordered buffering, cursors = loop continuation, sparse
deltas = sparse undo-logging)."""

from .sparse_delta import SparseDeltaFile
from .store import Cursor, SlotStore, atomic_write_json

__all__ = ["Cursor", "SlotStore", "SparseDeltaFile", "atomic_write_json"]

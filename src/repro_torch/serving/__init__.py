"""Preemption-safe serving: cursor-committed decode + undo-logged KV pages,
plus the host end of the edge-device uplink."""

from .engine import Request, ServeEngine
from .kvstore import PagedKVStore
from .uplink import MSG_KINDS, UplinkAggregator, UplinkMessage

__all__ = ["MSG_KINDS", "PagedKVStore", "Request", "ServeEngine",
           "UplinkAggregator", "UplinkMessage"]

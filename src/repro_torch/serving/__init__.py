"""The host end of the edge-device uplink: at-least-once messages deduped
by per-device sequence number, each accepted one a cursor commit.

The JAX package's ``repro.serving`` also holds the preemption-safe decode
engine (``ServeEngine``, ``Request``) and its undo-logged KV pages
(``PagedKVStore``); those wait for decode in the port (``ROADMAP.md``
Queue 1, item 14).
"""

from .uplink import MSG_KINDS, UplinkAggregator, UplinkMessage

__all__ = ["MSG_KINDS", "UplinkAggregator", "UplinkMessage"]

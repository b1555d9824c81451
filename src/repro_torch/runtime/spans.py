"""Spans: host and device seconds by layer, measured inside the program.

A span is one named piece of the fleet replay's host work, ``<layer>/<name>``
(``entry/_prepare``, ``samplers/harvest_jitter_stream``,
``closed_form/_scan_replay``, ...).  A function becomes one with
:func:`traced`; a part of a function with ``with span(layer, name):``.
The registry is off by default, and off a span costs one check of a
module global: it makes no object, no CUDA event and no profiler range.
The switch is the API: :func:`enable`, :func:`disable`, :func:`reset` and
:func:`snapshot`.

While on, each span adds, for each thread role (``"producer"`` for the
overlapped pipeline's ``fleetsim-prefetch`` thread, ``"caller"`` for every
other), its calls, its wall seconds (``perf_counter``), its self seconds
(wall less the spans nested in it on the same thread) and its thread's CPU
seconds (``thread_time``), whole and self.  A wall time well above the CPU
time is a wait: for a core, for the interpreter lock, or for the card.
While the torch profiler runs, a span also opens the range
``repro_torch:<layer>/<name>``, on the device trace's clock.

**The card's time by span.**  Where the outermost span on a caller thread
names the call's device (``traced(..., device_arg=...)``) and that device
is a CUDA card, every span entry and exit on that thread records a timing
``torch.cuda.Event`` on the stream current at that outermost entry (the
replay stream).  The card's seconds between two consecutive events belong
to the innermost span open between them.  A span declared ``host_only``
launches nothing on that stream, so its device seconds are exactly how
long the card sat idle waiting on that host work, and 0 when the card had
work queued.  No event is recorded from the producer thread or while the
current stream captures a CUDA graph.  Events come from a pool; the
pending ones are resolved in :func:`snapshot` (after the caller has
synchronised) and, once ``RESOLVE_AT`` are pending, the completed ones
are resolved on the way (``query``, never a wait).

Counters stay where they are (``charge_replay.launches*``,
``stats_fold.launches``, ``_replay_rows.rows``, ...): always on, one add a
call.  Numpy-only modules (``runtime.failures``) import this one, so it
imports ``torch`` only once a span has a card to time.
"""

from __future__ import annotations

import contextlib
import functools
import inspect
import sys
import threading
import time

#: The name of the overlapped pipeline's producer thread
#: (``core.fleetsim._overlapped_replay``); spans on it count as
#: ``"producer"``, on every other thread as ``"caller"``.
PRODUCER_THREAD = "fleetsim-prefetch"
#: The prefix of the profiler ranges spans open.
RANGE_PREFIX = "repro_torch:"
#: Pending events on a stream beyond which the completed ones are resolved.
RESOLVE_AT = 256
#: The fields of a role's entry in :func:`snapshot`.
HOST_FIELDS = ("calls", "wall_s", "self_s", "cpu_s", "self_cpu_s")

_on = False
_events = True
_OFF = contextlib.nullcontext()
_lock = threading.Lock()
_local = threading.local()
_meta: dict = {}        # key -> (layer, name, host_only)
_host: dict = {}        # (role, key) -> [calls, wall, self, cpu, self cpu]
_device: dict = {}      # key -> device seconds
_chains: dict = {}      # (thread, device, stream) -> _Chain


def enable(events: bool = True) -> None:
    """Turn spans on; ``events=False`` keeps to the host's clocks (no CUDA
    event is recorded)."""
    global _on, _events
    _events = events
    _on = True


def disable() -> None:
    """Turn spans off (what they recorded stays until :func:`reset`)."""
    global _on
    _on = False


def enabled() -> bool:
    return _on


def reset() -> None:
    """Forget every reading, and every event not yet resolved."""
    with _lock:
        _host.clear()
        _device.clear()
        chains = list(_chains.values())
    for c in chains:
        c.drop()


def _register(layer: str, name: str, host_only: bool) -> str:
    key = f"{layer}/{name}"
    _meta[key] = (layer, name, host_only)
    return key


def traced(layer: str, name: str | None = None, host_only: bool = False,
           device_arg: str | None = None):
    """Decorate a function as the span ``<layer>/<name>`` (``name``: the
    function's own).  ``device_arg`` names the parameter that holds the
    call's device: where this span is the outermost on a caller thread and
    that device is a card, the spans under it time the card too.  The
    wrapper keeps the function's name and attributes
    (``functools.wraps``)."""
    def deco(fn):
        key = _register(layer, name or fn.__name__, host_only)
        pos = default = None
        if device_arg is not None:
            params = list(inspect.signature(fn).parameters.values())
            pos = [p.name for p in params].index(device_arg)
            default = params[pos].default

        @functools.wraps(fn)
        def run(*a, **k):
            if not _on:
                return fn(*a, **k)
            dev = None
            if device_arg is not None:
                dev = a[pos] if len(a) > pos else k.get(device_arg, default)
            frame = _enter(key, dev)
            try:
                return fn(*a, **k)
            finally:
                _exit(frame)
        return run
    return deco


class _Span:
    __slots__ = ("key", "frame")

    def __init__(self, key):
        self.key = key

    def __enter__(self):
        self.frame = _enter(self.key, None)

    def __exit__(self, *exc):
        _exit(self.frame)


def span(layer: str, name: str, host_only: bool = False):
    """A context manager timing a part of a function as ``<layer>/<name>``
    (off: a shared no-op context)."""
    if not _on:
        return _OFF
    key = f"{layer}/{name}"
    if key not in _meta:
        _register(layer, name, host_only)
    return _Span(key)


class _Thread:
    """One thread's open spans, its role, and the chain of events it
    records while its outermost span times a card."""

    def __init__(self):
        self.role = "producer" if threading.current_thread().name == \
            PRODUCER_THREAD else "caller"
        self.stack: list = []
        self.chain = None


def _thread() -> _Thread:
    th = getattr(_local, "th", None)
    if th is None:
        th = _local.th = _Thread()
    return th


def _profiling() -> bool:
    prof = sys.modules.get("torch.autograd.profiler")
    return prof is not None and prof._is_profiler_enabled


def _enter(key: str, dev) -> list:
    """Open ``key`` on this thread.  Its clocks start first, so what the
    span itself costs (its event, its profiler range) is its own time, as
    a timer wrapped around the call from outside counts it."""
    th = _thread()
    if not th.stack and dev is not None and _events \
            and th.role == "caller":
        th.chain = _chain(dev)
    frame = [key, time.perf_counter(), time.thread_time(), 0.0, 0.0, None]
    if th.chain is not None:
        th.chain.mark(key)
    if _profiling():
        import torch

        frame[5] = torch.profiler.record_function(RANGE_PREFIX + key)
        frame[5].__enter__()
    th.stack.append(frame)
    return frame


def _exit(frame: list) -> None:
    key, t0, c0, nested, nested_cpu, rf = frame
    th = _thread()
    th.stack.pop()
    if rf is not None:
        rf.__exit__(None, None, None)
    if th.chain is not None:
        th.chain.mark(th.stack[-1][0] if th.stack else None)
        if not th.stack:
            th.chain = None
    wall = time.perf_counter() - t0
    cpu = time.thread_time() - c0
    if th.stack:
        parent = th.stack[-1]
        parent[3] += wall
        parent[4] += cpu
    with _lock:
        h = _host.get((th.role, key))
        if h is None:
            h = _host[(th.role, key)] = [0, 0.0, 0.0, 0.0, 0.0]
        h[0] += 1
        h[1] += wall
        h[2] += wall - nested
        h[3] += cpu
        h[4] += cpu - nested_cpu


def _chain(dev):
    """This thread's chain of events on the current stream of ``dev``, or
    ``None`` where ``dev`` is no card."""
    if not str(dev).startswith("cuda"):
        return None
    import torch

    if not torch.cuda.is_available():
        return None
    stream = torch.cuda.current_stream(torch.device(dev))
    k = (threading.get_ident(), stream.device, stream.cuda_stream)
    with _lock:
        c = _chains.get(k)
        if c is None:
            c = _chains[k] = _Chain(stream)
    return c


def _add_device(key: str, s: float) -> None:
    with _lock:
        _device[key] = _device.get(key, 0.0) + s


class _Chain:
    """The timing events one caller thread records on one stream, in
    order: each with the span that owns the stretch after it (``None``:
    no span, the stretch is dropped)."""

    def __init__(self, stream):
        self.stream = stream
        self.pending: list = []
        self.last = None                # the newest resolved (event, owner)
        self.free: list = []

    def mark(self, owner) -> None:
        import torch

        if torch.cuda.is_current_stream_capturing():
            return
        ev = self.free.pop() if self.free else \
            torch.cuda.Event(enable_timing=True)
        ev.record(self.stream)
        self.pending.append((ev, owner))
        if len(self.pending) >= RESOLVE_AT:
            self.resolve(wait=False)

    def resolve(self, wait: bool) -> None:
        """Give each stretch between resolved events to its owner: all of
        them after a wait for the newest (``wait``), else those the card
        has passed."""
        if wait and self.pending:
            self.pending[-1][0].synchronize()
        n = 0
        for ev, owner in self.pending:
            if not (wait or ev.query()):
                break
            if self.last is not None:
                prev, prev_owner = self.last
                if prev_owner is not None:
                    _add_device(prev_owner, prev.elapsed_time(ev) * 1e-3)
                self.free.append(prev)
            self.last = (ev, owner)
            n += 1
        del self.pending[:n]

    def drop(self) -> None:
        self.free += [item[0] for item in self.pending]
        if self.last is not None:
            self.free.append(self.last[0])
        self.pending, self.last = [], None


def snapshot() -> dict:
    """Everything recorded since the last :func:`reset`, by span key:
    ``layer``, ``name``, ``host_only``; per role that ran it
    (``"caller"``, ``"producer"``) a dict of :data:`HOST_FIELDS`; where
    its stretches were timed on a card, ``device_s``.  Empty while nothing
    has run.  Call it from the caller's thread after the card has
    synchronised."""
    with _lock:
        chains = list(_chains.values())
    for c in chains:
        c.resolve(wait=True)
    out: dict = {}

    def entry(key):
        if key not in out:
            layer, name, host_only = _meta[key]
            out[key] = dict(layer=layer, name=name, host_only=host_only)
        return out[key]

    with _lock:
        for (role, key), h in _host.items():
            entry(key)[role] = dict(zip(HOST_FIELDS, h))
        for key, dev_s in _device.items():
            entry(key)["device_s"] = dev_s
    return out

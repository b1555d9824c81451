"""The device's side of a traced call, from ``torch.profiler``'s events.

The traced window is the span of the ``perfbench:call`` range the runner
opens around the call that follows the measured window of a ``--trace 1``
run.  Every CUDA event in it (kernels, copies, fills; not the copies of
the host's ranges that the profiler draws on the card's timeline) counts
as the device being busy; the union of their intervals is ``busy_s``.
Kernels are summed by name; the idle gaps between the busy intervals are
labelled by the innermost ``perfbench:`` range the host was in at the
gap's middle (the caller's thread first), as ``hosttimer.HostTimer`` opens
them around the program's functions.
"""

from __future__ import annotations

CALL_RANGE = "perfbench:call"


def is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def summarize(events) -> dict | None:
    """``events``: the profiler's kineto events.  ``None`` if the trace
    holds no call range or no device event."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    win = None
    ranges = []
    gpu = []
    for e in events:
        if e.device_type() == cuda:
            name = e.name()
            if e.is_user_annotation() or name.startswith("perfbench:"):
                continue        # a host range drawn on the card's timeline
            s = e.start_ns()
            gpu.append((s, s + e.duration_ns(), name))
        elif e.is_user_annotation():
            name = e.name()
            if name == CALL_RANGE:
                win = (e.start_ns(), e.end_ns(), e.start_thread_id())
            elif name.startswith("perfbench:"):
                ranges.append((e.start_ns(), e.end_ns(), e.start_thread_id(),
                               name[len("perfbench:"):]))
    if win is None or not gpu:
        return None
    w0, w1, caller = win
    kernels: dict[str, list] = {}
    spans = []
    for s, t, name in gpu:
        s, t = max(s, w0), min(t, w1)
        if t <= s:
            continue
        spans.append((s, t))
        k = kernels.setdefault(name, [0, 0.0])
        k[0] += 1
        k[1] += (t - s) * 1e-9
    spans.sort()
    busy, gaps = 0, []
    cur_s, cur_t = w0, w0
    for s, t in spans:
        if s > cur_t:
            busy += cur_t - cur_s
            gaps.append((cur_t, s))
            cur_s, cur_t = s, t
        else:
            cur_t = max(cur_t, t)
    busy += cur_t - cur_s
    if w1 > cur_t:
        gaps.append((cur_t, w1))
    gaps.sort(key=lambda g: g[0] - g[1])
    idle = [[label(ranges, caller, (a + b) // 2), (b - a) * 1e-9]
            for a, b in gaps[:10]]
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:10]
    return dict(window_s=(w1 - w0) * 1e-9, busy_s=busy * 1e-9,
                kernels={n: (c, s) for n, (c, s) in kernels.items()},
                device_ops=[[n, s] for n, (_c, s) in top], idle_gaps=idle)


def label(ranges, caller, t: int) -> str:
    """The innermost range covering ``t``, the caller's thread first."""
    best = {}
    for s, e, tid, name in ranges:
        if s <= t <= e:
            role = "caller" if tid == caller else "producer"
            if role not in best or s > best[role][0]:
                best[role] = (s, name)
    for role in ("caller", "producer"):
        if role in best:
            return f"{role}:{best[role][1]}"
    return "host outside the program's timed functions"


def kernel_time(summary: dict, match) -> tuple[int, float]:
    """Launches and device seconds of the kernels whose name ``match``
    accepts."""
    n, s = 0, 0.0
    for name, (c, t) in summary["kernels"].items():
        if match(name):
            n += c
            s += t
    return n, s

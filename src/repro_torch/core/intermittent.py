"""Top-level intermittent inference entry point (reproduces Fig. 9's matrix).

``evaluate(net, x, strategy, power)`` runs one inference under one of the six
implementations on one of the four power systems, returning output, energy/
time statistics, and termination status.  Intermittent outputs are verified
bit-identical to the same strategy's continuously-powered execution.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .energy import (Device, LEA_COSTS, NonTermination, PowerFailure,
                     SOFTWARE_COSTS, make_power_system)
from .inference import (FlatLoopRunner, SimNet, TiledTaskRunner,
                        build_layer_segments, run_naive)
from .nvstore import NVStore

STRATEGIES = ("naive", "tile-8", "tile-32", "tile-128", "sonic", "tails")
POWER_SYSTEMS = ("continuous", "100uF", "1mF", "50mF")


@dataclass
class RunResult:
    network: str
    strategy: str
    power: str
    completed: bool
    output: np.ndarray | None
    live_time_s: float
    dead_time_s: float
    total_time_s: float
    energy_j: float
    reboots: int
    max_atomic_cycles: float
    dnf_reason: str = ""
    by_class: dict | None = None

    def row(self) -> dict:
        return {
            "network": self.network, "strategy": self.strategy,
            "power": self.power, "completed": self.completed,
            "live_s": round(self.live_time_s, 6),
            "dead_s": round(self.dead_time_s, 6),
            "total_s": round(self.total_time_s, 6),
            "energy_mj": round(self.energy_j * 1e3, 6),
            "reboots": self.reboots,
        }


def _alloc_activations(nv: NVStore, net: SimNet, x: np.ndarray) -> list[str]:
    shapes = net.shapes()
    names = []
    for i, s in enumerate(shapes):
        name = f"act/{i}"
        nv.alloc(name, s)
        names.append(name)
    nv.raw(names[0])[...] = np.asarray(x, np.float32)
    return names


def _run_layer_chain(net: SimNet, x: np.ndarray, device: Device,
                     strategy: str) -> np.ndarray:
    """SONIC / TAILS / Tile-k executor: NV layer cursor + per-layer plans."""
    nv = NVStore(None)   # all energy accounting is explicit in the plans
    names = _alloc_activations(nv, net, x)
    nv.write_scalar("net/pc", 0)
    tile_k = int(strategy.split("-")[1]) if strategy.startswith("tile") else 0
    max_atomic = 0.0

    def body():
        nonlocal max_atomic
        while True:
            pc = int(nv.raw("net/pc"))
            if pc >= len(net.layers):
                return
            layer = net.layers[pc]
            ln = f"L{pc}"
            segs = build_layer_segments(nv, device, layer, names[pc],
                                        names[pc + 1], ln, strategy)
            if strategy in ("sonic", "tails"):
                runner = FlatLoopRunner(nv, device, f"{ln}/u")
                region = runner.max_iter_cycles(segs)
            else:
                runner = TiledTaskRunner(nv, device, f"{ln}/pc", tile_k)
                region = runner.max_task_cycles(segs)
            max_atomic = max(max_atomic, region)
            device.check_region(ln, region)
            runner.run(segs)
            # Layer cursors are unique per layer, so this single atomic word
            # is the only cross-layer commit needed.
            device.charge("fram_write", 1)
            nv.write_scalar("net/pc", pc + 1)

    while True:
        try:
            body()
            break
        except PowerFailure:
            device.reboot()
    return nv.raw(names[-1]).copy(), max_atomic


def evaluate(net: SimNet, x: np.ndarray, strategy: str, power: str,
             check_against_continuous: bool = True) -> RunResult:
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}")
    power_sys = make_power_system(power)
    costs = LEA_COSTS if strategy == "tails" else SOFTWARE_COSTS

    # Reference pass on continuous power: output + total + atomic sizing.
    ref_dev = Device(make_power_system("continuous"), costs)
    if strategy == "naive":
        ref_out = run_naive(net, x, ref_dev)
        max_atomic = ref_dev.stats.live_cycles   # whole inference is atomic
    else:
        ref_out, max_atomic = _run_layer_chain(net, x, ref_dev, strategy)

    if power_sys.continuous:
        s = ref_dev.stats
        return RunResult(net.name, strategy, power, True, np.asarray(ref_out),
                         s.live_time_s, 0.0, s.live_time_s, s.energy_j,
                         0, max_atomic, by_class=dict(s.by_class))

    device = Device(power_sys, costs)
    if max_atomic > device.capacity:
        return RunResult(net.name, strategy, power, False, None, 0.0, 0.0,
                         float("inf"), float("inf"), 0, max_atomic,
                         dnf_reason=f"atomic region of {max_atomic:.0f} "
                                    f"cycles exceeds the "
                                    f"{device.capacity:.0f}-cycle buffer")
    try:
        if strategy == "naive":
            while True:
                try:
                    out = run_naive(net, x, device)
                    break
                except PowerFailure:
                    device.reboot()
        else:
            out, _ = _run_layer_chain(net, x, device, strategy)
    except NonTermination as e:
        return RunResult(net.name, strategy, power, False, None, 0.0, 0.0,
                         float("inf"), float("inf"), device.stats.reboots,
                         max_atomic, dnf_reason=str(e))

    if check_against_continuous and not np.allclose(
            np.asarray(out), np.asarray(ref_out), rtol=0, atol=0):
        raise AssertionError(
            f"{net.name}/{strategy}/{power}: intermittent output diverged "
            f"from continuous execution")
    s = device.stats
    return RunResult(net.name, strategy, power, True, np.asarray(out),
                     s.live_time_s, s.dead_time_s, s.total_time_s,
                     s.energy_j, s.reboots, max_atomic,
                     by_class=dict(s.by_class))

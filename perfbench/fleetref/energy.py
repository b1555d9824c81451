# Frozen copy of src/repro_torch/core/energy.py (the port at commit f60fe63),
# kept under perfbench/ so that the benchmark's plan-row reference cannot move
# with the program.  Imports only numpy and its sibling copies.  Kept whole on
# purpose, so that a diff against the original at that commit shows these
# lines alone, though ``plan.build_rows`` uses its cost tables, ``Device``'s
# costs and ``make_power_system``, not the charge-by-charge ``Device``
# methods.
"""Device energy model for intermittent execution (MSP430FR5994 analogue).

The paper's device (TI MSP430FR5994 @ 16 MHz, ~1 mW) executes in *charge
cycles*: a capacitor buffers harvested RF energy; the device runs until the
buffer drains, then dies, recharges, and reboots.  We model energy in units of
*cycles* (1 cycle = 62.5 pJ at 1 mW / 16 MHz) with a per-operation-class cost
table, so the simulator can (a) inject power failures at energy-accurate
points and (b) produce the per-class energy breakdowns of Fig. 12.

Cost-table constants are calibrated to the paper's measurements (Secs. 8-10):
  - software multiply is a memory-mapped peripheral: 4 setup insns + 9 cycles;
  - FRAM runs with wait states at 16 MHz (reads ~2x SRAM);
  - Alpaca-style task transitions cost hundreds of cycles (commit + dispatch);
  - LEA retires ~1 MAC/cycle but only out of 4 KB SRAM, so work must be DMA'd
    in and out, and fixed-point pre-shifts are done in software.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field


class PowerFailure(Exception):
    """Raised when the energy buffer empties mid-operation."""


class NonTermination(Exception):
    """Raised when a single atomic region needs more energy than the device buffers.

    This is the paper's non-termination condition (Sec. 2): re-execution will
    deterministically fail at the same point forever (Tile-128 at 100uF).
    """

    def __init__(self, region: str, needed: float, capacity: float):
        super().__init__(
            f"atomic region '{region}' needs {needed:.0f} cycles but the "
            f"device buffers only {capacity:.0f}; intermittent execution "
            f"will never terminate"
        )
        self.region = region
        self.needed = needed
        self.capacity = capacity


# --------------------------------------------------------------------------
# Cost tables (cycles per operation)
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class CostTable:
    """Cycles per primitive operation class."""

    name: str
    sram_read: float = 1.0
    sram_write: float = 1.0
    fram_read: float = 2.0          # 16 MHz wait-stated FRAM
    fram_write: float = 4.0         # write + wait states
    mac: float = 13.0               # peripheral multiplier: 4 setup + 9 exec
    alu: float = 1.0                # add/sub/shift
    control: float = 2.0            # loop bookkeeping: cmp + branch
    # -- Alpaca (task-based baseline) costs.  The paper does not publish
    # per-op cycle counts; these are inverse-fit within plausible MSP430
    # ranges so that the measured overhead ratios of Fig. 9 are reproduced
    # (Tile-8 ~13x naive, Tile-128 ~7x, SONIC ~1.45x; see benchmarks/fig9).
    task_transition: float = 930.0  # commit-list walk + dispatch + prologue
    redo_log: float = 90.0          # per logged word: linear log search +
                                    # alloc + 2 FRAM writes (dynamic privatization)
    log_lookup: float = 4.0         # read-your-writes search on task-shared reads
    commit_word: float = 20.0       # per logged word copied at task commit
    # -- TAILS (LEA + DMA) costs.
    dma_setup: float = 30.0
    dma_word: float = 1.0
    lea_mac: float = 1.0            # LEA FIR-DTC/MAC throughput
    lea_invoke: float = 100.0       # LEA command setup/teardown
    shift_sw: float = 4.0           # per-element fixed-point conditioning in
                                    # software: shift+saturate (LEA lacks
                                    # vector left-shift; Sec. 9.2). Charged
                                    # twice per element (pre+post).
    # -- Uplink radio.  TX energy is booked in cycle units like everything
    # else (1 cycle = 62.5 pJ); the per-send cycle count comes from the
    # radio model (``runtime.radio``), so the table cost is 1.0 and the
    # "count" is the send's total cycles.  Appended last so the class
    # indices of every earlier field stay stable across the fleet
    # simulator's packed per-class vectors.
    radio: float = 1.0              # uplink TX (wakeup + per-byte cycles)

    def scaled(self, **kw) -> "CostTable":
        return dataclasses.replace(self, **kw)


SOFTWARE_COSTS = CostTable(name="software")
LEA_COSTS = CostTable(name="lea")

#: Canonical operation-class order shared by the scalar simulator's
#: ``DeviceStats.by_class`` dicts and the vectorized fleet simulator's
#: per-class energy vectors (``core.fleetsim``).
OP_CLASSES: tuple[str, ...] = tuple(
    f.name for f in dataclasses.fields(CostTable) if f.name != "name")


def class_cycle_vector(costs: CostTable, counts: dict) -> list[float]:
    """Cycles per op class for one invocation of a cost dict, in
    :data:`OP_CLASSES` order (dense vector form of ``charge_bulk``)."""
    return [getattr(costs, op) * counts.get(op, 0.0) for op in OP_CLASSES]

#: Energy per cycle at the paper's operating point (1 mW / 16 MHz).
JOULES_PER_CYCLE = 62.5e-12
CLOCK_HZ = 16e6


# --------------------------------------------------------------------------
# Power systems
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class PowerSystem:
    """An energy buffer + harvester.

    ``cycles_per_charge`` is the usable compute per charge cycle; the paper
    quotes "typically around 100,000 instructions" for its RF setup.
    ``recharge_s`` is dead time to refill the buffer from the harvester
    (E_buffer / P_harvest); it scales linearly with the buffer size.
    """

    name: str
    cycles_per_charge: float | None   # None => continuously powered
    recharge_s: float = 0.0

    @property
    def continuous(self) -> bool:
        return self.cycles_per_charge is None


def rf_recharge_seconds(cycles, harvest_mw: float = 0.2):
    """Dead time to harvest `cycles * JOULES_PER_CYCLE` at `harvest_mw`.

    Accepts scalars or numpy arrays (the fleet simulator's capacitor sweeps
    compute per-lane recharge times in one shot)."""
    return cycles * JOULES_PER_CYCLE / (harvest_mw * 1e-3)


_rf_recharge_seconds = rf_recharge_seconds


def custom_power_system(cycles_per_charge: float,
                        harvest_mw: float = 0.2) -> PowerSystem:
    """An anonymous capacitor: ``cycles_per_charge`` usable cycles per charge
    with RF recharge dead time scaled to the stored energy.  Used by the
    fleet simulator's capacitor sweeps; :func:`make_power_system` (and hence
    plan extraction) accepts the returned object anywhere a power-system
    name is accepted."""
    return PowerSystem(f"cap{cycles_per_charge:g}", float(cycles_per_charge),
                       recharge_s=rf_recharge_seconds(cycles_per_charge,
                                                      harvest_mw))


def make_power_system(name: "str | PowerSystem") -> PowerSystem:
    """The four power systems of Fig. 9 by name (continuous, 100uF, 1mF,
    50mF), or any :class:`PowerSystem` instance passed through unchanged."""
    if isinstance(name, PowerSystem):
        return name
    if name in ("continuous", "cont"):
        return PowerSystem("continuous", None)
    budgets = {
        # usable cycles per charge, calibrated to "~100k instructions" for the
        # small cap and scaled by stored energy (0.5*C*(Vmax^2-Vmin^2)).
        "100uF": 1.0e5,
        "1mF": 1.0e6,
        "50mF": 5.0e7,
    }
    if name not in budgets:
        raise ValueError(f"unknown power system {name!r}; "
                         f"expected one of {['continuous', *budgets]}")
    c = budgets[name]
    return PowerSystem(name, c, recharge_s=_rf_recharge_seconds(c))


# --------------------------------------------------------------------------
# Device
# --------------------------------------------------------------------------

@dataclass
class DeviceStats:
    live_cycles: float = 0.0
    reboots: int = 0
    dead_time_s: float = 0.0
    by_class: dict[str, float] = field(default_factory=dict)   # cycles per op class
    counts: dict[str, int] = field(default_factory=dict)       # invocations per class

    @property
    def live_time_s(self) -> float:
        return self.live_cycles / CLOCK_HZ

    @property
    def total_time_s(self) -> float:
        return self.live_time_s + self.dead_time_s

    @property
    def energy_j(self) -> float:
        return self.live_cycles * JOULES_PER_CYCLE

    def energy_breakdown(self) -> dict[str, float]:
        """Fraction of live energy per op class (Fig. 12)."""
        total = sum(self.by_class.values()) or 1.0
        return {k: v / total for k, v in sorted(self.by_class.items())}

    def merge(self, other: "DeviceStats") -> "DeviceStats":
        out = DeviceStats(
            live_cycles=self.live_cycles + other.live_cycles,
            reboots=self.reboots + other.reboots,
            dead_time_s=self.dead_time_s + other.dead_time_s,
            by_class=dict(self.by_class),
            counts=dict(self.counts),
        )
        for k, v in other.by_class.items():
            out.by_class[k] = out.by_class.get(k, 0.0) + v
        for k, v in other.counts.items():
            out.counts[k] = out.counts.get(k, 0) + v
        return out


class Device:
    """Simulated intermittently-powered device.

    Every primitive operation calls :meth:`charge`.  When the remaining buffer
    cannot cover the requested cycles the device consumes what is left,
    invokes ``partial_cb`` (letting vectorized NV writes land *torn*, which is
    exactly the hazard the paper's idempotence tricks must survive) and raises
    :class:`PowerFailure`.  The executor catches it, calls :meth:`reboot`, and
    restarts the interrupted task.
    """

    def __init__(self, power: PowerSystem, costs: CostTable = SOFTWARE_COSTS):
        self.power = power
        self.costs = costs
        self.stats = DeviceStats()
        self._remaining = math.inf if power.continuous else power.cycles_per_charge
        #: cycles consumed since last reboot; used for non-termination detection.
        self._since_reboot = 0.0
        # Atomic-region tracking: the largest region observed must fit in one
        # charge for intermittent execution to terminate (Fig. 6).
        self._region_start: float | None = None
        self.max_region_cycles = 0.0

    @property
    def capacity(self) -> float:
        return math.inf if self.power.continuous else self.power.cycles_per_charge

    @property
    def remaining(self) -> float:
        return self._remaining

    def begin_region(self) -> None:
        self._region_start = self.stats.live_cycles

    def end_region(self) -> None:
        if self._region_start is not None:
            span = self.stats.live_cycles - self._region_start
            self.max_region_cycles = max(self.max_region_cycles, span)
            self._region_start = None

    def drain(self) -> None:
        """Burn the rest of the buffer and die (used at chunk boundaries)."""
        self.stats.live_cycles += self._remaining
        self.stats.by_class["control"] = (
            self.stats.by_class.get("control", 0.0) + self._remaining)
        self._remaining = 0.0
        raise PowerFailure("drain")

    def charge(self, op: str, n: float = 1.0, partial_cb=None) -> None:
        """Consume ``n`` operations of class ``op``."""
        cost = getattr(self.costs, op) * n
        self.stats.counts[op] = self.stats.counts.get(op, 0) + int(n)
        if cost <= self._remaining:
            self._remaining -= cost
            self._since_reboot += cost
            self.stats.live_cycles += cost
            self.stats.by_class[op] = self.stats.by_class.get(op, 0.0) + cost
            return
        # Partial progress: burn what's left, let torn writes land, die.
        frac = self._remaining / cost if cost > 0 else 0.0
        burned = self._remaining
        self.stats.live_cycles += burned
        self.stats.by_class[op] = self.stats.by_class.get(op, 0.0) + burned
        self._since_reboot += burned
        self._remaining = 0.0
        if partial_cb is not None:
            partial_cb(frac)
        raise PowerFailure(op)

    def check_region(self, region: str, needed_cycles: float) -> None:
        """Deterministic non-termination check for an atomic region."""
        if needed_cycles > self.capacity:
            raise NonTermination(region, needed_cycles, self.capacity)

    def reboot(self) -> None:
        self.stats.reboots += 1
        self.stats.dead_time_s += self.power.recharge_s
        self._remaining = self.capacity
        self._since_reboot = 0.0

    # Convenience wrappers -------------------------------------------------
    def fram_read(self, n: float, partial_cb=None):
        self.charge("fram_read", n, partial_cb)

    def fram_write(self, n: float, partial_cb=None):
        self.charge("fram_write", n, partial_cb)

    def mac(self, n: float, partial_cb=None):
        self.charge("mac", n, partial_cb)

    def control(self, n: float = 1.0):
        self.charge("control", n)

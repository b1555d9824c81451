"""Host-side intermittent simulator, the IMpJ application model and the
fleet replay (PyTorch).

The JAX package's ``repro.core`` names, except ``LoopOrderedBuffer``,
``SparseUndoLog``, ``ResumableLoop`` and ``run_intermittent``
(``buffering``, ``continuation``; see ``ROADMAP.md`` Queue 1, item 7).
"""

from .energy import (CostTable, Device, DeviceStats, LEA_COSTS,
                     NonTermination, OP_CLASSES, PowerFailure, PowerSystem,
                     SOFTWARE_COSTS, class_cycle_vector, custom_power_system,
                     make_power_system)
from .fleetsim import (CapacitorSweepResult, DesignSweepResult, FleetPlan,
                       FleetSweepResult, KIND_SEND, PlanSet,
                       REPLAY_POLICIES, REPLAY_REDUCES, ReplayOut,
                       build_plan, capacitor_sweep, fleet_evaluate,
                       fleet_sweep, replay_plans, with_uplink)
from .fleetstats import (FleetStats, STAT_CHANNELS, default_stat_edges,
                         stats_from_outputs)
from .imp import AppModel, WILDLIFE, accuracy_sweep
from .inference import Conv2D, DenseFC, MaxPool2D, SimNet, SparseFC
from .intermittent import POWER_SYSTEMS, RunResult, STRATEGIES, evaluate
from .nvstore import NVStore

__all__ = [
    "AppModel", "CapacitorSweepResult", "Conv2D", "CostTable", "DenseFC",
    "DesignSweepResult", "Device", "DeviceStats", "FleetPlan",
    "FleetStats", "FleetSweepResult", "KIND_SEND", "LEA_COSTS",
    "MaxPool2D", "NVStore", "NonTermination", "OP_CLASSES",
    "POWER_SYSTEMS", "PlanSet", "PowerFailure", "PowerSystem",
    "REPLAY_POLICIES", "REPLAY_REDUCES", "ReplayOut", "RunResult",
    "STAT_CHANNELS", "STRATEGIES", "SOFTWARE_COSTS", "SimNet", "SparseFC",
    "WILDLIFE", "accuracy_sweep", "build_plan", "capacitor_sweep",
    "class_cycle_vector", "custom_power_system", "default_stat_edges",
    "evaluate", "fleet_evaluate", "fleet_sweep", "make_power_system",
    "replay_plans", "stats_from_outputs", "with_uplink",
]

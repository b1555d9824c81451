"""Host-side intermittent simulator, the IMpJ application model and the
fleet replay (PyTorch).

The JAX package's ``repro.core`` names: SONIC-style loop continuation and
idempotence (buffering, undo logging), the Alpaca task-based baseline
(``tasks``), the device energy model, the IMpJ application model and the
vectorized fleet-scale replay.
"""

from .buffering import LoopOrderedBuffer, SparseUndoLog
from .continuation import ResumableLoop, run_intermittent

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
    "LoopOrderedBuffer",
    "MaxPool2D", "NVStore", "NonTermination", "OP_CLASSES",
    "POWER_SYSTEMS", "PlanSet", "PowerFailure", "PowerSystem",
    "REPLAY_POLICIES", "REPLAY_REDUCES",
    "ReplayOut", "ResumableLoop", "RunResult", "STAT_CHANNELS",
    "STRATEGIES", "SOFTWARE_COSTS", "SimNet", "SparseFC", "SparseUndoLog",
    "WILDLIFE", "accuracy_sweep", "build_plan", "capacitor_sweep",
    "class_cycle_vector", "custom_power_system", "default_stat_edges",
    "evaluate", "fleet_evaluate", "fleet_sweep", "make_power_system",
    "replay_plans", "run_intermittent", "stats_from_outputs",
    "with_uplink",
]

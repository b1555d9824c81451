"""Host-side intermittent simulator and the fleet replay (PyTorch)."""

from .energy import (CostTable, Device, DeviceStats, LEA_COSTS,
                     SOFTWARE_COSTS, make_power_system)
from .fleetsim import (FleetPlan, FleetSweepResult, ReplayOut, build_plan,
                       capacitor_sweep, fleet_evaluate, fleet_sweep,
                       replay_plans, with_uplink)
from .inference import Conv2D, DenseFC, MaxPool2D, SimNet, SparseFC
from .intermittent import POWER_SYSTEMS, RunResult, STRATEGIES, evaluate
from .nvstore import NVStore

"""Cluster runtime models: failure traces, straggler mitigation, elastic
rescale -- the large-scale-runnability substrate."""

from .elastic import ElasticEvent, MeshChoice, choose_mesh, simulate_elastic
from .failures import (FleetSpec, JobSpec, RunStats, charge_capacity_jitter,
                       charge_trace_cumulative, harvest_jitter,
                       inference_confidence, initial_charge_fraction,
                       reboot_recharge_times, recharge_trace_cumulative,
                       simulate)
from .radio import (RadioModel, SEND_POLICIES, SendPolicy, pack_radio,
                    radio_vector, send_cost_cycles)
from .straggler import StragglerSpec, efficiency, host_times, step_times

__all__ = ["ElasticEvent", "FleetSpec", "JobSpec", "MeshChoice",
           "RadioModel", "RunStats", "SEND_POLICIES", "SendPolicy",
           "StragglerSpec", "charge_capacity_jitter",
           "charge_trace_cumulative", "choose_mesh", "efficiency",
           "harvest_jitter", "host_times", "inference_confidence",
           "initial_charge_fraction", "pack_radio", "radio_vector",
           "reboot_recharge_times", "recharge_trace_cumulative",
           "send_cost_cycles", "simulate", "simulate_elastic",
           "step_times"]

"""Harvest-trace samplers and the uplink radio model."""

from .failures import (charge_capacity_jitter, charge_trace_cumulative,
                       harvest_jitter, inference_confidence,
                       initial_charge_fraction, reboot_recharge_times,
                       recharge_trace_cumulative)
from .radio import RadioModel, SEND_POLICIES, SendPolicy, pack_radio

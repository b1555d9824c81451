"""Uplink radio energy model and send policies for edge-host co-simulation.

The source paper's premise is that radio dominates the energy budget --
inference exists on-device to decide *what is worth transmitting*.  This
module closes the loop (ROADMAP "communication scenario"; arxiv 2408.14379's
design space): a send costs a fixed wakeup/preamble plus per-byte TX cycles,
the basestation listens in duty-cycled windows so a send that wakes into a
closed window defers until the next one opens, and a *send policy*
thresholds the device's classifier confidence into one of three messages:

  ship the argmax class   (conf >= conf_hi  -> header + class_bytes)
  ship top-k logits       (conf >= conf_lo  -> header + topk_bytes)
  ship nothing            (conf <  conf_lo  -> 0 bytes, 0 cycles)

All costs are in *cycles* (1 cycle = 62.5 pJ at the paper's 1 mW / 16 MHz
operating point, ``core.energy.JOULES_PER_CYCLE``), charged against the
same capacitor as compute by a dedicated plan row
(``core.fleetsim.with_uplink`` appends one): a send that drains the buffer
mid-transmission is *torn* -- it rolls back and retries the full preamble
on the next charge, exactly like any other atomic row.

The replay consumes the model + policy as one packed ``(10,)`` float64
vector (:func:`pack_radio`); cycle and byte fields are rounded to whole
numbers so the replay's integer-exact energy accounting is preserved.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

#: Packed radio-vector layout (indices into the ``(10,)`` operand the
#: replay broadcasts to every lane).  Order is load-bearing: the scan step,
#: the Pallas lane kernel and the pure-Python reference interpreter all
#: index these slots directly.  ``R_CLK`` carries the device clock rate:
#: the window-phase math divides live cycles by it at *runtime*, which
#: pins the divide as a true division -- divided by a compile-time
#: constant, XLA rewrites it into a reciprocal multiply whose rounding
#: (and FMA contraction with the following add) drifts one ulp away from
#: the reference interpreter's plain-Python mirror.
R_WAKEUP, R_CPB, R_HDR, R_CLASS, R_TOPK = 0, 1, 2, 3, 4
R_CONF_HI, R_CONF_LO, R_PERIOD, R_DUTY, R_CLK = 5, 6, 7, 8, 9
N_RADIO = 10


@dataclass(frozen=True)
class RadioModel:
    """Physical-layer costs of one uplink transmission.

    Defaults sketch a sub-GHz low-power radio driven by the MSP430: waking
    the radio, locking the synthesizer and sending the preamble costs a
    fixed ~75 us (1200 cycles at 16 MHz) regardless of payload, then each
    byte costs ``cycles_per_byte`` (256 cycles/byte ~ 16 us/byte ~ 500
    kbit/s at the radio's much higher TX draw, folded into cycle units at
    the device's 1 mW operating point).

    ``window_period_s``/``window_duty`` model a duty-cycled basestation:
    the receiver listens for the first ``duty`` fraction of every
    ``period`` seconds.  ``period = 0`` means always-on.  A device whose
    send decision lands outside the open window defers -- it sleeps (dead
    time, no energy burned) until the next window opens, then transmits.
    """

    wakeup_cycles: float = 1200.0
    cycles_per_byte: float = 256.0
    header_bytes: float = 6.0        # sync + address + seq + CRC
    class_bytes: float = 1.0         # argmax class id
    topk_bytes: float = 8.0          # top-k logit payload
    window_period_s: float = 0.0     # 0 => basestation always listening
    window_duty: float = 1.0


@dataclass(frozen=True)
class SendPolicy:
    """Confidence thresholds for the send/compress/skip decision.

    ``conf_hi <= conf`` ships the argmax class (the inference was decisive,
    one byte suffices); ``conf_lo <= conf < conf_hi`` ships top-k logits
    (let the host disambiguate); ``conf < conf_lo`` ships nothing (the
    result is not worth a radio wakeup).  ``conf_hi <= conf_lo`` collapses
    the top-k band.
    """

    name: str
    conf_hi: float = 0.0
    conf_lo: float = 0.0

    def message_bytes(self, conf, radio: "RadioModel") -> np.ndarray:
        """Bytes shipped for confidence(s) ``conf`` -- host-side mirror of
        the in-scan decision, for frontier math and tests."""
        conf = np.asarray(conf, np.float64)
        hdr = np.rint(radio.header_bytes)
        cls = hdr + np.rint(radio.class_bytes)
        topk = hdr + np.rint(radio.topk_bytes)
        return np.where(conf >= self.conf_hi, cls,
                        np.where(conf >= self.conf_lo, topk, 0.0))


#: Three named points on the information-per-joule frontier the benchmark
#: sweeps: always talk, hedge with logits when unsure, or stay silent
#: unless the classifier is decisive.
SEND_POLICIES: tuple[SendPolicy, ...] = (
    SendPolicy("ship-always", conf_hi=0.0, conf_lo=0.0),
    SendPolicy("topk-hedge", conf_hi=0.9, conf_lo=0.4),
    SendPolicy("confident-only", conf_hi=0.9, conf_lo=0.9),
)


def pack_radio(model: RadioModel, policy: SendPolicy) -> np.ndarray:
    """Pack a model + policy into the ``(10,)`` float64 vector the replay
    broadcasts to every lane.  Cycle and byte fields are rounded to whole
    numbers (integer-exact in float64) so send costs compose bitwise with
    the replay's cycle accounting; thresholds and window timing stay
    fractional."""
    from ..core.energy import CLOCK_HZ
    if model.window_period_s < 0:
        raise ValueError(
            f"window_period_s must be >= 0, got {model.window_period_s}")
    if not 0.0 <= model.window_duty <= 1.0:
        raise ValueError(
            f"window_duty must be in [0, 1], got {model.window_duty}")
    out = np.zeros(N_RADIO, np.float64)
    out[R_WAKEUP] = np.rint(model.wakeup_cycles)
    out[R_CPB] = np.rint(model.cycles_per_byte)
    out[R_HDR] = np.rint(model.header_bytes)
    out[R_CLASS] = np.rint(model.class_bytes)
    out[R_TOPK] = np.rint(model.topk_bytes)
    out[R_CONF_HI] = policy.conf_hi
    out[R_CONF_LO] = policy.conf_lo
    out[R_PERIOD] = model.window_period_s
    out[R_DUTY] = model.window_duty
    out[R_CLK] = CLOCK_HZ
    return out


def radio_vector(radio) -> np.ndarray:
    """Normalize a radio argument to the packed ``(10,)`` vector: accepts a
    ``(RadioModel, SendPolicy)`` pair or an already-packed array."""
    if radio is None:
        raise ValueError("radio is None")
    if isinstance(radio, tuple) and len(radio) == 2 and \
            isinstance(radio[0], RadioModel):
        return pack_radio(radio[0], radio[1])
    vec = np.asarray(radio, np.float64)
    if vec.shape != (N_RADIO,):
        raise ValueError(
            f"packed radio vector must have shape ({N_RADIO},), got "
            f"{vec.shape}; pass (RadioModel, SendPolicy) or pack_radio(...)")
    return vec


def send_cost_cycles(bytes_out, radio_vec) -> np.ndarray:
    """Cycles one transmission of ``bytes_out`` bytes costs (0 bytes -> 0
    cycles: no wakeup is paid for a skipped send).  Mirror of the in-scan
    cost expression, for tests and frontier math."""
    b = np.asarray(bytes_out, np.float64)
    v = np.asarray(radio_vec, np.float64)
    return np.where(b > 0, v[R_WAKEUP] + b * v[R_CPB], 0.0)

"""The host end of the uplink in the port (``repro_torch.serving``:
``UplinkAggregator``, ``UplinkMessage``, ``MSG_KINDS``), on the CPU: the
three aggregator cases of ``tests/test_serving.py`` and its message
validation, each holding the port's state against the JAX package's
aggregator fed the same frames."""

import json

import pytest

from repro.serving import UplinkAggregator as JaxAggregator
from repro.serving import UplinkMessage as JaxMessage
from repro_torch.serving import MSG_KINDS, UplinkAggregator, UplinkMessage


def _both(tmp_path, frames):
    """Feed ``frames`` to both packages' aggregators; the verdicts of each
    ``ingest`` and the aggregators."""
    out = {}
    for name, agg_cls, msg_cls in (("jax", JaxAggregator, JaxMessage),
                                   ("port", UplinkAggregator,
                                    UplinkMessage)):
        agg = agg_cls(tmp_path / name)
        verdicts = [agg.ingest(msg_cls(*f[:4], **f[4])) for f in frames]
        out[name] = (verdicts, agg)
    return out


def _state_files(agg):
    return {p.name: json.loads(p.read_text())
            for p in sorted(agg.state_dir.glob("*.json"))}


def test_uplink_aggregator_dedup_and_state(tmp_path):
    frames = [("dev0", 1, "class", (3,), dict(conf=0.95)),
              ("dev0", 1, "class", (7,), {}),
              ("dev0", 2, "class", (5,), {}),
              ("dev0", 1, "class", (9,), {})]
    res = _both(tmp_path, frames)
    verdicts, agg = res["port"]
    assert verdicts == [True, False, True, False]
    assert agg.last_class("dev0") == 5
    assert (agg.n_accepted, agg.n_duplicates) == (2, 2)
    jv, jagg = res["jax"]
    assert verdicts == jv
    assert _state_files(agg) == _state_files(jagg)


def test_uplink_aggregator_topk_argmax(tmp_path):
    res = _both(tmp_path, [("dev1", 1, "topk", (0.1, 2.5, -0.3),
                            dict(conf=0.6))])
    agg = res["port"][1]
    assert agg.last_class("dev1") == 1
    assert _state_files(agg) == _state_files(res["jax"][1])


def test_uplink_aggregator_recovery(tmp_path):
    frames = [("dev0", 4, "class", (2,), {}),
              ("dev1", 1, "topk", (0.0, 1.0), {})]
    res = _both(tmp_path, frames)
    # host restarts: a fresh aggregator over the same state dir recovers
    # the committed cursors, and replayed frames dedup against them
    agg2 = UplinkAggregator(tmp_path / "port")
    assert agg2.snapshot() == {"dev0": 2, "dev1": 1}
    assert agg2.snapshot() == JaxAggregator(tmp_path / "jax").snapshot()
    assert not agg2.ingest(UplinkMessage("dev0", 4, "class", (9,)))
    assert agg2.ingest(UplinkMessage("dev0", 5, "class", (9,)))
    assert agg2.last_seq("dev0") == 5
    assert res["port"][0] == res["jax"][0] == [True, True]


def test_uplink_message_validation():
    assert MSG_KINDS == ("class", "topk")
    with pytest.raises(ValueError, match="kind"):
        UplinkMessage("d", 1, "raw", (1,))
    with pytest.raises(ValueError, match="payload"):
        UplinkMessage("d", 1, "class")

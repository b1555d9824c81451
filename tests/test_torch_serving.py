"""The port's serving package (``repro_torch.serving``) on the CPU.

The host end of the uplink (``UplinkAggregator``, ``UplinkMessage``,
``MSG_KINDS``): the three aggregator cases of ``tests/test_serving.py``
and its message validation, each holding the port's state against the JAX
package's aggregator fed the same frames.

The preemption-safe engine (``ServeEngine``, ``Request``) and its KV pages
(``PagedKVStore``): the engine's greedy tokens equal the JAX engine's on
the same weights in f32 (qwen3-0.6b and mamba2-370m at the small widths of
``tests/test_serving.py``), a second run and a preempted run that resumes
give the same tokens bit for bit, the two ``ValueError`` refusals and the
resubmitted budget behave as the JAX tests pin them, and the KV store's
files equal the JAX store's byte for byte after the same appends and a
torn append rolled back.  ``launch.serve.main`` serves on the CPU."""

import dataclasses
import json

import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_config
from repro.models import get_model as jax_model
from repro.serving import PagedKVStore as JaxKVStore
from repro.serving import Request as JaxRequest
from repro.serving import ServeEngine as JaxEngine
from repro.serving import UplinkAggregator as JaxAggregator
from repro.serving import UplinkMessage as JaxMessage
from repro_torch.convert import lm_params_from_numpy, model_config_from_fields
from repro_torch.launch import serve
from repro_torch.serving import (MSG_KINDS, PagedKVStore, Request,
                                 ServeEngine, UplinkAggregator, UplinkMessage)


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


# --------------------------------------------------------------------------
# The decode engine and its KV pages
# --------------------------------------------------------------------------

#: The JAX serving tests' model (``tests/test_serving.py``), and mamba2 and
#: qwen3-moe (4 experts, top-2; a decode batch of 3 is one group of 3
#: tokens, one slot an expert) at widths of the same scale.
SMALL = {
    "qwen3": ("qwen3-0.6b", dict(num_layers=2, d_model=32, vocab_size=97,
                                 d_ff=64)),
    "mamba2": ("mamba2-370m", dict(num_layers=2, d_model=32, vocab_size=97)),
    "qwen3-moe": ("qwen3-moe-30b-a3b", dict(num_layers=2, d_model=32,
                                            vocab_size=97, d_ff=64,
                                            moe_d_ff=64)),
}


@pytest.fixture(scope="module", params=sorted(SMALL))
def model(request):
    """(JAX config, JAX params, port config, port params) in f32."""
    arch, overrides = SMALL[request.param]
    jcfg = jax_config(arch).scaled_down(**overrides)
    params = jax_model(jcfg).init_params(jcfg, jax.random.key(0))
    cfg = model_config_from_fields(dataclasses.asdict(jcfg))
    tparams = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, params),
                                   device="cpu")
    return jcfg, params, cfg, tparams


def _requests(cls, vocab, n=3, plen=6, max_new=8):
    rng = np.random.default_rng(0)
    return [cls(f"r{i}", rng.integers(0, vocab, size=plen).tolist(), max_new)
            for i in range(n)]


def test_engine_tokens_match_jax(model, tmp_path):
    jcfg, params, cfg, tparams = model
    want = JaxEngine(jcfg, params, tmp_path / "jax", max_len=32).run(
        _requests(JaxRequest, cfg.vocab_size))
    got = ServeEngine(cfg, tparams, tmp_path / "port", max_len=32).run(
        _requests(Request, cfg.vocab_size))
    assert got == want
    assert all(len(v) == 8 for v in got.values())
    for rid in got:       # the durable cursors hold the same record
        assert json.loads((tmp_path / "port" / f"{rid}.json").read_text()) \
            == json.loads((tmp_path / "jax" / f"{rid}.json").read_text())


def test_engine_deterministic_and_preemption_recovery_exact(model, tmp_path):
    """A second run gives the same tokens; a run preempted after 3 tokens
    and resumed by a fresh engine over the same state gives them too."""
    _, _, cfg, tparams = model
    ref = ServeEngine(cfg, tparams, tmp_path / "ref", max_len=32).run(
        _requests(Request, cfg.vocab_size))
    again = ServeEngine(cfg, tparams, tmp_path / "again", max_len=32).run(
        _requests(Request, cfg.vocab_size))
    assert again == ref
    eng = ServeEngine(cfg, tparams, tmp_path / "pre", max_len=32)
    with pytest.raises(RuntimeError, match="preempted"):
        eng.run(_requests(Request, cfg.vocab_size), fail_after_tokens=3)
    assert all(len(eng.recover(f"r{i}").generated) == 3 for i in range(3))
    out = ServeEngine(cfg, tparams, tmp_path / "pre", max_len=32).run(
        _requests(Request, cfg.vocab_size))
    assert out == ref


def test_engine_refuses_unequal_prompts_and_kv_overrun(model, tmp_path):
    _, _, cfg, tparams = model
    eng = ServeEngine(cfg, tparams, tmp_path / "s", max_len=32)
    reqs = _requests(Request, cfg.vocab_size)
    reqs[1] = Request("r1", reqs[1].prompt + [3, 5], reqs[1].max_new)
    with pytest.raises(ValueError, match="equal length"):
        eng.run(reqs)
    eng = ServeEngine(cfg, tparams, tmp_path / "over", max_len=32)
    with pytest.raises(ValueError, match="overrun"):
        eng.run(_requests(Request, cfg.vocab_size, plen=6, max_new=27))
    eng = ServeEngine(cfg, tparams, tmp_path / "edge", max_len=32)
    out = eng.run(_requests(Request, cfg.vocab_size, plen=6, max_new=26))
    assert all(len(v) == 26 for v in out.values())   # 6 + 26 == max_len


def test_engine_resubmit_updates_max_new(model, tmp_path):
    _, _, cfg, tparams = model
    eng = ServeEngine(cfg, tparams, tmp_path / "s", max_len=32)
    short = eng.run(_requests(Request, cfg.vocab_size, max_new=4))
    out = eng.run(_requests(Request, cfg.vocab_size, max_new=8))
    assert all(len(v) == 8 for v in out.values())
    for rid, toks in short.items():
        assert out[rid][:4] == toks
    assert eng.recover("r0").max_new == 8


def _store_files(root):
    return {p.name: p.read_bytes() for p in sorted(root.iterdir())
            if not p.name.endswith(".npz")}


def test_kv_store_files_match_jax_after_a_torn_append(tmp_path):
    """Four appends, then a fifth torn mid-row (its undo row saved and the
    read cursor bumped, half the row written) and rolled back by
    ``recover``: the array and cursor files equal the JAX store's byte for
    byte, and so does the undo log's content."""
    rng = np.random.default_rng(0)
    rows = [rng.normal(size=(2 * 8,)).astype(np.float32) for _ in range(5)]
    stores = {}
    for name, cls in (("jax", JaxKVStore), ("port", PagedKVStore)):
        store = cls(tmp_path / name, layers=2, max_len=16, kv_width=8)
        for pos, r in enumerate(rows[:4]):
            store.append("seq0", pos, r)
        f = store._file("seq0")
        with open(f.undo_path, "wb") as fh:
            np.savez(fh, rows=np.asarray([4]), values=f.read()[[4]])
        cur = json.loads(f.cursor_path.read_text())
        f._set_cursors(cur["read"] + 1, cur["write"])
        mm = np.load(f.path, mmap_mode="r+")
        mm[4, :8] = rows[4][:8]
        mm.flush()
        del mm
        assert store.recover("seq0") == 4
        stores[name] = store
    j, p = stores["jax"], stores["port"]
    assert _store_files(p.root) == _store_files(j.root)
    data = p.read("seq0")
    np.testing.assert_array_equal(data[2], rows[2])
    assert not data[4:].any()
    uj, up = (np.load(s._file("seq0").undo_path) for s in (j, p))
    np.testing.assert_array_equal(up["rows"], uj["rows"])
    np.testing.assert_array_equal(up["values"], uj["values"])
    p.append("seq0", 4, rows[4])
    j.append("seq0", 4, rows[4])
    assert p.recover("seq0") == 5
    assert _store_files(p.root) == _store_files(j.root)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mamba2-370m",
                                  "qwen3-moe-30b-a3b", "internvl2-26b"])
def test_serve_launcher_on_cpu(arch, tmp_path, capsys):
    out = serve.main(["--device", "cpu", "--smoke", "--arch", arch,
                      "--requests", "2", "--prompt-len", "5", "--max-new",
                      "3", "--state-dir", str(tmp_path)])
    assert sorted(out) == ["r0", "r1"]
    assert all(len(v) == 3 for v in out.values())
    lines = capsys.readouterr().out.splitlines()
    assert lines == [f"{rid}: {toks}" for rid, toks in out.items()]

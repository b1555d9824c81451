"""The language-model path of the harness on the CPU, on a tiny model of
the cell's family: the dispatch by the configuration's kind, the checks on
the program and on its faults, the control, the weights, the flops count,
and a configuration of another family added as new files only."""

import json
import shutil
from types import SimpleNamespace

import pytest
import torch

from perfbench_support import (LM_CELLS, PERFBENCH, ROOT, core, cpu_run,
                               result, runner, spec, tiny_config,
                               tiny_lm_cell, tiny_port, tiny_traffic)
from lmbench import check, control, peaks, program
from lmbench import runner as lm_runner

from repro_torch import configs
from repro_torch.models import api, counting, transformer
from repro_torch.serving import engine


def bench_cell(workload=LM_CELLS[0], trace=False):
    return spec.find_cell(spec.load_benchmark(), workload, trace)


def test_dispatch_by_kind():
    lm = bench_cell()
    assert lm.config["kind"] == "lm"
    assert core.run_class(lm) is lm_runner.Run
    fleet = spec.find_cell(spec.load_benchmark(), "har.design-space", False)
    assert "kind" not in fleet.config
    assert core.run_class(fleet) is runner.Run
    fleet.config = dict(fleet.config, kind="graph")
    with pytest.raises(SystemExit, match="unknown kind"):
        core.run_class(fleet)


def test_the_file_matches_the_port_and_its_reference():
    cell = bench_cell()
    cfg = cell.config
    port = program.port_config(configs, cfg)
    ref = program.reference(cfg["family"], lm_runner.LMREF)
    program.check_shapes(ref, cfg, api.param_shapes(port))
    assert set(cfg["reduced"]) == set(cfg["published"])
    for k in cfg["reduced"]:
        assert cfg[k] != cfg["published"][k]
    bad = dict(cfg, hidden_size=cfg["hidden_size"] + 8)
    with pytest.raises(SystemExit, match="hidden_size"):
        program.port_config(configs, bad)
    with pytest.raises(SystemExit, match="parameters differ"):
        program.check_shapes(ref, bad, api.param_shapes(port))


def test_flops_count_is_the_ports_convention():
    """2 N a fed position, N counted from the reference's shapes, as
    ``counting.model_flops`` counts it; the attention term by hand."""
    cell = bench_cell()
    cfg, traffic = cell.config, cell.traffic
    port = configs.get_config(cfg["port_config"])
    ref = program.reference(cfg["family"], lm_runner.LMREF)
    t = peaks.fed_positions(traffic, 256)
    assert t == traffic["prompt_len"] + 256 - 1 == 325
    assert 2 * peaks.model_params(ref, cfg) * t == \
        counting.model_flops(port, t, "decode")
    assert peaks.model_params(ref, cfg) == counting.param_count(port)
    attn = 4 * 28 * 16 * 128 * (325 * 326 // 2)
    assert peaks.request_flops(ref, cfg, traffic, 256) == \
        counting.model_flops(port, t, "decode") + attn
    lengths = program.answer_lengths(traffic)
    assert peaks.call_flops(ref, cfg, traffic) == sum(
        counting.model_flops(port, 69 + a, "decode")
        + 4 * 28 * 16 * 128 * ((69 + a) * (70 + a) // 2) for a in lengths)
    assert peaks.PEAK_BF16_FLOPS == 989e12


@pytest.mark.parametrize("seed", [3, 2**31 + 5, 2**62 + 9])
def test_weights_from_the_seed(monkeypatch, seed):
    cell = tiny_lm_cell(monkeypatch)
    cfg = cell.config
    ref = program.reference(cfg["family"], lm_runner.LMREF)
    a = program.make_weights(torch, ref, cfg, seed, "cpu", torch.bfloat16)
    b = program.make_weights(torch, ref, cfg, seed, "cpu", torch.bfloat16)
    c = program.make_weights(torch, ref, cfg, seed + 1, "cpu",
                             torch.bfloat16)
    fa, fb, fc = (transformer_leaves(w) for w in (a, b, c))
    assert {k: tuple(v.shape) for k, v in fa.items()} == \
        api.param_shapes(configs.get_config(cfg["port_config"]))
    for k in fa:
        assert fa[k].dtype == torch.bfloat16 and torch.equal(fa[k], fb[k])
        assert not torch.equal(fa[k], fc[k]), k
    assert abs(float(fa["layers.ln1"].float().mean()) - 1.0) < 0.1
    assert abs(float(fa["layers.attn.wq"].float().std()) - 0.02) < 0.005


def transformer_leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out |= transformer_leaves(v, f"{prefix}{k}.")
        else:
            out[prefix + k] = v
    return out


def test_reference_is_the_ports_forward(monkeypatch):
    """The reference's logits against the port's full-sequence forward in
    float32, on the same tiny weights."""
    tiny_port(monkeypatch, param_dtype="float32", compute_dtype="float32")
    cell = bench_cell()
    port = configs.get_config(cell.config["port_config"])
    cfg = tiny_config(cell.config, port)
    ref = program.reference(cfg["family"], lm_runner.LMREF)
    w = program.make_weights(torch, ref, cfg, 11, "cpu", torch.float32)
    toks = torch.randint(0, cfg["vocab_size"], (3, 12),
                         generator=torch.Generator().manual_seed(1))
    want = check.reference_logits(torch, ref, cfg, w, toks, block=100)
    got = transformer.forward(port, w, toks)[..., :cfg["vocab_size"]]
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-5)


def test_a_run_on_the_cpu_is_correct(monkeypatch):
    rc, lines, err = cpu_run(tiny_lm_cell(monkeypatch))
    assert rc == 0, err
    res = result(lines)
    assert res["correct"] and res["failed"] == 0
    assert res["attempted"] % 12 == 0 and res["attempted"] >= 12
    names = [c for c in res["checks"]]
    assert names == ["logits", "served_gap", "count"]
    assert res["checks"]["count"]["value"] == 0
    assert set(res["metrics"]) == {"tokens_per_s", "setup_s"}
    assert err.strip().splitlines()[-1] == "check count 0 limit 0"


@pytest.mark.parametrize("trace", [0, 1])
def test_last_line(monkeypatch, trace):
    rc, lines, err = cpu_run(tiny_lm_cell(monkeypatch, trace=bool(trace)),
                             trace=trace)
    assert rc == 0, err
    res = result(lines)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks"
    names = set(res["metrics"])
    if trace:
        # no device trace on the CPU: the host's metrics only
        assert names == {"lm.decode_ms_per_step", "lm.commit_ms_per_step"}
    else:
        assert names == {"tokens_per_s", "setup_s"}
    for m in res["metrics"].values():
        assert m["value"] > 0
    for line in lines[:-1]:
        json.loads(line)


def test_every_call_serves_the_mixs_lengths(monkeypatch):
    """A call runs its prompt and its longest answer's steps, and the
    window counts every request's own answer once."""
    cell = tiny_lm_cell(monkeypatch)
    rc, lines, err = cpu_run(cell)
    assert rc == 0, err
    info = json.loads(lines[0])
    tr = cell.traffic
    lengths = program.answer_lengths(tr)
    assert lengths == sorted(lengths) and len(set(lengths)) > 1
    assert info["steps"] == info["calls"] * (tr["prompt_len"] + max(lengths))
    assert info["tokens"] == info["calls"] * sum(lengths)
    tps = result(lines)["metrics"]["tokens_per_s"]["value"]
    assert tps <= info["tokens"] / sum(info["call_s"]) * 1.0001


def test_preemption_resumes_and_counts_once(monkeypatch):
    """In a mix that preempts its calls, each call's engines run the
    re-prefill's steps as well, the window counts each served token once,
    and the check compares the resumed tokens."""
    cell = tiny_lm_cell(monkeypatch, preempt=True)
    rc, lines, err = cpu_run(cell)
    assert rc == 0, err
    info = json.loads(lines[0])
    tr = cell.traffic
    fail, plen, n = tr["fail_after_tokens"], tr["prompt_len"], tr["answers"]
    steps = (plen + fail - 1) + (plen + fail + n - fail)
    assert info["steps"] == info["calls"] * steps
    assert info["tokens"] == info["calls"] * tr["requests"] * n
    res = result(lines)
    assert res["correct"]
    assert list(res["checks"]) == ["logits", "served_gap", "resume", "count"]
    assert res["checks"]["resume"]["value"] == 0


def cache_unchanged(monkeypatch):
    """A decode step returns the cache as it found it."""
    real = transformer.decode_step

    def step(cfg, params, cache, tok, pos):
        logits, _ = real(cfg, params, {k: v.clone() for k, v in
                                       cache.items()}, tok, pos)
        return logits, cache
    monkeypatch.setattr(transformer, "decode_step", step)


def half_the_batch(monkeypatch):
    """A decode step computes the first half of the batch and hands its
    rows to the other half."""
    real = transformer.decode_step

    def step(cfg, params, cache, tok, pos):
        h = tok.shape[0] // 2
        logits, cache = real(cfg, params, cache, tok, pos)
        return torch.cat([logits[:h], logits[:h]]), cache
    monkeypatch.setattr(transformer, "decode_step", step)


def token_altered(monkeypatch):
    """The served token is altered where it is committed: every commit of
    generated tokens writes its last one with the lowest bit flipped."""
    from repro_torch.checkpoint import store
    real = store.Cursor.commit

    def commit(self, **fields):
        g = fields.get("generated")
        if g:
            fields["generated"] = g[:-1] + [g[-1] ^ 1]
        return real(self, **fields)
    monkeypatch.setattr(store.Cursor, "commit", commit)


def answer_altered(monkeypatch):
    """The engine hands back its answers with one token of the first
    longest request altered (the lowest bit flipped): a request that every
    run checks, so the fault is caught however many calls the window
    holds (the sample drawn over the calls moves with their count)."""
    real = engine.ServeEngine.run

    def run(self, requests, **kw):
        out = real(self, requests, **kw)
        g = max((out[r.rid] for r in requests), key=len)
        g[len(g) // 2] ^= 1
        return out
    monkeypatch.setattr(engine.ServeEngine, "run", run)


def resume_misplaced(monkeypatch):
    """A recovered request drops its first committed token, so the resumed
    engine feeds its tokens one position early."""
    real = engine.ServeEngine.recover

    def recover(self, rid):
        r = real(self, rid)
        r.generated = r.generated[1:]
        return r
    monkeypatch.setattr(engine.ServeEngine, "recover", recover)


def requests_dropped(monkeypatch):
    """The engine serves half of the batch and drops the rest."""
    real = engine.ServeEngine.run

    def run(self, requests, **kw):
        return real(self, requests[:len(requests) // 2], **kw)
    monkeypatch.setattr(engine.ServeEngine, "run", run)


@pytest.mark.parametrize("fault", [cache_unchanged, half_the_batch,
                                   token_altered, answer_altered,
                                   resume_misplaced, requests_dropped],
                         ids=lambda f: f.__name__)
def test_a_broken_path_is_not_correct(monkeypatch, fault):
    """Each fault in the cell's own mix; a cursor's token altered and a
    resume misplaced in a mix that preempts, whose resumed engine reads
    the cursors back."""
    cell = tiny_lm_cell(monkeypatch, preempt=fault in (token_altered,
                                                       resume_misplaced))
    fault(monkeypatch)
    rc, lines, err = cpu_run(cell)
    assert rc == 0, err
    res = result(lines)
    assert res["correct"] is False
    assert res["failed"] >= 1
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


@pytest.mark.parametrize("seed", [5, 2**31 + 17, 2**40 + 1])
def test_control_fails_the_logits_check(monkeypatch, tmp_path, seed):
    """The reference with every layer's output in float8, in the
    program's place, at the cell's depth on a tiny width: it fails the
    cell's own limit; the program passes it."""
    cell = tiny_lm_cell(monkeypatch, num_layers=28)
    r = control.reading(cell, seed, device="cpu", state=tmp_path)
    lim = cell.traffic["limits"]
    assert r["control"]["logits"] > lim["logits"]
    assert r["control_fails"] and r["program_passes"]
    assert r["program"]["logits"] <= lim["logits"]


def test_a_new_family_is_new_files_only(monkeypatch, tmp_path):
    """A configuration of a family the harness has never seen, with its
    reference and its mix in a directory of their own: the harness runs
    it as it stands, and holds it against its reference."""
    shutil.copy(PERFBENCH / "lmref" / "dense.py", tmp_path / "biasdense.py")
    cfg = json.loads((PERFBENCH / "configs" / "qwen3-0.6b.json")
                     .read_text())
    cfg.update(name="qwen1.5-0.5b", family="biasdense",
               port_config="qwen1.5-0.5b", attention_bias=True,
               qk_norm=False, rope_theta=10000.0, reduced=[])
    mix = json.loads((PERFBENCH / "traffic" / "chat.json").read_text())
    mix.update(requests=4)
    (tmp_path / "qwen1.5-0.5b.json").write_text(json.dumps(cfg))
    (tmp_path / "short.json").write_text(json.dumps(mix))
    port = tiny_port(monkeypatch)("qwen1.5-0.5b")
    assert port.family == "dense" and port.qkv_bias
    cell = spec.Cell(
        name="qwen1.5-0.5b.short", chips=1,
        config=tiny_config(json.loads((tmp_path / "qwen1.5-0.5b.json")
                                      .read_text()), port),
        traffic=tiny_traffic(json.loads((tmp_path / "short.json")
                                        .read_text())),
        metrics=[m for m in spec.load_benchmark()["end_to_end"]
                 if m["name"] in ("tokens_per_s", "setup_s")])
    rc, lines, err = cpu_run(cell, lmref=tmp_path)
    assert rc == 0, err
    res = result(lines)
    assert res["correct"] and res["attempted"] % 4 == 0
    assert set(res["metrics"]) == {"tokens_per_s", "setup_s"}
    # the same files, the reference's layer without the bias: not correct
    text = (tmp_path / "biasdense.py").read_text()
    old = '    if cfg.get("attention_bias"):\n        q, k, v'
    assert text.count(old) == 1
    (tmp_path / "biasdense.py").write_text(text.replace(
        old, '    if cfg.get("no_such_key"):\n        q, k, v'))
    rc, lines, err = cpu_run(cell, lmref=tmp_path)
    assert rc == 0, err
    assert result(lines)["correct"] is False


def test_sample_holds_the_last_call_first():
    rows = [1, 4, 6]
    picks = check.sample_requests(2**33 + 1, rows, 5, 8, 8)
    assert picks[:3] == [(4, j) for j in rows]
    assert len(set(picks)) == 11 and all(c < 4 for c, _ in picks[3:])
    assert picks == check.sample_requests(2**33 + 1, rows, 5, 8, 8)
    assert check.sample_requests(7, rows, 1, 8, 8) == [(0, j) for j in rows]


def test_the_mix_and_its_warm_up():
    tr = bench_cell().traffic
    assert (tr["requests"], tr["prompt_len"], tr["max_len"]) == \
        (64, 70, 326)
    assert "fail_after_tokens" not in tr
    lengths = program.answer_lengths(tr)
    assert len(lengths) == 64 and lengths == sorted(lengths)
    assert (min(lengths), max(lengths), sum(lengths)) == (2, 256, 9567)
    assert tr["prompt_len"] + max(lengths) == tr["max_len"]
    warm = program.warm_traffic(tr)
    assert warm["requests"] == 64 and warm["max_len"] == 326
    assert program.answer_lengths(warm) == [4] * 64
    assert "fail_after_tokens" not in warm
    seed = 2**31 + 3
    a, la = program.call_requests(tr, 151936, seed, 0)
    assert a.shape == (64, 70) and a.min() >= 0 and a.max() < 151936
    b, lb = program.call_requests(tr, 151936, seed, 0)
    assert (a == b).all() and la == lb and sorted(la) == lengths
    c, lc = program.call_requests(tr, 151936, seed, 1)
    assert not (a == c).all() and lc != la and sorted(lc) == lengths
    rows = program.logit_rows(la, seed, 0, 8)
    assert len(set(rows)) == 8 and rows == sorted(rows)
    assert max(la[j] for j in rows) == 256
    assert rows == program.logit_rows(la, seed, 0, 8)


def test_lm_readers_by_hand():
    run = SimpleNamespace(
        calls=[dict(t0=1.0, t1=3.0, tokens=90), dict(t0=3.0, t1=5.0,
                                                      tokens=90)],
        steps=400, traced_steps=200, call_flops=2e12, peaks=peaks,
        trace=dict(busy_s=0.5, window_s=4.0, kernels={}),
        host={"decode": 3.2, "commit": 0.4}, setup_s=9.0)
    val = {m: spec.reader(m)(run) for m in (
        "tokens_per_s", "device_idle.serve", "serve_mfu",
        "lm.decode_ms_per_step", "lm.commit_ms_per_step")}
    assert val["tokens_per_s"] == pytest.approx(180 / 4.0)
    # the card busy 2.5 ms a step, a step 10 ms of the window
    assert val["device_idle.serve"] == pytest.approx(75.0)
    assert val["serve_mfu"] == pytest.approx(100 * 4e12 / 4.0 / 989e12)
    assert val["lm.decode_ms_per_step"] == pytest.approx(8.0)
    assert val["lm.commit_ms_per_step"] == pytest.approx(1.0)
    run.trace = None
    assert spec.reader("device_idle.serve")(run) is None
    assert spec.reader("serve_mfu")(run) is None


def test_state_stays_in_the_checkout():
    run = lm_runner.Run(bench_cell(), None, 0.0, device="cpu")
    assert run.state == ROOT / "build" / "lm_state" / LM_CELLS[0]


def test_a_run_that_loads_jax_prints_no_result(monkeypatch):
    """A forbidden module that appears while the model serves: exit 4, no
    result line."""
    import sys
    from types import ModuleType

    loaded = core.forbidden_modules()
    name = next((n for n in ("flax", "jaxlib", "jax", "repro")
                 if n not in loaded), None)
    if name is None:
        pytest.skip("every forbidden name is loaded in this worker")
    cell = tiny_lm_cell(monkeypatch)
    real = transformer.decode_step

    def step(*a, **k):
        sys.modules.setdefault(name, ModuleType(name))
        return real(*a, **k)

    monkeypatch.setattr(transformer, "decode_step", step)
    monkeypatch.delitem(sys.modules, name, raising=False)
    rc, lines, err = cpu_run(cell)
    monkeypatch.delitem(sys.modules, name, raising=False)
    assert rc == 4 and f"loaded ['{name}']" in err
    assert not any('"correct"' in line for line in lines)

"""The system under test: a language model of ``repro_torch`` served by its
preemptible ``ServeEngine``, driven by one traffic mix.

The configuration file names the port's configuration (``port_config``,
found through ``repro_torch.configs.get_config``) and maps its published
keys onto the port's fields (``port_fields``), which are checked equal
before a run.  The weights are the benchmark's: drawn on the device from
the run's seed, in the served dtype, in the shapes the family's reference
names (``lmref/<family>.py``), which are checked equal to the program's.

A mix (``perfbench/traffic/<name>.json``) gives a call's batch
(``requests`` prompts of ``prompt_len`` ids drawn uniformly from the
published vocabulary, by the call's seed), each request's greedy answer
length (``answers``: one length for all, or ``{"mean", "cap"}``, the
``requests`` quantiles of an exponential of that mean, each capped, in an
order the call's seed draws, so every call serves the same tokens), the
engine's ``max_len`` and, where the mix preempts its calls,
``fail_after_tokens``: the engine stops after committing that many tokens,
and a fresh engine on the same parameters and state directory resumes the
requests from their durable cursors.
"""

from __future__ import annotations

import importlib.util
import math
import shutil
from contextlib import contextmanager
from pathlib import Path

import numpy as np

#: Tags of the seeds drawn from a run's ``--seed``.
WEIGHTS, CALL, SAMPLE = 1, 2, 3


def derive(seed: int, *keys: int) -> np.random.SeedSequence:
    return np.random.SeedSequence([seed % 2**64, *keys])


def reference(family: str, where: Path):
    """The family's plain reference, ``<where>/<family>.py``."""
    path = Path(where) / f"{family}.py"
    if not path.is_file():
        raise SystemExit(f"perfbench: no reference for the {family!r} "
                         f"family ({path})")
    spec = importlib.util.spec_from_file_location(
        f"perfbench_lmref_{family}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def port_config(configs, cfg: dict):
    """The port's configuration the file names, after checking every key
    of ``port_fields`` (a published key, or a list of them, and the
    port's field or fields) equal on both sides."""
    port = configs.get_config(cfg["port_config"])
    bad = []
    for key, fields in cfg["port_fields"].items():
        for f in [fields] if isinstance(fields, str) else fields:
            if getattr(port, f) != cfg[key]:
                bad.append(f"{key}={cfg[key]!r} but {f}="
                           f"{getattr(port, f)!r}")
    if bad:
        raise SystemExit(f"perfbench: {cfg['name']}'s file and the port's "
                         f"{cfg['port_config']!r} differ: {'; '.join(bad)}")
    return port


def check_shapes(ref, cfg: dict, program_shapes: dict) -> None:
    want = {k: tuple(v) for k, v in ref.param_shapes(cfg).items()}
    got = {k: tuple(v) for k, v in program_shapes.items()}
    if want != got:
        diff = sorted(set(want.items()) ^ set(got.items()))
        raise SystemExit(f"perfbench: the reference's and the program's "
                         f"parameters differ: {diff[:6]}")


def _nest(flat: dict) -> dict:
    out: dict = {}
    for k, v in flat.items():
        *path, leaf = k.split(".")
        d = out
        for p in path:
            d = d.setdefault(p, {})
        d[leaf] = v
    return out


def make_weights(torch, ref, cfg: dict, seed: int, device, dtype) -> dict:
    """Every leaf of the reference's shapes, drawn from ``seed`` on
    ``device`` in ``dtype``: one normal draw for all of them, then each
    leaf's slice scaled and shifted to its ``param_init`` (views, no
    copy)."""
    shapes = ref.param_shapes(cfg)
    names = sorted(shapes)
    sizes = [math.prod(shapes[n]) for n in names]
    s = int(derive(seed, WEIGHTS).generate_state(1, np.uint64)[0] >> 1)
    gen = torch.Generator(device=device).manual_seed(s)
    flat = torch.empty(sum(sizes), dtype=dtype, device=device)
    flat.normal_(generator=gen)
    leaves, lo = {}, 0
    for n, size in zip(names, sizes):
        mean, std = ref.param_init(n)
        leaf = flat[lo:lo + size].view(shapes[n])
        leaf.mul_(std).add_(mean)
        leaves[n] = leaf
        lo += size
    return _nest(leaves)


def answer_lengths(traffic: dict) -> list[int]:
    """The mix's answer lengths, shortest first: every request the same, or
    the ``requests`` midpoint quantiles ``(i + 1/2) / n`` of an exponential
    of ``mean`` tokens, rounded, at least 1 and at most ``cap``."""
    n, a = traffic["requests"], traffic["answers"]
    if isinstance(a, int):
        return [a] * n
    return [min(a["cap"], max(1, round(-a["mean"]
                                       * math.log(1 - (i + 0.5) / n))))
            for i in range(n)]


def call_requests(traffic: dict, vocab: int, seed: int, i: int):
    """Call ``i``'s batch (``-1``: the warm-up): ``(prompts (requests,
    prompt_len) ids uniform over the published vocabulary, each request's
    answer length)``, the lengths the mix's in an order the seed draws."""
    rng = np.random.default_rng(derive(seed, CALL, i + 1))
    ids = rng.integers(0, vocab, (traffic["requests"],
                                  traffic["prompt_len"]))
    return ids, [int(n) for n in rng.permutation(answer_lengths(traffic))]


def logit_rows(answers: list, seed: int, i: int, n: int) -> list[int]:
    """The requests of call ``i`` whose every step's logits the check
    compares: the first of the longest, then ``n - 1`` more drawn from the
    seed, in order."""
    top = answers.index(max(answers))
    rest = [j for j in range(len(answers)) if j != top]
    rng = np.random.default_rng(derive(seed, SAMPLE, i + 1))
    pick = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False)
    return sorted([top] + [rest[int(k)] for k in pick])


class Capture:
    """Stands in for ``ServeEngine._decode`` while the program runs: keeps
    each step's position, fed tokens and logits of the current call's
    ``rows`` (a gather of those rows; all rows where ``rows`` is None), and
    counts every step."""

    def __init__(self, fn):
        self.fn = fn
        self.steps = 0
        self.on = True
        self.rows = None
        self.call: list[dict] = []

    def new_call(self, keep: bool = True, rows=None) -> None:
        self.call = []
        self.on = keep
        self.rows = rows

    def kept(self, logits):
        """``logits``' rows the check compares; None where the step ran
        fewer rows than the call has requests (the check then fails)."""
        if self.rows is None:
            return logits
        if max(self.rows) >= logits.shape[0]:
            return None
        return logits[self.rows]

    def method(self):
        """The function that takes ``_decode``'s place on the class."""
        def decode(engine, params, cache, tok, pos):
            logits, cache = self.fn(engine, params, cache, tok, pos)
            self.steps += 1
            if self.on:
                self.call.append(dict(pos=int(pos), tok=tok,
                                      logits=self.kept(logits)))
            return logits, cache
        return decode


@contextmanager
def captured(engine_cls):
    """A :class:`Capture` in ``engine_cls._decode``'s place for the block."""
    capture = Capture(engine_cls._decode)
    engine_cls._decode = capture.method()
    try:
        yield capture
    finally:
        engine_cls._decode = capture.fn


def serve(engine_cls, request_cls, cfg, params, traffic: dict, ids,
          answers: list, state: Path, preempt: bool = True) -> dict:
    """Serve one batch, request ``j`` ``answers[j]`` tokens: ``{rid: served
    tokens}``.  With ``preempt`` and a ``fail_after_tokens`` in the mix,
    the first engine stops there and a fresh one resumes from the cursors
    in ``state``."""
    if state.exists():
        shutil.rmtree(state)
    reqs = [(f"r{j}", [int(t) for t in row], n)
            for j, (row, n) in enumerate(zip(ids, answers))]

    def run(**kw):
        eng = engine_cls(cfg, params, state, max_len=traffic["max_len"])
        return eng.run([request_cls(rid, p, n) for rid, p, n in reqs], **kw)

    fail = traffic.get("fail_after_tokens") if preempt else None
    if fail:
        try:
            run(fail_after_tokens=fail)
        except RuntimeError as e:          # the preemption the mix asks for
            if str(e) != "preempted":
                raise
    return run()


def warm_traffic(traffic: dict) -> dict:
    """The warm-up call's mix: the mix's batch, ``max_len`` and every step
    kind (prefill, decode and, where the mix preempts, a preemption and a
    resume) on short requests; a decode step's shapes do not depend on the
    position or the prompt's length, so it runs every kernel of the
    window."""
    warm = dict(traffic, prompt_len=min(4, traffic["prompt_len"]),
                answers=min(4, max(answer_lengths(traffic))))
    if traffic.get("fail_after_tokens"):
        warm["fail_after_tokens"] = min(2, warm["answers"] - 1)
    return warm
